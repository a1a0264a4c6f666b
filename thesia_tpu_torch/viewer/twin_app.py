"""Host copy of ``thesia_tpu/viewer/twin_app.py``: the executed Python twins of
the port's viewer/js/applogic.js (the port imports nothing of the JAX
package; ``tests/test_torch_hostcopies.py`` pins the code statement for
statement, ``tests/test_torch_viewer_consistency.py`` parses
``thesia_tpu_torch/viewer/js/`` against it).

The original's notes follow.

Executed Python twins of viewer/js/applogic.js (VERDICT r3 #1).

Every export of applogic.js — the app layer's pure interaction math — is
mirrored here 1:1 and golden-tested against the reference formulas
(tests/test_viewer_applogic.py); tests/test_viewer_consistency.py parses the
JS export list and asserts it equals TWINNED so a new untwinned formula
fails the suite.

reference: src/prototypes/MainViewer/MainViewer.tsx:359-595 (lens
normalize, wheel gestures, zoom-at-cursor incl. height zoom with scroll
correction), src/hooks/useSelectedTracks.ts:5-126 (selection pivot),
src/prototypes/MainViewer/{AmpAxis,FreqAxis}.tsx (editable axis ranges),
src/prototypes/Overview/Overview.tsx (lens drag/resize),
src/hooks/usePlayer.ts:44-52 (position extrapolation).

JS numeric quirks mirrored deliberately: Math.round is floor(x+0.5)
(half-toward-+inf, NOT banker's); Number.toFixed breaks decimal ties toward
+inf; `/0` yields +-Infinity without raising.
"""

from __future__ import annotations

import math
from decimal import Decimal

INF = float("inf")

# reference: constants/tracks.ts (+ player.rs, Overview.tsx)
MAX_PX_PER_SEC = 384000
FIT_TOLERANCE_SEC = 1e-6
MIN_ABS_AMP_RANGE = 1e-5
MAX_ABS_AMP_RANGE = 5
MIN_HZ_RANGE = 100
MIN_DIST_FROM_0_FOR_DRAG = 0.01
MIN_HEIGHT = 153
MAX_HEIGHT = 5000
LENS_THICKNESS = 3
PLAY_JUMP_SEC = 1.0
PLAY_BIG_JUMP_SEC = 5.0

# Slaney mel, float64 (viewer/js/freqscale.js; reference src-common/src/lib.rs:11-43)
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = 15.0
_LINEAR_MEL_STEP = 200.0 / 3.0
_LOGSTEP = math.log(6.4) / 27.0


def _js_round(x: float):
    """JS Math.round: half-toward-+infinity.  NOT floor(x + 0.5): the float
    add rounds 0.49999999999999994 up to 1.0 while the spec compares the
    mathematical fraction (tests/test_jsinterp_spec.py pins the interp side;
    this twin mirrors it so the differential stays aligned)."""
    if not math.isfinite(x):
        return x
    f = math.floor(x)
    return f + 1 if x - f >= 0.5 else f


def _js_to_fixed(x: float, digits: int) -> str:
    """ECMA-262 Number.prototype.toFixed (21.1.3.3): the sign splits off
    FIRST (step 6), then ties on the magnitude pick the larger n — so
    (-2.5).toFixed(0) is "-3" even though Math.round(-2.5) is -2, and
    negative dust keeps its sign ((-0.04).toFixed(1) is "-0.0").  Pinned
    against hand-written spec values in tests/test_jsinterp_spec.py."""
    if math.isnan(x):
        return "NaN"
    if math.isinf(x):
        return "Infinity" if x > 0 else "-Infinity"
    if abs(x) >= 1e21:
        return _js_num_str(x)
    sign = "-" if x < 0 else ""
    scaled = Decimal(abs(x)) * (10 ** digits)
    n = int((scaled + Decimal("0.5")).to_integral_value(rounding="ROUND_FLOOR"))
    s = str(n).rjust(digits + 1, "0")
    if digits:
        return f"{sign}{s[:-digits]}.{s[-digits:]}"
    return f"{sign}{s}"


def mel_from_hz(hz: float) -> float:
    if hz >= _MIN_LOG_HZ:
        return _MIN_LOG_MEL + math.log(hz / _MIN_LOG_HZ) / _LOGSTEP
    return hz / _LINEAR_MEL_STEP


def mel_to_hz(mel: float) -> float:
    if mel >= _MIN_LOG_MEL:
        return _MIN_LOG_HZ * math.exp(_LOGSTEP * (mel - _MIN_LOG_MEL))
    return mel * _LINEAR_MEL_STEP


def relative_freq_pos(hz: float, max_hz: float, freq_scale: str) -> float:
    if max_hz <= 0:
        return 0.0
    if freq_scale == "Mel":
        return mel_from_hz(hz) / mel_from_hz(max_hz)
    return hz / max_hz


def hz_from_relative_pos(pos: float, max_hz: float, freq_scale: str) -> float:
    if freq_scale == "Mel":
        return mel_to_hz(pos * mel_from_hz(max_hz))
    return pos * max_hz


# ---------------------------------------------------------------------------
# lens normalization — reference MainViewer.tsx:359-392


def normalize_start_sec(start_sec, px_per_sec, max_end_sec, width):
    """reference: MainViewer.tsx:359-361."""
    return min(max(start_sec, 0.0), max(max_end_sec - width / max(px_per_sec, 1e-8), 0.0))


def normalize_px_per_sec(px_per_sec, start_sec, max_track_sec, width):
    """reference: MainViewer.tsx:363-371 (incl. degenerate 1e-8 branch)."""
    if max_track_sec - start_sec < 1e-6:
        return min(px_per_sec, MAX_PX_PER_SEC, 1e-8)
    return min(
        max(px_per_sec, width / (max_track_sec - start_sec), 1e-8),
        max(MAX_PX_PER_SEC, width / (max_track_sec - start_sec)),
    )


def update_lens_params(cur, params, max_track_sec, width):
    """reference: MainViewer.tsx:373-392. cur/params: dicts with
    startSec/pxPerSec keys; returns {startSec, pxPerSec, isFit}."""
    new_start = params.get("startSec")
    new_start = cur["startSec"] if new_start is None else new_start
    new_pps = params.get("pxPerSec")
    new_pps = cur["pxPerSec"] if new_pps is None else new_pps
    if new_start != cur["startSec"]:
        new_start = normalize_start_sec(new_start, new_pps, max_track_sec, width)
    if new_pps != cur["pxPerSec"]:
        new_pps = normalize_px_per_sec(new_pps, new_start, max_track_sec, width)
    is_fit = (
        new_start <= FIT_TOLERANCE_SEC
        and width >= (max_track_sec - FIT_TOLERANCE_SEC) * new_pps
    )
    return {"startSec": new_start, "pxPerSec": new_pps, "isFit": is_fit}


def move_lens_start_sec(sec, anchor_ratio, px_per_sec, width):
    """reference: MainViewer.tsx:394-397."""
    return sec - (width / px_per_sec) * anchor_ratio


def time_axis_drag_anchor(cursor_x, rect_width, start_sec, px_per_sec):
    """reference: TimeAxis.tsx:43-49 calcDragAnchor."""
    cursor_ratio = cursor_x / rect_width
    return {
        "cursorRatio": cursor_ratio,
        "sec": start_sec + (cursor_ratio * rect_width) / px_per_sec,
    }


def time_axis_drag_start_sec(anchor, cursor_x, rect_width, px_per_sec):
    """reference: TimeAxis.tsx:51-63 + MainViewer.tsx:394-397."""
    cursor_ratio = cursor_x / rect_width
    sec = anchor["sec"] - (
        (cursor_ratio - anchor["cursorRatio"]) * rect_width
    ) / px_per_sec
    return move_lens_start_sec(sec, anchor["cursorRatio"], px_per_sec, rect_width)


def resize_lens_left(cur, sec, max_track_sec, width):
    """reference: MainViewer.tsx:399-407."""
    end_sec = cur["startSec"] + width / cur["pxPerSec"]
    new_start = normalize_start_sec(sec, MAX_PX_PER_SEC, end_sec, width)
    new_pps = normalize_px_per_sec(
        width / max(end_sec - new_start, 1e-8), new_start, max_track_sec, width
    )
    return update_lens_params(
        cur, {"startSec": new_start, "pxPerSec": new_pps}, max_track_sec, width
    )


def resize_lens_right(cur, sec, max_track_sec, width):
    """reference: MainViewer.tsx:409-412 (width/0 -> inf, clamped)."""
    denom = max(sec - cur["startSec"], 0.0)
    raw = width / denom if denom > 0 else INF
    new_pps = normalize_px_per_sec(raw, cur["startSec"], max_track_sec, width)
    return update_lens_params(cur, {"pxPerSec": new_pps}, max_track_sec, width)


# ---------------------------------------------------------------------------
# wheel gestures — reference MainViewer.tsx:538-576


def classify_wheel(e, is_apple):
    """reference: MainViewer.tsx:538-576. e: dict deltaX/deltaY/shiftKey/
    ctrlKey/altKey -> {kind, delta}."""
    is_apple_pinch = is_apple and e.get("ctrlKey", False)
    is_apple_zoom = is_apple and e.get("altKey", False)
    is_non_apple_zoom = (not is_apple) and e.get("ctrlKey", False)
    is_zoom = is_apple_pinch or is_apple_zoom or is_non_apple_zoom
    shift = e.get("shiftKey", False)
    if is_apple_pinch:
        horizontal = not shift
        delta = -12 * e["deltaY"] if horizontal else -6 * e["deltaY"]
    else:
        if abs(e["deltaY"]) < abs(e["deltaX"]):
            horizontal = not shift
            delta = e["deltaX"]
        else:
            horizontal = shift
            delta = e["deltaY"]
        if is_non_apple_zoom:
            delta = -delta
    if not is_zoom and not horizontal:
        return {"kind": "native", "delta": delta}
    if is_zoom:
        return {"kind": "hzoom" if horizontal else "vzoom", "delta": delta}
    return {"kind": "hscroll", "delta": delta}


def horizontal_zoom(cur, cursor_x, delta, max_track_sec, width):
    """reference: MainViewer.tsx:577-588."""
    new_pps = normalize_px_per_sec(
        cur["pxPerSec"] * (1 + delta / 1000), 0.0, max_track_sec, width
    )
    new_start = normalize_start_sec(
        cur["startSec"] + cursor_x / cur["pxPerSec"] - cursor_x / new_pps,
        new_pps, max_track_sec, width,
    )
    return update_lens_params(
        cur, {"startSec": new_start, "pxPerSec": new_pps}, max_track_sec, width
    )


def horizontal_scroll(cur, delta, max_track_sec, width):
    """reference: MainViewer.tsx:590-592."""
    return update_lens_params(
        cur, {"startSec": cur["startSec"] + (0.5 * delta) / cur["pxPerSec"]},
        max_track_sec, width,
    )


# ---------------------------------------------------------------------------
# height zoom with scroll correction — reference MainViewer.tsx:414-489


def calc_zoomed_height(base_height, delta):
    """reference: MainViewer.tsx:415-417 (JS Math.round)."""
    return _js_round(min(max(base_height + delta, MIN_HEIGHT), MAX_HEIGHT))


def calc_scroll_top_at_cursor(
    row_tops, cur_height, base_height, new_height, cursor_y, scroll_top, header_height
):
    """reference: MainViewer.tsx:441-480."""
    if not row_tops:
        return None

    def row_top_at(i, h):
        return row_tops[i] + i * (h - cur_height)

    content_y = scroll_top + cursor_y - header_height
    new_content_y = 0.0
    found = False
    for i in range(len(row_tops)):
        row_top = row_top_at(i, base_height)
        new_row_top = row_top_at(i, new_height)
        if content_y < row_top:
            new_content_y = new_row_top + (content_y - row_top)
            found = True
            break
        if content_y <= row_top + base_height:
            offset_ratio = (content_y - row_top) / max(base_height, 1e-8)
            new_content_y = new_row_top + offset_ratio * new_height
            found = True
            break
    if not found:
        last = len(row_tops) - 1
        row_bottom = row_top_at(last, base_height) + base_height
        new_row_top = row_top_at(last, new_height)
        new_content_y = new_row_top + new_height + (content_y - row_bottom)
    return header_height + new_content_y - cursor_y


def zoom_height_at_cursor(
    row_tops, cur_height, base_height, delta, cursor_y, scroll_top, header_height
):
    """reference: MainViewer.tsx:483-489."""
    new_height = calc_zoomed_height(base_height, (delta * base_height) / 1000)
    new_scroll_top = calc_scroll_top_at_cursor(
        row_tops, cur_height, base_height, new_height, cursor_y, scroll_top,
        header_height,
    )
    if new_scroll_top is None:
        return None
    return {"height": new_height, "scrollTop": new_scroll_top}


# ---------------------------------------------------------------------------
# follow-playhead / select-cursor auto-scroll — reference MainViewer.tsx:853-871


def follow_playhead_start_sec(position_sec, start_sec, end_sec):
    """reference: MainViewer.tsx:855-862."""
    if position_sec is None:
        return None
    if end_sec < position_sec or start_sec > position_sec:
        return position_sec
    return None


def select_sec_auto_scroll(select_sec, prev_select_sec, start_sec, end_sec, width, px_per_sec):
    """reference: MainViewer.tsx:864-871."""
    diff = select_sec - prev_select_sec
    if abs(diff) <= 1e-6 or (end_sec >= select_sec and start_sec <= select_sec):
        return None
    new_start = start_sec + diff
    new_end = end_sec + diff
    if new_end < select_sec or new_start > select_sec:
        new_start = select_sec - width / px_per_sec / 2
    return new_start


def player_position(anchor, now_ms):
    """reference: usePlayer.ts:44-52. anchor: {positionSec, at, isPlaying}."""
    if anchor["isPlaying"]:
        return anchor["positionSec"] + (now_ms - anchor["at"]) / 1000
    return anchor["positionSec"]


def clamp_select_sec(sec, max_sec):
    """reference: usePlayer.ts:37-39 — select cursor / seek clamp."""
    return min(max(sec, 0), max_sec)


TRACK_SWITCH_SEEK_TTL_MS = 1000


def playing_track_start_sec(pending_seek, now_ms, anchor, select_sec, max_sec):
    """reference: usePlayer.ts:92-110 — start position for a selection-driven
    track switch: pending seek within the 1 s TTL wins, else the live playing
    position, else the paused select cursor; clamped to [0, max_sec]."""
    use_pending = (
        pending_seek is not None
        and now_ms - pending_seek["atMs"] <= TRACK_SWITCH_SEEK_TTL_MS
    )
    start_sec = pending_seek["sec"] if use_pending else select_sec
    if not use_pending and anchor["isPlaying"]:
        start_sec = anchor["positionSec"] + max(0, now_ms - anchor["at"]) / 1000
    return clamp_select_sec(start_sec, max_sec)


def jump_target_sec(is_playing, position_sec, select_sec, jump_sec, max_sec):
    """reference: usePlayer.ts:141-147 — playing: seek; paused: move the
    select cursor."""
    if is_playing:
        return {
            "seekSec": clamp_select_sec(position_sec + jump_sec, max_sec),
            "selectSec": None,
        }
    return {
        "seekSec": None,
        "selectSec": clamp_select_sec(select_sec + jump_sec, max_sec),
    }


def arrow_pan_start_sec(start_sec, px_per_sec, dir_right, big):
    """reference: MainViewer.tsx:680-690 + constants/tracks.ts:14-15 —
    arrows pan the lens by 40 css px (200 with shift)."""
    shift_sec = (200 if big else 40) / px_per_sec
    return start_sec + (shift_sec if dir_right else -shift_sec)


# ---------------------------------------------------------------------------
# selection pivot semantics — reference useSelectedTracks.ts:5-126


SUPPORTED_TYPES = ["aac", "flac", "m4a", "mp3", "oga", "ogg", "opus", "wav"]


def split_supported_paths(paths):
    """reference: App.tsx:85-92 (raw case-sensitive extension check)."""
    supported, unsupported = [], []
    for path in paths:
        extension = path.split(".")[-1]  # JS split().pop(): whole string if no "."
        if extension and extension in SUPPORTED_TYPES:
            supported.append(path)
        else:
            unsupported.append(path)
    return {"supported": supported, "unsupported": unsupported}


def file_drop_index(client_y, track_tops, track_heights):
    """reference: MainViewer.tsx:175-189 calculateDropIndex."""
    drop_index = len(track_tops)
    for i in range(len(track_tops)):
        if client_y >= track_tops[i] + track_heights[i] / 2:
            continue
        drop_index = i
        break
    return drop_index


def zoom_step_delta(base, is_zoom_out):
    """reference: MainViewer.tsx:714-717,736-738."""
    delta = 2 ** (math.floor(math.log2(base)) - 1.2)
    return -delta if is_zoom_out else delta


def zoom_lens_at_select(cursor, select_sec, is_zoom_out, max_track_sec, width):
    """reference: MainViewer.tsx:735-755."""
    px_per_sec = normalize_px_per_sec(
        cursor["pxPerSec"] + zoom_step_delta(cursor["pxPerSec"], is_zoom_out),
        0, max_track_sec, width,
    )
    start_sec = normalize_start_sec(
        select_sec
        - ((select_sec - cursor["startSec"]) * cursor["pxPerSec"]) / px_per_sec,
        px_per_sec, max_track_sec, width,
    )
    return {"startSec": start_sec, "pxPerSec": px_per_sec}


def freq_zoom_scroll_top(base_height, new_height, scroll_top, split_view_height, row_count):
    """reference: MainViewer.tsx:691-721."""
    if row_count <= 0:
        return None
    content_middle = scroll_top + split_view_height / 2
    row_index = math.floor(content_middle / max(base_height, 1e-8))
    row_index = min(max(row_index, 0), row_count - 1)
    offset_in_row = content_middle - row_index * base_height
    new_offset = (offset_in_row / max(base_height, 1e-8)) * new_height
    return row_index * new_height + new_offset - split_view_height / 2


def next_track_on_arrow(display_ids, selected_ids, is_down):
    """reference: MainViewer.tsx:783-795."""
    if not display_ids:
        return None
    last = selected_ids[-1] if selected_ids else None
    recent_idx = display_ids.index(last) if last in display_ids else -1
    if is_down:
        return display_ids[min(recent_idx + 1, len(display_ids) - 1)]
    return display_ids[max(recent_idx - 1, 0)]


def select_track(selected, pivot_id, tid, track_ids, mods):
    """reference: useSelectedTracks.ts:13-63. selected: ordered list."""
    if mods.get("command"):
        if tid not in selected:
            return {"selected": selected + [tid], "pivotId": tid, "isAdded": True}
        if len(selected) == 1:
            return {"selected": selected, "pivotId": pivot_id, "isAdded": False}
        idx = selected.index(tid)
        new_selected = selected[:idx] + selected[idx + 1:]
        new_pivot = new_selected[-1] if pivot_id == tid else pivot_id
        return {"selected": new_selected, "pivotId": new_pivot, "isAdded": False}
    if mods.get("shift"):
        if selected and tid == selected[-1]:
            return {"selected": selected, "pivotId": pivot_id, "isAdded": False}
        index_of_id = track_ids.index(tid) if tid in track_ids else -1
        index_of_pivot = track_ids.index(pivot_id) if pivot_id in track_ids else -1
        pivot_pos = selected.index(pivot_id) if pivot_id in selected else -1
        new_selected = selected[: pivot_pos + 1]
        if index_of_id > index_of_pivot:
            adding = track_ids[index_of_pivot + 1 : index_of_id + 1]
        else:
            adding = list(reversed(track_ids[index_of_id:index_of_pivot]))
        new_selected = [s for s in new_selected if s not in adding] + adding
        return {
            "selected": new_selected, "pivotId": pivot_id,
            "isAdded": len(adding) > 0,
        }
    if len(selected) == 1 and selected[0] == tid:
        return {"selected": selected, "pivotId": pivot_id, "isAdded": False}
    return {"selected": [tid], "pivotId": tid, "isAdded": True}


def select_all_tracks(selected, track_ids):
    """reference: useSelectedTracks.ts:66-75 (None = no-op)."""
    if len(track_ids) == len(selected) and all(t in selected for t in track_ids):
        return None
    return {"selected": list(track_ids), "pivotId": track_ids[-1]}


def select_after_add_tracks(prev_track_ids, new_track_ids):
    """reference: useSelectedTracks.ts:77-80."""
    new_selected = [t for t in new_track_ids if t not in prev_track_ids]
    if not new_selected:
        return None
    return {"selected": new_selected, "pivotId": new_selected[-1]}


def select_after_remove_tracks(prev_track_ids, new_track_ids, selected, pivot_id):
    """reference: useSelectedTracks.ts:82-113."""
    if not new_track_ids:
        return {"selected": [], "pivotId": -1}
    survivors = [s for s in selected if s in new_track_ids]
    if survivors:
        pivot = pivot_id if pivot_id in survivors else survivors[-1]
        return {"selected": survivors, "pivotId": pivot}
    prev_pivot_idx = prev_track_ids.index(pivot_id) if pivot_id in prev_track_ids else -1
    for i in range(1, len(prev_track_ids)):
        lo = prev_pivot_idx - i
        # JS arr[-k] is undefined (never matches); Python would wrap
        if 0 <= lo < len(prev_track_ids) and prev_track_ids[lo] in new_track_ids:
            return {"selected": [prev_track_ids[lo]], "pivotId": prev_track_ids[lo]}
        hi = prev_pivot_idx + i
        if hi < len(prev_track_ids) and prev_track_ids[hi] in new_track_ids:
            return {"selected": [prev_track_ids[hi]], "pivotId": prev_track_ids[hi]}
    return {"selected": [new_track_ids[0]], "pivotId": new_track_ids[0]}


# ---------------------------------------------------------------------------
# freq axis — reference axis.rs:396-449 + FreqAxis.tsx:30-195


def freq_pos_to_hz(freq_scale, pos, height, hz_lo, hz_hi, max_track_hz):
    """reference: axis.rs freq_pos_to_hz semantics, f64 (freqscale.js)."""
    hi = min(hz_hi, max_track_hz)
    rel = 1 - pos / height
    if freq_scale == "Mel":
        mel_lo = mel_from_hz(hz_lo)
        mel_hi = mel_from_hz(hi)
        return mel_to_hz(mel_lo + rel * (mel_hi - mel_lo))
    return hz_lo + rel * (hi - hz_lo)


def freq_hz_to_pos(freq_scale, hz, height, hz_lo, hz_hi, max_track_hz):
    """reference: axis.rs freq_hz_to_pos semantics, f64."""
    hi = min(hz_hi, max_track_hz)
    if freq_scale == "Mel":
        mel_lo = mel_from_hz(hz_lo)
        mel_hi = mel_from_hz(hi)
        rel = (mel_from_hz(hz) - mel_lo) / (mel_hi - mel_lo)
    else:
        rel = (hz - hz_lo) / (hi - hz_lo)
    return (1 - rel) * height


def freq_axis_cursor_state(cursor_pos, rect_height):
    """reference: FreqAxis.tsx:30-34."""
    if cursor_pos < rect_height / 3:
        return "control-max-hz"
    if cursor_pos < rect_height * 2 / 3:
        return "shift-hz-range"
    return "control-min-hz"


def clamp_max_hz(max_hz, min_hz, max_track_hz):
    """reference: FreqAxis.tsx:63-66 (above track max -> inf = full)."""
    if max_hz > max_track_hz:
        return INF
    return max(max_hz, min_hz + MIN_HZ_RANGE)


def clamp_min_hz(min_hz, max_hz):
    """reference: FreqAxis.tsx:67-69."""
    return min(max(min_hz, 0), max_hz - MIN_HZ_RANGE)


def freq_max_drag(anchor, cursor_axis_pos, axis_height, freq_scale, max_track_hz):
    """reference: FreqAxis.tsx:105-125."""
    lo, hi = anchor["hzRange"]
    anchor_rel = 1 - anchor["cursorAxisPos"] / axis_height
    cursor_rel = max(1 - cursor_axis_pos / axis_height, 0)
    new_max_rel = anchor_rel / cursor_rel if cursor_rel > 0 else INF
    new_max_pos = (1 - new_max_rel) * axis_height
    max_hz = freq_pos_to_hz(freq_scale, new_max_pos, axis_height, lo, hi, max_track_hz)
    return [lo, clamp_max_hz(max_hz, lo, max_track_hz)]


def freq_min_drag(anchor, cursor_axis_pos, freq_scale, max_track_hz):
    """reference: FreqAxis.tsx:126-133."""
    lo, hi = anchor["hzRange"]
    min_hz = freq_pos_to_hz(
        freq_scale, anchor["cursorAxisPos"], max(cursor_axis_pos, 1), lo, hi,
        max_track_hz,
    )
    return [clamp_min_hz(min_hz, hi), hi]


def freq_shift_drag(anchor, cursor_axis_pos, axis_height, freq_scale, max_track_hz):
    """reference: FreqAxis.tsx:134-168 ([0, inf] = reset to full)."""
    lo, hi = anchor["hzRange"]
    shift = anchor["cursorAxisPos"] - cursor_axis_pos
    min_hz_pos = axis_height + shift
    max_hz_pos = shift
    zero_hz_pos = anchor.get("zeroHzPos")
    zero_hz_pos = axis_height if zero_hz_pos is None else zero_hz_pos
    max_track_hz_pos = anchor.get("maxTrackHzPos")
    max_track_hz_pos = 0 if max_track_hz_pos is None else max_track_hz_pos
    if min_hz_pos > zero_hz_pos:
        max_hz_pos -= min_hz_pos - zero_hz_pos
        min_hz_pos = zero_hz_pos
    if max_hz_pos < max_track_hz_pos:
        min_hz_pos += max_track_hz_pos - max_hz_pos
        max_hz_pos = max_track_hz_pos
    if min_hz_pos > zero_hz_pos:
        return [0, INF]
    return [
        freq_pos_to_hz(freq_scale, min_hz_pos, axis_height, lo, hi, max_track_hz),
        freq_pos_to_hz(freq_scale, max_hz_pos, axis_height, lo, hi, max_track_hz),
    ]


def freq_wheel_max_hz(hz_range, delta_y, freq_scale, max_track_hz):
    """reference: FreqAxis.tsx:178-195."""
    max_hz = freq_pos_to_hz(
        freq_scale, delta_y, 500, hz_range[0], hz_range[1], max_track_hz
    )
    return [hz_range[0], clamp_max_hz(max_hz, hz_range[0], max_track_hz)]


def zoom_freq_range_at(hz_range, max_hz, freq_scale, factor, anchor_frac):
    """repo freq-range zoom (menu freq-zoom-in/out analogue); None = full."""
    lo0 = hz_range[0] if hz_range else 0.0
    hi0 = hz_range[1] if hz_range else max_hz
    p_lo = relative_freq_pos(lo0, max_hz, freq_scale)
    p_hi = relative_freq_pos(hi0, max_hz, freq_scale)
    span = p_hi - p_lo
    anchor = p_lo + anchor_frac * span
    new_span = min(max(span * factor, 0.01), 1)
    lo = anchor - anchor_frac * new_span
    hi = lo + new_span
    if lo < 0:
        hi -= lo
        lo = 0
    if hi > 1:
        lo -= hi - 1
        hi = 1
    if lo <= 1e-9 and hi >= 1 - 1e-9:
        return None
    return [
        hz_from_relative_pos(lo, max_hz, freq_scale),
        hz_from_relative_pos(hi, max_hz, freq_scale),
    ]


# ---------------------------------------------------------------------------
# amp axis — reference AmpAxis.tsx:31-108


def calc_interval_zero_ratio(amp_range):
    """reference: AmpAxis.tsx:42-46."""
    interval = amp_range[1] - amp_range[0]
    return [interval, amp_range[1] / interval]


def clamp_amp_range(amp_range):
    """reference: AmpAxis.tsx:47-53."""
    return [
        min(max(amp_range[0], -MAX_ABS_AMP_RANGE), -MIN_ABS_AMP_RANGE),
        min(max(amp_range[1], MIN_ABS_AMP_RANGE), MAX_ABS_AMP_RANGE),
    ]


def limit_amp_cursor_ratio(cursor_state, cursor_ratio, amp_range):
    """reference: AmpAxis.tsx:60-71."""
    _, zero_ratio = calc_interval_zero_ratio(amp_range)
    if cursor_state == "positive":
        return min(cursor_ratio, zero_ratio - MIN_DIST_FROM_0_FOR_DRAG)
    return max(cursor_ratio, zero_ratio + MIN_DIST_FROM_0_FOR_DRAG)


def amp_axis_cursor_state(cursor_pos, rect_height):
    """reference: AmpAxis.tsx:31-34."""
    return "positive" if cursor_pos < rect_height / 2 else "negative"


def amp_drag(cursor_state, cursor_ratio, anchor):
    """reference: AmpAxis.tsx:84-96. anchor: {cursorRatio, ampRange}."""
    anchor_ratio = anchor["cursorRatio"]
    anchor_range = anchor["ampRange"]
    anchor_interval, zero_ratio = calc_interval_zero_ratio(anchor_range)
    limited = limit_amp_cursor_ratio(cursor_state, cursor_ratio, anchor_range)
    new_interval = (anchor_interval * (anchor_ratio - zero_ratio)) / (limited - zero_ratio)
    return clamp_amp_range([new_interval * (zero_ratio - 1), new_interval * zero_ratio])


def amp_wheel(amp_range, delta_y):
    """reference: AmpAxis.tsx:98-108."""
    interval, zero_ratio = calc_interval_zero_ratio(amp_range)
    new_interval = interval * max(1 - delta_y / 500, 0)
    return clamp_amp_range([new_interval * (zero_ratio - 1), new_interval * zero_ratio])


# ---------------------------------------------------------------------------
# overview lens — reference Overview.tsx:109-183


def adjacent_axis_position(axis_position, axis_length):
    """reference: wasm-wrapper.ts:120-131."""
    if axis_position <= axis_length / 2:
        return min(axis_position + 1, axis_length)
    return max(axis_position - 1, 0)


def linear_pos_to_value(pos, axis_length, top_value, bottom_value):
    """reference: AmpAxis.tsx:123-130 / ColorMap.tsx:53-63."""
    return top_value - (pos / axis_length) * (top_value - bottom_value)


def tick_unit_from_values(tick_values):
    """reference: wasm-wrapper.ts:141-147."""
    finite = [v for v in tick_values if math.isfinite(v)]
    for a, b in zip(finite, finite[1:]):
        unit = abs(b - a)
        if unit > 0:
            return unit
    return float("nan")


def linear_tooltip_args(pos, axis_length, top_value, bottom_value, markers):
    """reference: wasm-wrapper.ts:120-148 (amp axis / dB colorbar)."""
    value = linear_pos_to_value(pos, axis_length, top_value, bottom_value)
    adj = adjacent_axis_position(pos, axis_length)
    resolution = abs(
        linear_pos_to_value(adj, axis_length, top_value, bottom_value) - value
    )
    ticks = [
        linear_pos_to_value(
            min(max(m[0] * axis_length, 0.0), axis_length),
            axis_length, top_value, bottom_value,
        )
        for m in markers
    ]
    return {
        "value": value,
        "resolution": resolution,
        "tickUnit": tick_unit_from_values(ticks),
    }


def time_tooltip_display(format_display):
    """reference: TimeAxis.tsx:79-90."""
    display = (
        f"{format_display}x" if "." in format_display else f"{format_display}.x"
    )
    return {"display": display, "appendSeconds": format_display.startswith("ss")}


def freq_tooltip_label(label):
    """reference: FreqAxis.tsx:214-221."""
    if label.endswith("k"):
        return f"{label[:-1]} kHz"
    return f"{label} Hz"


def freq_tooltip_args(freq_scale, pos, axis_length, hz_lo, hz_hi, max_track_hz):
    """reference: wasm-wrapper.ts:150-158 over FreqAxis.tsx:214-220."""
    hz = freq_pos_to_hz(freq_scale, pos, axis_length, hz_lo, hz_hi, max_track_hz)
    adj = adjacent_axis_position(pos, axis_length)
    adj_hz = freq_pos_to_hz(freq_scale, adj, axis_length, hz_lo, hz_hi, max_track_hz)
    return {"hz": hz, "resolutionHz": abs(adj_hz - hz)}


def overview_sec_from_x(cursor_x, rect_width, max_track_sec):
    """reference: Overview.tsx:109-112."""
    return (cursor_x / rect_width) * max_track_sec


def overview_cursor_state(cursor_x, start_sec, lens_duration_sec, px_per_sec):
    """reference: Overview.tsx:158-173 (JS Math.round on edge positions)."""
    lens_start_x = _js_round(start_sec * px_per_sec)
    lens_end_x = _js_round((start_sec + lens_duration_sec) * px_per_sec)
    if lens_start_x - LENS_THICKNESS <= cursor_x <= lens_start_x + LENS_THICKNESS:
        return "left"
    if lens_start_x + LENS_THICKNESS < cursor_x < lens_end_x - LENS_THICKNESS:
        return "inlens"
    if lens_end_x - LENS_THICKNESS <= cursor_x <= lens_end_x + LENS_THICKNESS:
        return "right"
    return "outlens"


def overview_drag_anchor(cursor_state, cursor_x, rect_width, max_track_sec, start_sec, lens_duration_sec):
    """reference: Overview.tsx:175-183."""
    if cursor_state == "inlens":
        sec = overview_sec_from_x(cursor_x, rect_width, max_track_sec)
        return (sec - start_sec) / lens_duration_sec
    return 0.5


def overview_wave_level(sample_count, width):
    """overview.js whole-track strip level (one bin per CSS px)."""
    return max(0, math.ceil(math.log2(sample_count / max(width, 1))))


OVERVIEW_MAX_CH = 4  # constants/tracks.ts:211
OVERVIEW_CH_GAP_HEIGHT = 1  # OverviewWaveformViewport.tsx:19
OVERVIEW_GAIN_HEIGHT_RATIO = 0.2  # OverviewWaveformViewport.tsx:20


def overview_lane_layout(n_ch, height, has_gain):
    """reference: OverviewWaveformViewport.tsx:385-389,407-417."""
    gap = OVERVIEW_CH_GAP_HEIGHT
    ch_height = (height - gap * max(n_ch - 1, 0)) / n_ch
    gain_height = ch_height * OVERVIEW_GAIN_HEIGHT_RATIO if has_gain else 0
    return [
        {
            "y": i * (ch_height + gap) + gain_height,
            "height": ch_height - 2 * gain_height,
            "gainHeight": gain_height,
        }
        for i in range(int(n_ch))
    ]


def amp_range_from_bins(bins_per_ch):
    """reference: OverviewWaveformViewport.tsx:43-55 calcAmpRange."""
    lo, hi = -1.0, 1.0
    for bins in bins_per_ch:
        n = len(bins) // 3
        for i in range(n):
            lo = min(lo, bins[i * 3])
            hi = max(hi, bins[i * 3 + 1])
    return [lo, hi]


def overview_wave_points(bins, lane, track_width, amp_range, clamp_values):
    """reference: renderWaveformTiles via OverviewWaveformViewport.tsx:453-480."""
    n = len(bins) // 3
    points = []
    if not n:
        return points
    span = max(amp_range[1] - amp_range[0], 1e-8)

    def clamp(v):
        return min(max(v, -1), 1) if clamp_values else v

    def to_y(v):
        return lane["y"] + ((amp_range[1] - clamp(v)) / span) * lane["height"]

    for i in range(n):
        points.append([(i / n) * track_width, to_y(bins[i * 3 + 1])])
    for i in range(n - 1, -1, -1):
        points.append([(i / n) * track_width, to_y(bins[i * 3])])
    return points


def calc_limiter_gain_envelopes(gain_seq, width, height, gain_range):
    """reference-exact: OverviewWaveformViewport.tsx:57-111."""
    n = len(gain_seq)
    if n == 0 or width <= 0 or height <= 0:
        return []
    x_scale = width / n
    y_scale = -height / max(gain_range[1] - gain_range[0], 1e-8)
    y_offset = -gain_range[1] * y_scale

    def gain_to_y(value):
        return value * y_scale + y_offset

    y_unity = gain_to_y(gain_range[1])
    envelopes = []
    current = []
    i = 0
    while i < n:
        x = i * x_scale
        x_floor = math.floor(x)
        x_mid = x_floor + 0.5
        i2 = i
        i_next = n
        while i2 < n:
            x2_floor = math.floor(i2 * x_scale)
            if x2_floor > x_floor and i_next == n:
                i_next = i2
            if x2_floor > x_floor + 1:
                break
            i2 += 1
        if i2 == i:
            i2 = min(i + 1, n)
        min_gain = math.inf
        for j in range(i, i2):
            min_gain = min(min_gain, gain_seq[j])
        bottom = gain_to_y(min_gain)
        if bottom > y_unity:
            if not current:
                current.append([float(x_floor), y_unity])
            current.append([x_mid, bottom])
        elif current:
            current.append([float(x_floor), y_unity])
            envelopes.append(current)
            current = []
        i = i_next
    if current:
        last_x = (n - 1) * x_scale
        current.append([float(math.floor(last_x) + 1), gain_to_y(gain_seq[n - 1])])
        envelopes.append(current)
    return envelopes


def colorbar_color_index(y, height, colormap_length):
    """overview.js drawColorbar LUT index (0 = reserved black skipped)."""
    return min(
        colormap_length - 1,
        1 + _js_round(((height - 1 - y) / max(height - 1, 1)) * (colormap_length - 2)),
    )


# ---------------------------------------------------------------------------
# misc app formulas


def _js_parse_float(v):
    """JS parseFloat: leading numeric prefix (incl. Infinity) or NaN."""
    import re as _re

    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)
    s = str(v).strip()
    m = _re.match(r"([+-]?)Infinity", s)
    if m:
        return -math.inf if m.group(1) == "-" else math.inf
    m = _re.match(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", s)
    return float(m.group()) if m else float("nan")


# control panel — reference FloatRangeInput.tsx + Control.tsx

MIN_WIN_MILLISEC = 1.0  # constants/tracks.ts:205
MAX_WIN_MILLISEC = 2000.0  # engine network-entry cap (session.set_spec_setting)
MIN_COMMON_NORMALIZE_DB = -40.0  # constants/tracks.ts:196
DB_RANGE_DBLCLICK = 100.0  # DB_RANGE_DETENTS[len-2] (Control.tsx:302)
NORMALIZE_PEAK_DEFAULT_DB = 0.0  # Control.tsx:63-65
NORMALIZE_DB_DEFAULT = -18.0  # Control.tsx:66-68 (seeded only when LUFS)


def float_range_text_commit(text, range_value, prev_value, lo, hi):
    """reference: FloatRangeInput.tsx:104-121."""
    value = _js_parse_float(text)
    if math.isnan(value):
        value = _js_parse_float(range_value)
        if math.isnan(value):
            value = prev_value
    clamped = min(max(value, lo), hi)
    return {"value": clamped, "changed": clamped != prev_value}


def float_range_reset_click(button, detail, alt_key):
    """reference: FloatRangeInput.tsx:83-87 / Control.tsx:80-87."""
    return button == 0 and (detail == 2 or (detail == 1 and alt_key))


def win_millisec_commit(text, current_win_millisec):
    """reference: Control.tsx:97-110 (NaN-restore noted in the JS)."""
    restore = {"set": None, "display": _js_to_fixed(current_win_millisec, 1)}
    if text is None:
        return restore
    win_millisec = _js_parse_float(text)
    if not math.isfinite(win_millisec):
        return restore
    if win_millisec < 1:
        return {"set": MIN_WIN_MILLISEC, "display": _js_to_fixed(MIN_WIN_MILLISEC, 1)}
    if win_millisec > MAX_WIN_MILLISEC:
        return {"set": MAX_WIN_MILLISEC, "display": _js_to_fixed(MAX_WIN_MILLISEC, 1)}
    return {"set": win_millisec, "display": _js_to_fixed(win_millisec, 1)}


def channel_label(n_ch, ch):
    """reference: constants/tracks.ts:8-12 (CHANNEL) via TrackInfo.tsx:85-88
    — mono "M", stereo "L"/"R", "" past the table."""
    if n_ch == 1 and ch == 0:
        return "M"
    if n_ch == 2 and ch == 0:
        return "L"
    if n_ch == 2 and ch == 1:
        return "R"
    return ""


def normalize_select_target(kind, peak_mem, db_mem):
    """reference: Control.tsx:118-143."""
    if kind == "Off":
        return {"type": "Off"}
    if kind == "PeakdB":
        return {"type": kind, "target": peak_mem}
    return {"type": kind, "target": db_mem}


def fit_px_per_sec(width, max_sec):
    return max(width / max(max_sec, 1e-8), 1e-8)


def splitter_width(start_w, dx):
    return min(max(start_w + dx, 90), 480)


def scrub_sec_at(client_x, rect_left, start_sec, px_per_sec):
    return max(start_sec + (client_x - rect_left) / px_per_sec, 0)


def jump_amount_sec(big):
    return PLAY_BIG_JUMP_SEC if big else PLAY_JUMP_SEC


def _js_num_str(x):
    """JS number→string for the value ranges the labels see (shortest
    positional, no trailing .0)."""
    if x == math.floor(x) and abs(x) < 1e21:
        return str(int(x))
    return repr(float(x))


def sr_khz_label(sr):
    """reference: TrackSummary.tsx:19 — plain JS number→string of sr/1000."""
    return _js_num_str(sr / 1000)


def track_meta_line(format_name, bit_depth, bitrate, sr):
    """reference: TrackSummary.tsx:159-165 — conditional ' | ' segments."""
    parts = [format_name]
    if bit_depth:
        parts.append(bit_depth)
    if bitrate:
        parts.append(bitrate)
    parts.append(f"{sr_khz_label(sr)} kHz")
    return " | ".join(parts)


def non_finite_number_label(value):
    """reference: axis.rs:525-533 format_non_finite_float."""
    if value == math.inf:
        return "+∞"
    if value == -math.inf:
        return "-∞"
    return "nan"


def lufs_label(formatted):
    """reference: TrackSummary.tsx:12,20 — backend-formatted number + unit."""
    return f"{formatted} LUFS"


def fmt_time(sec):
    if not math.isfinite(sec) or sec < 0:
        sec = 0.0
    h = math.floor(sec / 3600)
    m = math.floor(sec / 60) % 60
    s = math.floor(sec) % 60
    ms = math.floor((sec % 1) * 1000)
    return f"{h:02d}:{m:02d}:{s:02d}.{ms:03d}"


# remote-audio Web Audio scheduling (applogic.js; reference parity:
# src-tauri/src/player/stream.rs:501-639 cpal callback pacing, :110
# cursor-version resets)
AUDIO_CHUNK_FRAMES = 4096
AUDIO_BUFFER_AHEAD_SEC = 0.35
AUDIO_MIN_LEAD_SEC = 0.06
AUDIO_MAX_PULLS_PER_TICK = 4
AUDIO_PUMP_INTERVAL_MS = 120


def audio_chunk_start_time(next_start_time, ctx_time, min_lead_sec):
    return max(next_start_time, ctx_time + min_lead_sec)


def audio_pull_count(next_start_time, ctx_time, buffer_ahead_sec, chunk_dur_sec, max_pulls):
    deficit = buffer_ahead_sec - (next_start_time - ctx_time)
    if deficit <= 0 or chunk_dur_sec <= 0:
        return 0.0
    return float(min(max_pulls, max(1.0, math.ceil(deficit / chunk_dur_sec))))


def audio_cursor_reset(version, seen_version):
    return seen_version is not None and version != seen_version


def deinterleave_pcm(pcm, channels, n_frames, channel):
    n = int(n_frames)
    ch = int(channels)
    c = int(channel)
    return [float(pcm[i * ch + c]) for i in range(n)]


# applogic.js export -> twin mapping; test_viewer_consistency asserts this
# covers the JS export list exactly (a new untwinned export fails the suite).
TWINNED = {
    "MAX_PX_PER_SEC": MAX_PX_PER_SEC,
    "FIT_TOLERANCE_SEC": FIT_TOLERANCE_SEC,
    "MIN_ABS_AMP_RANGE": MIN_ABS_AMP_RANGE,
    "MAX_ABS_AMP_RANGE": MAX_ABS_AMP_RANGE,
    "MIN_HZ_RANGE": MIN_HZ_RANGE,
    "MIN_DIST_FROM_0_FOR_DRAG": MIN_DIST_FROM_0_FOR_DRAG,
    "MIN_HEIGHT": MIN_HEIGHT,
    "MAX_HEIGHT": MAX_HEIGHT,
    "LENS_THICKNESS": LENS_THICKNESS,
    "PLAY_JUMP_SEC": PLAY_JUMP_SEC,
    "PLAY_BIG_JUMP_SEC": PLAY_BIG_JUMP_SEC,
    "TRACK_SWITCH_SEEK_TTL_MS": TRACK_SWITCH_SEEK_TTL_MS,
    "normalizeStartSec": normalize_start_sec,
    "normalizePxPerSec": normalize_px_per_sec,
    "updateLensParams": update_lens_params,
    "moveLensStartSec": move_lens_start_sec,
    "timeAxisDragAnchor": time_axis_drag_anchor,
    "timeAxisDragStartSec": time_axis_drag_start_sec,
    "resizeLensLeft": resize_lens_left,
    "resizeLensRight": resize_lens_right,
    "classifyWheel": classify_wheel,
    "horizontalZoom": horizontal_zoom,
    "horizontalScroll": horizontal_scroll,
    "calcZoomedHeight": calc_zoomed_height,
    "calcScrollTopAtCursor": calc_scroll_top_at_cursor,
    "zoomHeightAtCursor": zoom_height_at_cursor,
    "followPlayheadStartSec": follow_playhead_start_sec,
    "selectSecAutoScroll": select_sec_auto_scroll,
    "playerPosition": player_position,
    "clampSelectSec": clamp_select_sec,
    "playingTrackStartSec": playing_track_start_sec,
    "jumpTargetSec": jump_target_sec,
    "arrowPanStartSec": arrow_pan_start_sec,
    "SUPPORTED_TYPES": SUPPORTED_TYPES,
    "splitSupportedPaths": split_supported_paths,
    "fileDropIndex": file_drop_index,
    "zoomStepDelta": zoom_step_delta,
    "zoomLensAtSelect": zoom_lens_at_select,
    "freqZoomScrollTop": freq_zoom_scroll_top,
    "nextTrackOnArrow": next_track_on_arrow,
    "selectTrack": select_track,
    "selectAllTracks": select_all_tracks,
    "selectAfterAddTracks": select_after_add_tracks,
    "selectAfterRemoveTracks": select_after_remove_tracks,
    "freqPosToHz": freq_pos_to_hz,
    "freqHzToPos": freq_hz_to_pos,
    "freqAxisCursorState": freq_axis_cursor_state,
    "clampMaxHz": clamp_max_hz,
    "clampMinHz": clamp_min_hz,
    "freqMaxDrag": freq_max_drag,
    "freqMinDrag": freq_min_drag,
    "freqShiftDrag": freq_shift_drag,
    "freqWheelMaxHz": freq_wheel_max_hz,
    "zoomFreqRangeAt": zoom_freq_range_at,
    "calcIntervalZeroRatio": calc_interval_zero_ratio,
    "clampAmpRange": clamp_amp_range,
    "limitAmpCursorRatio": limit_amp_cursor_ratio,
    "ampAxisCursorState": amp_axis_cursor_state,
    "ampDrag": amp_drag,
    "ampWheel": amp_wheel,
    "adjacentAxisPosition": adjacent_axis_position,
    "linearPosToValue": linear_pos_to_value,
    "tickUnitFromValues": tick_unit_from_values,
    "linearTooltipArgs": linear_tooltip_args,
    "timeTooltipDisplay": time_tooltip_display,
    "freqTooltipLabel": freq_tooltip_label,
    "freqTooltipArgs": freq_tooltip_args,
    "overviewSecFromX": overview_sec_from_x,
    "overviewCursorState": overview_cursor_state,
    "overviewDragAnchor": overview_drag_anchor,
    "overviewWaveLevel": overview_wave_level,
    "OVERVIEW_MAX_CH": OVERVIEW_MAX_CH,
    "OVERVIEW_CH_GAP_HEIGHT": OVERVIEW_CH_GAP_HEIGHT,
    "OVERVIEW_GAIN_HEIGHT_RATIO": OVERVIEW_GAIN_HEIGHT_RATIO,
    "overviewLaneLayout": overview_lane_layout,
    "ampRangeFromBins": amp_range_from_bins,
    "overviewWavePoints": overview_wave_points,
    "calcLimiterGainEnvelopes": calc_limiter_gain_envelopes,
    "colorbarColorIndex": colorbar_color_index,
    "MIN_WIN_MILLISEC": MIN_WIN_MILLISEC,
    "MAX_WIN_MILLISEC": MAX_WIN_MILLISEC,
    "MIN_COMMON_NORMALIZE_DB": MIN_COMMON_NORMALIZE_DB,
    "DB_RANGE_DBLCLICK": DB_RANGE_DBLCLICK,
    "NORMALIZE_PEAK_DEFAULT_DB": NORMALIZE_PEAK_DEFAULT_DB,
    "NORMALIZE_DB_DEFAULT": NORMALIZE_DB_DEFAULT,
    "channelLabel": channel_label,
    "floatRangeTextCommit": float_range_text_commit,
    "floatRangeResetClick": float_range_reset_click,
    "winMillisecCommit": win_millisec_commit,
    "normalizeSelectTarget": normalize_select_target,
    "fitPxPerSec": fit_px_per_sec,
    "splitterWidth": splitter_width,
    "scrubSecAt": scrub_sec_at,
    "jumpAmountSec": jump_amount_sec,
    "srKhzLabel": sr_khz_label,
    "trackMetaLine": track_meta_line,
    "nonFiniteNumberLabel": non_finite_number_label,
    "lufsLabel": lufs_label,
    "fmtTime": fmt_time,
    "AUDIO_CHUNK_FRAMES": AUDIO_CHUNK_FRAMES,
    "AUDIO_BUFFER_AHEAD_SEC": AUDIO_BUFFER_AHEAD_SEC,
    "AUDIO_MIN_LEAD_SEC": AUDIO_MIN_LEAD_SEC,
    "AUDIO_MAX_PULLS_PER_TICK": AUDIO_MAX_PULLS_PER_TICK,
    "AUDIO_PUMP_INTERVAL_MS": AUDIO_PUMP_INTERVAL_MS,
    "audioChunkStartTime": audio_chunk_start_time,
    "audioPullCount": audio_pull_count,
    "audioCursorReset": audio_cursor_reset,
    "deinterleavePcm": deinterleave_pcm,
}
