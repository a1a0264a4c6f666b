// Pure app-layer interaction math — NO DOM, no fetch, no globals.  Every
// export here has an executed Python twin (thesia_tpu/viewer/twin_app.py)
// golden-tested against the reference formulas; the consistency test
// enumerates the export list so an untwinned formula fails the suite.
//
// reference: src/prototypes/MainViewer/MainViewer.tsx:359-595 (lens
// normalize, wheel gestures, zoom-at-cursor incl. height zoom with scroll
// correction), src/hooks/useSelectedTracks.ts:5-126 (selection pivot),
// src/prototypes/MainViewer/{AmpAxis,FreqAxis}.tsx (editable axis ranges),
// src/prototypes/Overview/Overview.tsx (lens drag/resize),
// src/hooks/usePlayer.ts:44-52 (position extrapolation).

import { hzFromRelativePos, melFromHz, melToHz, relativeFreqPos } from "./freqscale.js";

// reference: constants/tracks.ts
export const MAX_PX_PER_SEC = 384000; // tracks.ts:189
export const FIT_TOLERANCE_SEC = 1e-6; // tracks.ts:190
export const MIN_ABS_AMP_RANGE = 1e-5; // tracks.ts:193
export const MAX_ABS_AMP_RANGE = 5; // tracks.ts:194
export const MIN_HZ_RANGE = 100; // tracks.ts:202
export const MIN_DIST_FROM_0_FOR_DRAG = 0.01; // tracks.ts:203
export const MIN_HEIGHT = 153; // tracks.ts:183 (MIN_TICK_SCALE_BOUNDARY 80 + 73)
export const MAX_HEIGHT = 5000; // tracks.ts:184
export const LENS_THICKNESS = 3; // Overview.tsx:12
export const PLAY_JUMP_SEC = 1.0; // player.rs:20
export const PLAY_BIG_JUMP_SEC = 5.0; // player.rs:21

// ---------------------------------------------------------------------------
// lens (startSec, pxPerSec) normalization — reference MainViewer.tsx:359-392

export function normalizeStartSec(startSec, pxPerSec, maxEndSec, width) {
  // reference: MainViewer.tsx:359-361
  return Math.min(
    Math.max(startSec, 0),
    Math.max(maxEndSec - width / Math.max(pxPerSec, 1e-8), 0)
  );
}

export function normalizePxPerSec(pxPerSec, startSec, maxTrackSec, width) {
  // reference: MainViewer.tsx:363-371 (incl. the degenerate min(...,1e-8)
  // branch when the view starts at/after the end of the longest track)
  if (maxTrackSec - startSec < 1e-6) {
    return Math.min(pxPerSec, MAX_PX_PER_SEC, 1e-8);
  }
  return Math.min(
    Math.max(pxPerSec, width / (maxTrackSec - startSec), 1e-8),
    Math.max(MAX_PX_PER_SEC, width / (maxTrackSec - startSec))
  );
}

export function updateLensParams(cur, params, maxTrackSec, width) {
  // reference: MainViewer.tsx:373-392 — startSec normalized against the NEW
  // pxPerSec first, then pxPerSec against the new startSec; returns the fit
  // flag the reference derives for the fit button state.
  let newStartSec = params.startSec ?? cur.startSec;
  let newPxPerSec = params.pxPerSec ?? cur.pxPerSec;
  if (newStartSec !== cur.startSec) {
    newStartSec = normalizeStartSec(newStartSec, newPxPerSec, maxTrackSec, width);
  }
  if (newPxPerSec !== cur.pxPerSec) {
    newPxPerSec = normalizePxPerSec(newPxPerSec, newStartSec, maxTrackSec, width);
  }
  const isFit =
    newStartSec <= FIT_TOLERANCE_SEC &&
    width >= (maxTrackSec - FIT_TOLERANCE_SEC) * newPxPerSec;
  return { startSec: newStartSec, pxPerSec: newPxPerSec, isFit };
}

export function moveLensStartSec(sec, anchorRatio, pxPerSec, width) {
  // reference: MainViewer.tsx:394-397 — grab point stays under the cursor
  const lensDurationSec = width / pxPerSec;
  return sec - lensDurationSec * anchorRatio;
}

export function timeAxisDragAnchor(cursorX, rectWidth, startSec, pxPerSec) {
  // reference: TimeAxis.tsx:43-49 calcDragAnchor — remember the grabbed
  // second and its fractional position along the axis
  const cursorRatio = cursorX / rectWidth;
  return { cursorRatio, sec: startSec + (cursorRatio * rectWidth) / pxPerSec };
}

export function timeAxisDragStartSec(anchor, cursorX, rectWidth, pxPerSec) {
  // reference: TimeAxis.tsx:51-63 handleDragging (anchored pan: the grabbed
  // second stays under the cursor) composed with MainViewer.tsx:394-397
  const cursorRatio = cursorX / rectWidth;
  const sec =
    anchor.sec - ((cursorRatio - anchor.cursorRatio) * rectWidth) / pxPerSec;
  return moveLensStartSec(sec, anchor.cursorRatio, pxPerSec, rectWidth);
}

export function resizeLensLeft(cur, sec, maxTrackSec, width) {
  // reference: MainViewer.tsx:399-407
  const endSec = cur.startSec + width / cur.pxPerSec;
  const newStartSec = normalizeStartSec(sec, MAX_PX_PER_SEC, endSec, width);
  const newPxPerSec = normalizePxPerSec(
    width / Math.max(endSec - newStartSec, 1e-8), newStartSec, maxTrackSec, width
  );
  return updateLensParams(cur, { startSec: newStartSec, pxPerSec: newPxPerSec },
    maxTrackSec, width);
}

export function resizeLensRight(cur, sec, maxTrackSec, width) {
  // reference: MainViewer.tsx:409-412 (sec == startSec -> width/0 = +inf,
  // clamped by normalizePxPerSec's upper bound)
  const newPxPerSec = normalizePxPerSec(
    width / Math.max(sec - cur.startSec, 0), cur.startSec, maxTrackSec, width
  );
  return updateLensParams(cur, { pxPerSec: newPxPerSec }, maxTrackSec, width);
}

// ---------------------------------------------------------------------------
// wheel gesture normalization — reference MainViewer.tsx:538-576

export function classifyWheel(e, isApple) {
  // e: {deltaX, deltaY, shiftKey, ctrlKey, altKey}.  Returns
  // {kind: "hzoom"|"vzoom"|"hscroll"|"native", delta}.
  const isApplePinch = isApple && e.ctrlKey;
  const isAppleZoom = isApple && e.altKey;
  const isNonAppleZoom = !isApple && e.ctrlKey;
  const isZoom = isApplePinch || isAppleZoom || isNonAppleZoom;
  let horizontal;
  let delta;
  if (isApplePinch) {
    horizontal = !e.shiftKey;
    delta = horizontal ? -12 * e.deltaY : -6 * e.deltaY;
  } else {
    if (Math.abs(e.deltaY) < Math.abs(e.deltaX)) {
      horizontal = !e.shiftKey;
      delta = e.deltaX;
    } else {
      horizontal = e.shiftKey;
      delta = e.deltaY;
    }
    if (isNonAppleZoom) delta = -delta;
  }
  if (!isZoom && !horizontal) return { kind: "native", delta };
  if (isZoom) return { kind: horizontal ? "hzoom" : "vzoom", delta };
  return { kind: "hscroll", delta };
}

export function horizontalZoom(cur, cursorX, delta, maxTrackSec, width) {
  // reference: MainViewer.tsx:577-588 — cursor-anchored time zoom
  const newPxPerSec = normalizePxPerSec(
    cur.pxPerSec * (1 + delta / 1000), 0, maxTrackSec, width
  );
  const newStartSec = normalizeStartSec(
    cur.startSec + cursorX / cur.pxPerSec - cursorX / newPxPerSec,
    newPxPerSec, maxTrackSec, width
  );
  return updateLensParams(cur, { startSec: newStartSec, pxPerSec: newPxPerSec },
    maxTrackSec, width);
}

export function horizontalScroll(cur, delta, maxTrackSec, width) {
  // reference: MainViewer.tsx:590-592
  return updateLensParams(cur, { startSec: cur.startSec + (0.5 * delta) / cur.pxPerSec },
    maxTrackSec, width);
}

// ---------------------------------------------------------------------------
// row-height zoom with cursor-anchored scroll correction —
// reference MainViewer.tsx:414-489

export function calcZoomedHeight(baseHeight, delta) {
  // reference: MainViewer.tsx:415-417
  return Math.round(Math.min(Math.max(baseHeight + delta, MIN_HEIGHT), MAX_HEIGHT));
}

export function calcScrollTopAtCursor(
  rowTops, curHeight, baseHeight, newHeight, cursorY, scrollTop, headerHeight
) {
  // reference: MainViewer.tsx:441-480.  rowTops are the row top offsets at
  // curHeight; getRowTopAtHeight(i, h) = rowTops[i] + i*(h - curHeight)
  // (MainViewer.tsx:436-439).  Returns the scrollTop that keeps the row
  // point under the cursor fixed, or null with no rows.
  if (!rowTops.length) return null;
  const rowTopAt = (i, h) => rowTops[i] + i * (h - curHeight);
  const contentY = scrollTop + cursorY - headerHeight;
  let newContentY = 0;
  let foundAnchor = false;
  for (let i = 0; i < rowTops.length; i += 1) {
    const rowTop = rowTopAt(i, baseHeight);
    const newRowTop = rowTopAt(i, newHeight);
    if (contentY < rowTop) {
      newContentY = newRowTop + (contentY - rowTop);
      foundAnchor = true;
      break;
    }
    if (contentY <= rowTop + baseHeight) {
      const offsetRatio = (contentY - rowTop) / Math.max(baseHeight, 1e-8);
      newContentY = newRowTop + offsetRatio * newHeight;
      foundAnchor = true;
      break;
    }
  }
  if (!foundAnchor) {
    const last = rowTops.length - 1;
    const rowBottom = rowTopAt(last, baseHeight) + baseHeight;
    const newRowTop = rowTopAt(last, newHeight);
    newContentY = newRowTop + newHeight + (contentY - rowBottom);
  }
  return headerHeight + newContentY - cursorY;
}

export function zoomHeightAtCursor(
  rowTops, curHeight, baseHeight, delta, cursorY, scrollTop, headerHeight
) {
  // reference: MainViewer.tsx:483-489 (delta scaled by baseHeight/1000)
  const newHeight = calcZoomedHeight(baseHeight, (delta * baseHeight) / 1000);
  const newScrollTop = calcScrollTopAtCursor(
    rowTops, curHeight, baseHeight, newHeight, cursorY, scrollTop, headerHeight
  );
  if (newScrollTop === null) return null;
  return { height: newHeight, scrollTop: newScrollTop };
}

// ---------------------------------------------------------------------------
// follow-playhead / select-cursor auto-scroll — reference MainViewer.tsx:853-871

export function followPlayheadStartSec(positionSec, startSec, endSec) {
  // reference: MainViewer.tsx:855-862 — scroll only when the playhead
  // leaves the view; the new view STARTS at the playhead.
  if (positionSec === null) return null;
  if (endSec < positionSec || startSec > positionSec) return positionSec;
  return null;
}

export function selectSecAutoScroll(selectSec, prevSelectSec, startSec, endSec, width, pxPerSec) {
  // reference: MainViewer.tsx:864-871 — paused: shift the view by the
  // select-cursor delta; recenter when the shifted view still misses it.
  const diff = selectSec - prevSelectSec;
  if (Math.abs(diff) <= 1e-6 || (endSec >= selectSec && startSec <= selectSec)) {
    return null;
  }
  let newStartSec = startSec + diff;
  const newEndSec = endSec + diff;
  if (newEndSec < selectSec || newStartSec > selectSec) {
    newStartSec = selectSec - width / pxPerSec / 2;
  }
  return newStartSec;
}

export function playerPosition(anchor, nowMs) {
  // reference: usePlayer.ts:44-52 — rAF extrapolation from the last event
  return anchor.isPlaying
    ? anchor.positionSec + (nowMs - anchor.at) / 1000
    : anchor.positionSec;
}

export function clampSelectSec(sec, maxSec) {
  // reference: usePlayer.ts:37-39 — select cursor / seek clamp
  return Math.min(Math.max(sec, 0), maxSec);
}

export const TRACK_SWITCH_SEEK_TTL_MS = 1000;

export function playingTrackStartSec(pendingSeek, nowMs, anchor, selectSec, maxSec) {
  // reference: usePlayer.ts:92-110 — start position when the player follows
  // a selection change onto a new track: an explicit seek issued within the
  // last TRACK_SWITCH_SEEK_TTL_MS wins; otherwise the live playing position;
  // otherwise the paused select cursor.  Clamped to [0, maxSec].
  const usePending =
    pendingSeek !== null && pendingSeek !== undefined &&
    nowMs - pendingSeek.atMs <= TRACK_SWITCH_SEEK_TTL_MS;
  let startSec = usePending ? pendingSeek.sec : selectSec;
  if (!usePending && anchor.isPlaying) {
    startSec = anchor.positionSec + Math.max(0, nowMs - anchor.at) / 1000;
  }
  return clampSelectSec(startSec, maxSec);
}

export function jumpTargetSec(isPlaying, positionSec, selectSec, jumpSec, maxSec) {
  // reference: usePlayer.ts:141-147 — comma/period jump: seeks the player
  // while playing, moves the select cursor while paused.
  if (isPlaying) {
    return { seekSec: clampSelectSec(positionSec + jumpSec, maxSec), selectSec: null };
  }
  return { seekSec: null, selectSec: clampSelectSec(selectSec + jumpSec, maxSec) };
}

export function arrowPanStartSec(startSec, pxPerSec, dirRight, big) {
  // reference: MainViewer.tsx:680-690 + constants/tracks.ts:14-15 —
  // left/right arrows pan the lens by 40 css px (200 with shift)
  const shiftSec = (big ? 200 : 40) / pxPerSec;
  return startSec + (dirRight ? shiftSec : -shiftSec);
}

// ---------------------------------------------------------------------------
// selection with pivot semantics — reference useSelectedTracks.ts:5-126.
// selection state is an ORDERED array (insertion order drives pivot rules).

// ascending order (reference: constants/tracks.ts:5 SUPPORTED_TYPES)
export const SUPPORTED_TYPES = [
  "aac", "flac", "m4a", "mp3", "oga", "ogg", "opus", "wav",
];

export function splitSupportedPaths(paths) {
  // reference: App.tsx:85-92 — dropped paths split by raw (case-sensitive)
  // extension against SUPPORTED_TYPES; no extension -> unsupported
  const supported = [];
  const unsupported = [];
  for (const path of paths) {
    const extension = path.split(".").pop();
    if (extension && SUPPORTED_TYPES.includes(extension)) supported.push(path);
    else unsupported.push(path);
  }
  return { supported, unsupported };
}

export function fileDropIndex(clientY, trackTops, trackHeights) {
  // reference: MainViewer.tsx:175-189 calculateDropIndex — the first track
  // whose vertical midpoint is below the cursor; past-the-end otherwise
  let dropIndex = trackTops.length;
  for (let i = 0; i < trackTops.length; i++) {
    if (clientY >= trackTops[i] + trackHeights[i] / 2) continue;
    dropIndex = i;
    break;
  }
  return dropIndex;
}

export function zoomStepDelta(base, isZoomOut) {
  // reference: MainViewer.tsx:714-717,736-738 — the menu/hotkey zoom step
  // is 2^(floor(log2(base)) - 1.2) of the current height / pxPerSec,
  // negated when zooming out
  const delta = 2 ** (Math.floor(Math.log2(base)) - 1.2);
  return isZoomOut ? -delta : delta;
}

export function zoomLensAtSelect(cursor, selectSec, isZoomOut, maxTrackSec, width) {
  // reference: MainViewer.tsx:735-755 — mod+left/right time zoom anchored
  // at the SELECT cursor (0 when none), through the normalize pipeline
  const pxPerSec = normalizePxPerSec(
    cursor.pxPerSec + zoomStepDelta(cursor.pxPerSec, isZoomOut),
    0, maxTrackSec, width
  );
  const startSec = normalizeStartSec(
    selectSec - ((selectSec - cursor.startSec) * cursor.pxPerSec) / pxPerSec,
    pxPerSec, maxTrackSec, width
  );
  return { startSec, pxPerSec };
}

export function freqZoomScrollTop(baseHeight, newHeight, scrollTop, splitViewHeight, rowCount) {
  // reference: MainViewer.tsx:691-721 — the menu/mod+up/down height zoom
  // keeps the CONTENT MIDDLE stable in row space (uniform row heights:
  // the row under the middle keeps its fractional offset)
  if (rowCount <= 0) return null;
  const contentMiddle = scrollTop + splitViewHeight / 2;
  let rowIndex = Math.floor(contentMiddle / Math.max(baseHeight, 1e-8));
  rowIndex = Math.min(Math.max(rowIndex, 0), rowCount - 1);
  const offsetInRow = contentMiddle - rowIndex * baseHeight;
  const newOffsetInRow = (offsetInRow / Math.max(baseHeight, 1e-8)) * newHeight;
  return rowIndex * newHeight + newOffsetInRow - splitViewHeight / 2;
}

export function nextTrackOnArrow(displayIds, selectedIds, isDown) {
  // reference: MainViewer.tsx:783-795 — up/down move relative to the MOST
  // RECENTLY selected track (last element), clamped at the list ends; an
  // empty selection starts from index -1, so down lands on the first track
  if (!displayIds.length) return null;
  const recentIdx = displayIds.indexOf(selectedIds[selectedIds.length - 1]);
  return isDown
    ? displayIds[Math.min(recentIdx + 1, displayIds.length - 1)]
    : displayIds[Math.max(recentIdx - 1, 0)];
}

export function selectTrack(selected, pivotId, id, trackIds, mods) {
  // reference: useSelectedTracks.ts:13-63; mods: {command, shift}
  if (mods.command) {
    const idx = selected.indexOf(id);
    if (idx === -1) {
      return { selected: selected.concat([id]), pivotId: id, isAdded: true };
    }
    if (selected.length === 1) return { selected, pivotId, isAdded: false };
    const newSelected = selected.slice(0, idx).concat(selected.slice(idx + 1));
    return {
      selected: newSelected,
      pivotId: pivotId === id ? newSelected[newSelected.length - 1] : pivotId,
      isAdded: false,
    };
  }
  if (mods.shift) {
    if (id === selected[selected.length - 1]) {
      return { selected, pivotId, isAdded: false };
    }
    const indexOfId = trackIds.indexOf(id);
    const indexOfPivot = trackIds.indexOf(pivotId);
    // keep everything selected up to (and incl.) the pivot, drop after-pivot
    // shift-adds, then add pivot+1..id (reversed when selecting upward)
    let newSelected = selected.slice(0, selected.indexOf(pivotId) + 1);
    let addingIds;
    if (indexOfId > indexOfPivot) {
      addingIds = trackIds.slice(indexOfPivot + 1, indexOfId + 1);
    } else {
      addingIds = trackIds.slice(indexOfId, indexOfPivot).reverse();
    }
    newSelected = newSelected
      .filter((sid) => !addingIds.includes(sid))
      .concat(addingIds);
    return { selected: newSelected, pivotId, isAdded: addingIds.length > 0 };
  }
  if (selected.length === 1 && selected[0] === id) {
    return { selected, pivotId, isAdded: false };
  }
  return { selected: [id], pivotId: id, isAdded: true };
}

export function selectAllTracks(selected, trackIds) {
  // reference: useSelectedTracks.ts:66-75 (no-op when already all selected)
  if (
    trackIds.length === selected.length &&
    trackIds.every((id) => selected.includes(id))
  ) {
    return null;
  }
  return { selected: trackIds.slice(), pivotId: trackIds[trackIds.length - 1] };
}

export function selectAfterAddTracks(prevTrackIds, newTrackIds) {
  // reference: useSelectedTracks.ts:77-80 — select exactly the new tracks
  const newSelected = newTrackIds.filter((id) => !prevTrackIds.includes(id));
  if (newSelected.length === 0) return null;
  return { selected: newSelected, pivotId: newSelected[newSelected.length - 1] };
}

export function selectAfterRemoveTracks(prevTrackIds, newTrackIds, selected, pivotId) {
  // reference: useSelectedTracks.ts:82-113 — keep survivors, else walk
  // outward from the previous pivot's position for the nearest survivor
  if (newTrackIds.length === 0) return { selected: [], pivotId: -1 };
  const survivors = selected.filter((id) => newTrackIds.includes(id));
  if (survivors.length > 0) {
    return {
      selected: survivors,
      pivotId: survivors.includes(pivotId)
        ? pivotId : survivors[survivors.length - 1],
    };
  }
  const prevIndexOfPivot = prevTrackIds.indexOf(pivotId);
  for (let i = 1; i < prevTrackIds.length; i += 1) {
    let id = prevTrackIds[prevIndexOfPivot - i];
    if (newTrackIds.includes(id)) return { selected: [id], pivotId: id };
    id = prevTrackIds[prevIndexOfPivot + i];
    if (newTrackIds.includes(id)) return { selected: [id], pivotId: id };
  }
  return { selected: [newTrackIds[0]], pivotId: newTrackIds[0] };
}

// ---------------------------------------------------------------------------
// freq axis — reference src-wasm/src/axis.rs:396-449 pos<->hz over the
// CURRENT hz range, and FreqAxis.tsx:30-195 three-zone drag + wheel.

export function freqPosToHz(freqScale, pos, height, hzLo, hzHi, maxTrackHz) {
  // reference: axis.rs freq_pos_to_hz (range upper bound clamps to the
  // track max; rel position measured from the BOTTOM of the axis)
  const hi = Math.min(hzHi, maxTrackHz);
  const rel = 1 - pos / height;
  if (freqScale === "Mel") {
    const melLo = melFromHz(hzLo);
    const melHi = melFromHz(hi);
    return melToHz(melLo + rel * (melHi - melLo));
  }
  return hzLo + rel * (hi - hzLo);
}

export function freqHzToPos(freqScale, hz, height, hzLo, hzHi, maxTrackHz) {
  // reference: axis.rs freq_hz_to_pos
  const hi = Math.min(hzHi, maxTrackHz);
  let rel;
  if (freqScale === "Mel") {
    const melLo = melFromHz(hzLo);
    const melHi = melFromHz(hi);
    rel = (melFromHz(hz) - melLo) / (melHi - melLo);
  } else {
    rel = (hz - hzLo) / (hi - hzLo);
  }
  return (1 - rel) * height;
}

export function freqAxisCursorState(cursorPos, rectHeight) {
  // reference: FreqAxis.tsx:30-34 — thirds: top edits max, middle shifts,
  // bottom edits min
  if (cursorPos < rectHeight / 3) return "control-max-hz";
  if (cursorPos < (rectHeight * 2) / 3) return "shift-hz-range";
  return "control-min-hz";
}

export function clampMaxHz(maxHz, minHz, maxTrackHz) {
  // reference: FreqAxis.tsx:63-66 — above the track max means "full range"
  if (maxHz > maxTrackHz) return Infinity;
  return Math.max(maxHz, minHz + MIN_HZ_RANGE);
}

export function clampMinHz(minHz, maxHz) {
  // reference: FreqAxis.tsx:67-69
  return Math.min(Math.max(minHz, 0), maxHz - MIN_HZ_RANGE);
}

export function freqMaxDrag(anchor, cursorAxisPos, axisHeight, freqScale, maxTrackHz) {
  // reference: FreqAxis.tsx:105-125 ("control-max-hz"): scale the relative
  // frequency under the anchor by the cursor travel ratio
  const [lo, hi] = anchor.hzRange;
  const anchorRelFreq = 1 - anchor.cursorAxisPos / axisHeight;
  const cursorRelFreq = Math.max(1 - cursorAxisPos / axisHeight, 0);
  const newMaxRelFreq = anchorRelFreq / cursorRelFreq;
  const newMaxAxisPos = (1 - newMaxRelFreq) * axisHeight;
  const maxHz = freqPosToHz(freqScale, newMaxAxisPos, axisHeight, lo, hi, maxTrackHz);
  return [lo, clampMaxHz(maxHz, lo, maxTrackHz)];
}

export function freqMinDrag(anchor, cursorAxisPos, freqScale, maxTrackHz) {
  // reference: FreqAxis.tsx:126-133 ("control-min-hz"): re-interpret the
  // anchor position against an axis that now ends at the cursor
  const [lo, hi] = anchor.hzRange;
  const minHz = freqPosToHz(
    freqScale, anchor.cursorAxisPos, Math.max(cursorAxisPos, 1), lo, hi, maxTrackHz
  );
  return [clampMinHz(minHz, hi), hi];
}

export function freqShiftDrag(anchor, cursorAxisPos, axisHeight, freqScale, maxTrackHz) {
  // reference: FreqAxis.tsx:134-168 ("shift-hz-range"): slide the window in
  // axis-position space, clamped between 0 Hz and the track max; sliding
  // past both ends resets to the full range (returned as [0, Infinity])
  const [lo, hi] = anchor.hzRange;
  const shift = anchor.cursorAxisPos - cursorAxisPos;
  let minHzPos = axisHeight + shift;
  let maxHzPos = shift;
  const zeroHzPos = anchor.zeroHzPos ?? axisHeight;
  const maxTrackHzPos = anchor.maxTrackHzPos ?? 0;
  if (minHzPos > zeroHzPos) {
    maxHzPos -= minHzPos - zeroHzPos;
    minHzPos = zeroHzPos;
  }
  if (maxHzPos < maxTrackHzPos) {
    minHzPos += maxTrackHzPos - maxHzPos;
    maxHzPos = maxTrackHzPos;
  }
  if (minHzPos > zeroHzPos) return [0, Infinity];
  return [
    freqPosToHz(freqScale, minHzPos, axisHeight, lo, hi, maxTrackHz),
    freqPosToHz(freqScale, maxHzPos, axisHeight, lo, hi, maxTrackHz),
  ];
}

export function freqWheelMaxHz(hzRange, deltaY, freqScale, maxTrackHz) {
  // reference: FreqAxis.tsx:178-195 (alt+wheel: deltaY read as a position
  // on a fixed 500px-tall virtual axis)
  const maxHz = freqPosToHz(freqScale, deltaY, 500, hzRange[0], hzRange[1], maxTrackHz);
  return [hzRange[0], clampMaxHz(maxHz, hzRange[0], maxTrackHz)];
}

export function zoomFreqRangeAt(hzRange, maxHz, freqScale, factor, anchorFrac) {
  // repo freq-range zoom (menu freq-zoom-in/out analogue, menu.rs:427-445)
  // in max-relative position space; a full-range result resets to null
  const lo0 = hzRange ? hzRange[0] : 0;
  const hi0 = hzRange ? hzRange[1] : maxHz;
  const pLo = relativeFreqPos(lo0, maxHz, freqScale);
  const pHi = relativeFreqPos(hi0, maxHz, freqScale);
  const span = pHi - pLo;
  const anchor = pLo + anchorFrac * span;
  const newSpan = Math.min(Math.max(span * factor, 0.01), 1);
  let lo = anchor - anchorFrac * newSpan;
  let hi = lo + newSpan;
  if (lo < 0) { hi -= lo; lo = 0; }
  if (hi > 1) { lo -= hi - 1; hi = 1; }
  if (lo <= 1e-9 && hi >= 1 - 1e-9) return null;
  return [
    hzFromRelativePos(lo, maxHz, freqScale),
    hzFromRelativePos(hi, maxHz, freqScale),
  ];
}

// ---------------------------------------------------------------------------
// amp axis — reference AmpAxis.tsx:42-108 (zero-ratio anchored drag)

export function calcIntervalZeroRatio(ampRange) {
  // reference: AmpAxis.tsx:42-46
  const interval = ampRange[1] - ampRange[0];
  return [interval, ampRange[1] / interval];
}

export function clampAmpRange(ampRange) {
  // reference: AmpAxis.tsx:47-53
  return [
    Math.min(Math.max(ampRange[0], -MAX_ABS_AMP_RANGE), -MIN_ABS_AMP_RANGE),
    Math.min(Math.max(ampRange[1], MIN_ABS_AMP_RANGE), MAX_ABS_AMP_RANGE),
  ];
}

export function limitAmpCursorRatio(cursorState, cursorRatio, ampRange) {
  // reference: AmpAxis.tsx:60-71 — the cursor may not cross 0
  const [, zeroRatio] = calcIntervalZeroRatio(ampRange);
  if (cursorState === "positive") {
    return Math.min(cursorRatio, zeroRatio - MIN_DIST_FROM_0_FOR_DRAG);
  }
  return Math.max(cursorRatio, zeroRatio + MIN_DIST_FROM_0_FOR_DRAG);
}

export function ampAxisCursorState(cursorPos, rectHeight) {
  // reference: AmpAxis.tsx:31-34
  return cursorPos < rectHeight / 2 ? "positive" : "negative";
}

export function ampDrag(cursorState, cursorRatio, anchor) {
  // reference: AmpAxis.tsx:84-96 — the amp value grabbed at the anchor
  // follows the cursor; interval rescales around the zero line
  const { cursorRatio: anchorRatio, ampRange: anchorAmpRange } = anchor;
  const [anchorInterval, zeroRatio] = calcIntervalZeroRatio(anchorAmpRange);
  const limited = limitAmpCursorRatio(cursorState, cursorRatio, anchorAmpRange);
  const newInterval =
    (anchorInterval * (anchorRatio - zeroRatio)) / (limited - zeroRatio);
  return clampAmpRange([newInterval * (zeroRatio - 1), newInterval * zeroRatio]);
}

export function ampWheel(ampRange, deltaY) {
  // reference: AmpAxis.tsx:98-108 (alt+wheel zoom around the zero line)
  const [interval, zeroRatio] = calcIntervalZeroRatio(ampRange);
  const newInterval = interval * Math.max(1 - deltaY / 500, 0);
  return clampAmpRange([newInterval * (zeroRatio - 1), newInterval * zeroRatio]);
}

// ---------------------------------------------------------------------------
// overview lens — reference Overview.tsx:109-183

export function adjacentAxisPosition(axisPosition, axisLength) {
  // reference: wasm-wrapper.ts:120-131 — the 1-px neighbor used to derive
  // the tooltip's value resolution, stepping inward at the axis edges
  return axisPosition <= axisLength / 2
    ? Math.min(axisPosition + 1, axisLength)
    : Math.max(axisPosition - 1, 0);
}

export function linearPosToValue(pos, axisLength, topValue, bottomValue) {
  // reference: AmpAxis.tsx:123-130 / ColorMap.tsx:53-63 — top-down linear
  // axis value at a pixel position
  return topValue - (pos / axisLength) * (topValue - bottomValue);
}

export function tickUnitFromValues(tickValues) {
  // reference: wasm-wrapper.ts:141-147 — first positive gap between
  // adjacent finite tick values (NaN when none)
  const finite = tickValues.filter((v) => Number.isFinite(v));
  for (let i = 1; i < finite.length; i++) {
    const unit = Math.abs(finite[i] - finite[i - 1]);
    if (unit > 0) return unit;
  }
  return NaN;
}

export function linearTooltipArgs(pos, axisLength, topValue, bottomValue, markers) {
  // reference: wasm-wrapper.ts:120-148 composed for a top-down linear axis
  // (amp axis, dB colorbar): value at the cursor, 1-px resolution, and the
  // tick unit of the currently drawn markers ([ratio, label] pairs)
  const value = linearPosToValue(pos, axisLength, topValue, bottomValue);
  const adj = adjacentAxisPosition(pos, axisLength);
  const resolution =
    Math.abs(linearPosToValue(adj, axisLength, topValue, bottomValue) - value);
  const ticks = markers.map(([r]) => linearPosToValue(
    Math.min(Math.max(r * axisLength, 0), axisLength),
    axisLength, topValue, bottomValue
  ));
  return { value, resolution, tickUnit: tickUnitFromValues(ticks) };
}

export function timeTooltipDisplay(formatDisplay) {
  // reference: TimeAxis.tsx:79-90 — extend the axis label format by one
  // fractional digit; plain seconds formats get a " s" suffix
  const display = formatDisplay.includes(".")
    ? `${formatDisplay}x` : `${formatDisplay}.x`;
  return { display, appendSeconds: formatDisplay.startsWith("ss") };
}

export function freqTooltipLabel(label) {
  // reference: FreqAxis.tsx:214-221 — "12.3k" -> "12.3 kHz", else "… Hz"
  return label.endsWith("k") ? `${label.slice(0, -1)} kHz` : `${label} Hz`;
}

export function freqTooltipArgs(freqScale, pos, axisLength, hzLo, hzHi, maxTrackHz) {
  // reference: wasm-wrapper.ts:150-158 — getValueAndResolution over the
  // freq-scale position mapping (FreqAxis.tsx:214-220's getValue)
  const hz = freqPosToHz(freqScale, pos, axisLength, hzLo, hzHi, maxTrackHz);
  const adj = adjacentAxisPosition(pos, axisLength);
  const adjHz = freqPosToHz(freqScale, adj, axisLength, hzLo, hzHi, maxTrackHz);
  return { hz, resolutionHz: Math.abs(adjHz - hz) };
}

export function overviewSecFromX(cursorX, rectWidth, maxTrackSec) {
  // reference: Overview.tsx:109-112
  return (cursorX / rectWidth) * maxTrackSec;
}

export function overviewCursorState(cursorX, startSec, lensDurationSec, pxPerSec) {
  // reference: Overview.tsx:158-173 (LENS_THICKNESS px hit zones on the
  // rounded lens edge positions)
  const lensStartX = Math.round(startSec * pxPerSec);
  const lensEndX = Math.round((startSec + lensDurationSec) * pxPerSec);
  if (lensStartX - LENS_THICKNESS <= cursorX && cursorX <= lensStartX + LENS_THICKNESS) {
    return "left";
  }
  if (lensStartX + LENS_THICKNESS < cursorX && cursorX < lensEndX - LENS_THICKNESS) {
    return "inlens";
  }
  if (lensEndX - LENS_THICKNESS <= cursorX && cursorX <= lensEndX + LENS_THICKNESS) {
    return "right";
  }
  return "outlens";
}

export function overviewDragAnchor(cursorState, cursorX, rectWidth, maxTrackSec, startSec, lensDurationSec) {
  // reference: Overview.tsx:175-183 — grabbing inside the lens anchors the
  // grab fraction; everywhere else the lens centers on the cursor
  if (cursorState === "inlens") {
    const sec = overviewSecFromX(cursorX, rectWidth, maxTrackSec);
    return (sec - startSec) / lensDurationSec;
  }
  return 0.5;
}

export function overviewWaveLevel(sampleCount, width) {
  // whole-track strip: one bin per CSS px (overview.js; equivalent to the
  // reference feeding pxPerSec = width/maxTrackSec into waveformLevel,
  // OverviewWaveformViewport.tsx:396)
  return Math.max(0, Math.ceil(Math.log2(sampleCount / Math.max(width, 1))));
}

export const OVERVIEW_MAX_CH = 4; // constants/tracks.ts:211
export const OVERVIEW_CH_GAP_HEIGHT = 1; // OverviewWaveformViewport.tsx:19
export const OVERVIEW_GAIN_HEIGHT_RATIO = 0.2; // OverviewWaveformViewport.tsx:20

export function overviewLaneLayout(nCh, height, hasGain) {
  // reference: OverviewWaveformViewport.tsx:385-389,407-417 — stacked
  // per-channel lanes with 1 px gaps; when a limiter gain sequence exists
  // the gain band carves OVERVIEW_GAIN_HEIGHT_RATIO of the lane off the
  // top AND the bottom, squeezing the waveform between them
  const gap = OVERVIEW_CH_GAP_HEIGHT;
  const chHeight = (height - gap * Math.max(nCh - 1, 0)) / nCh;
  const gainHeight = hasGain ? chHeight * OVERVIEW_GAIN_HEIGHT_RATIO : 0;
  const lanes = [];
  for (let i = 0; i < nCh; i++) {
    lanes.push({
      y: i * (chHeight + gap) + gainHeight,
      height: chHeight - 2 * gainHeight,
      gainHeight,
    });
  }
  return lanes;
}

export function ampRangeFromBins(binsPerCh) {
  // reference: OverviewWaveformViewport.tsx:43-55 calcAmpRange — ONE amp
  // range shared by every lane, seeded at [-1, 1], widened by tile
  // min/max (flattened (min,max,mean) bin triplets here)
  let min = -1;
  let max = 1;
  for (const bins of binsPerCh) {
    const n = Math.floor(bins.length / 3);
    for (let i = 0; i < n; i++) {
      min = Math.min(min, bins[i * 3]);
      max = Math.max(max, bins[i * 3 + 1]);
    }
  }
  return [min, max];
}

export function overviewWavePoints(bins, lane, trackWidth, ampRange, clampValues) {
  // the overview's waveform fill polygon (reference: renderWaveformTiles
  // as called from OverviewWaveformViewport.tsx:453-480): max envelope
  // left→right then min envelope right→left over flattened (min,max,mean)
  // bin triplets, y mapped through the SHARED ampRange onto the lane.
  // clampValues mirrors the isClipped handling — the top (waveform-color)
  // pass clamps to ±1 so the unclamped clipping-color pass underneath
  // peeks out exactly where the signal saturates
  const n = Math.floor(bins.length / 3);
  const points = [];
  if (!n) return points;
  const span = Math.max(ampRange[1] - ampRange[0], 1e-8);
  const clamp = (v) => (clampValues ? Math.min(Math.max(v, -1), 1) : v);
  const toY = (v) => lane.y + ((ampRange[1] - clamp(v)) / span) * lane.height;
  for (let i = 0; i < n; i++) {
    points.push([(i / n) * trackWidth, toY(bins[i * 3 + 1])]);
  }
  for (let i = n - 1; i >= 0; i--) {
    points.push([(i / n) * trackWidth, toY(bins[i * 3])]);
  }
  return points;
}

export function calcLimiterGainEnvelopes(gainSeq, width, height, gainRange) {
  // reference-exact: OverviewWaveformViewport.tsx:57-111 — bins the gain
  // sequence into pixel columns (min gain per column), emitting one
  // closed polyline per contiguous sub-unity region; y maps gainRange
  // onto [height, 0] so unity gain sits at the band's top edge
  if (gainSeq.length === 0 || width <= 0 || height <= 0) return [];
  const xScale = width / gainSeq.length;
  const yScale = -height / Math.max(gainRange[1] - gainRange[0], 1e-8);
  const yOffset = -gainRange[1] * yScale;
  const gainToY = (value) => value * yScale + yOffset;
  const yUnityGain = gainToY(gainRange[1]);
  const envelopes = [];
  let current = [];
  let i = 0;
  while (i < gainSeq.length) {
    const x = i * xScale;
    const xFloor = Math.floor(x);
    const xMid = xFloor + 0.5;
    let i2 = i;
    let iNext = gainSeq.length;
    while (i2 < gainSeq.length) {
      const x2Floor = Math.floor(i2 * xScale);
      if (x2Floor > xFloor && iNext === gainSeq.length) iNext = i2;
      if (x2Floor > xFloor + 1) break;
      i2 += 1;
    }
    if (i2 === i) i2 = Math.min(i + 1, gainSeq.length);
    let minGain = Infinity;
    for (let j = i; j < i2; j += 1) {
      minGain = Math.min(minGain, gainSeq[j]);
    }
    const bottom = gainToY(minGain);
    if (bottom > yUnityGain) {
      if (current.length === 0) current.push([xFloor, yUnityGain]);
      current.push([xMid, bottom]);
    } else if (current.length > 0) {
      current.push([xFloor, yUnityGain]);
      envelopes.push(current);
      current = [];
    }
    i = iNext;
  }
  if (current.length > 0) {
    const lastX = (gainSeq.length - 1) * xScale;
    current.push([Math.floor(lastX) + 1, gainToY(gainSeq[gainSeq.length - 1])]);
    envelopes.push(current);
  }
  return envelopes;
}

export function colorbarColorIndex(y, height, colormapLength) {
  // overview.js drawColorbar: top = max dB = colormap end; index 0 is the
  // reserved out-of-band black (render_tiles.rs colormap layout, 258
  // entries = black + inferno-256 + white)
  return Math.min(
    colormapLength - 1,
    1 + Math.round(((height - 1 - y) / Math.max(height - 1, 1)) * (colormapLength - 2))
  );
}

// ---------------------------------------------------------------------------
// control panel — reference FloatRangeInput.tsx + Control.tsx

export const MIN_WIN_MILLISEC = 1.0; // constants/tracks.ts:205
// the engine's network-entry cap (session.set_spec_setting): committing
// above it would 400 and strand the panel with a value every later
// applySpec() re-sends — clamp client-side like the MIN bound
export const MAX_WIN_MILLISEC = 2000.0;
export const MIN_COMMON_NORMALIZE_DB = -40.0; // constants/tracks.ts:196
// DB_RANGE_DETENTS[len-2] is the double-click reset (Control.tsx:302)
export const DB_RANGE_DBLCLICK = 100.0;
// per-family target memory seeds (Control.tsx:63-68): PeakdB inits 0.0;
// the shared LUFS/RMSdB memory inits -18.0 and is seeded from a persisted
// normalize only when its type is exactly LUFS
export const NORMALIZE_PEAK_DEFAULT_DB = 0.0;
export const NORMALIZE_DB_DEFAULT = -18.0;

export function floatRangeTextCommit(text, rangeValue, prevValue, min, max) {
  // reference: FloatRangeInput.tsx:104-121 (onTextBlur) — garbage text
  // falls back to the slider value, then to the pre-focus value; the
  // clamped result commits only when it differs from the pre-focus value
  let value = parseFloat(text);
  if (Number.isNaN(value)) {
    value = parseFloat(rangeValue);
    if (Number.isNaN(value)) value = prevValue;
  }
  const clamped = Math.min(Math.max(value, min), max);
  return { value: clamped, changed: clamped !== prevValue };
}

export function floatRangeResetClick(button, detail, altKey) {
  // reference: FloatRangeInput.tsx:83-87 / Control.tsx:80-87 (onBlendClick)
  // — primary-button double-click, or alt + single-click, resets
  return button === 0 && (detail === 2 || (detail === 1 && altKey));
}

export function winMillisecCommit(text, currentWinMillisec) {
  // reference: Control.tsx:97-110 — null (editing cancelled / unchanged)
  // restores the current value; < 1 ms clamps to MIN_WIN_MILLISEC.  The
  // reference forwards a NaN parse to the backend where it fails
  // validation and the setting stays unchanged; restoring the display
  // directly reaches the same end state without the failed round-trip.
  const restore = { set: null, display: currentWinMillisec.toFixed(1) };
  if (text === null) return restore;
  const winMillisec = parseFloat(text);
  // the reference forwards NaN/±Infinity to the backend where SpecSetting
  // validation rejects them and the setting stays unchanged; restoring the
  // display directly reaches the same end state without the failed trip
  if (!Number.isFinite(winMillisec)) return restore;
  if (winMillisec < 1) {
    return { set: MIN_WIN_MILLISEC, display: MIN_WIN_MILLISEC.toFixed(1) };
  }
  if (winMillisec > MAX_WIN_MILLISEC) {
    return { set: MAX_WIN_MILLISEC, display: MAX_WIN_MILLISEC.toFixed(1) };
  }
  return { set: winMillisec, display: winMillisec.toFixed(1) };
}

export function channelLabel(nCh, ch) {
  // reference: constants/tracks.ts:8-12 (CHANNEL) via TrackInfo.tsx:85-88 —
  // mono "M", stereo "L"/"R".  The reference's `CHANNEL[nCh][ch] || ""`
  // has no table rows past stereo (indexing would throw there); every
  // out-of-table channel is labeled "" here.
  if (nCh === 1 && ch === 0) return "M";
  if (nCh === 2 && ch === 0) return "L";
  if (nCh === 2 && ch === 1) return "R";
  return "";
}

export function normalizeSelectTarget(type, peakMem, dbMem) {
  // reference: Control.tsx:118-143 — each normalize family remembers its
  // own last target: PeakdB separately (init 0.0), LUFS/RMSdB shared
  // (init -18.0)
  if (type === "Off") return { type: "Off" };
  if (type === "PeakdB") return { type, target: peakMem };
  return { type, target: dbMem };
}

// ---------------------------------------------------------------------------
// misc app formulas

export function fitPxPerSec(width, maxSec) {
  // fit mode: whole longest track in view (MainViewer fit semantics via
  // updateLensParams' isFit detection)
  return Math.max(width / Math.max(maxSec, 1e-8), 1e-8);
}

export function splitterWidth(startW, dx) {
  // info-pane splitter clamp (SplitView.tsx:30-211 analogue)
  return Math.min(Math.max(startW + dx, 90), 480);
}

export function scrubSecAt(clientX, rectLeft, startSec, pxPerSec) {
  // playhead scrub: cursor x -> clamped seconds
  return Math.max(startSec + (clientX - rectLeft) / pxPerSec, 0);
}

export function jumpAmountSec(big) {
  // reference: player.rs:20-21 via menu jump-player events
  return big ? PLAY_BIG_JUMP_SEC : PLAY_JUMP_SEC;
}

export function srKhzLabel(sr) {
  // reference: TrackSummary.tsx:19 `${sampleRate / 1000} kHz` — plain JS
  // number→string, so 22050 renders "22.05" (not a fixed precision)
  return `${sr / 1000}`;
}

export function trackMetaLine(formatName, bitDepth, bitrate, sr) {
  // reference: TrackSummary.tsx:159-165 — "format | bitDepth | bitrate |
  // rate kHz"; the bitDepth/bitrate segments render only when non-empty
  const parts = [formatName];
  if (bitDepth) parts.push(bitDepth);
  if (bitrate) parts.push(bitrate);
  parts.push(`${srKhzLabel(sr)} kHz`);
  return parts.join(" | ");
}

export function nonFiniteNumberLabel(value) {
  // reference: axis.rs:525-533 format_non_finite_float — ±∞ as the
  // unicode infinity sign, anything else non-finite as "nan"
  if (value === Infinity) return "+∞";
  if (value === -Infinity) return "-∞";
  return "nan";
}

export function lufsLabel(formatted) {
  // reference: TrackSummary.tsx:12,20 — `${formatNumberLabel(lufs, 2)}
  // LUFS`; the number itself is formatted by the backend axis command
  // (Rust {:.2} half-even, -∞ for silence), exactly the WASM call the
  // reference makes client-side
  return `${formatted} LUFS`;
}

// ---------------------------------------------------------------------------
// remote audio scheduling (viewer/js/audioplayer.js Web Audio last hop).
// The reference plays through an in-process cpal callback on the user's
// machine (reference: src-tauri/src/player/stream.rs:501-639; cursor-version
// resampler resets :110); the service deployment's user machine is the
// browser, so the AudioContext clock paces PCM pulls from the engine.

export const AUDIO_CHUNK_FRAMES = 4096; // ~85 ms at 48 kHz per pull
export const AUDIO_BUFFER_AHEAD_SEC = 0.35; // scheduled-ahead target
export const AUDIO_MIN_LEAD_SEC = 0.06; // safety lead on (re)start/underrun
export const AUDIO_MAX_PULLS_PER_TICK = 4; // bounds one pump's burst
export const AUDIO_PUMP_INTERVAL_MS = 120; // steady-state pump cadence

export function audioChunkStartTime(nextStartTime, ctxTime, minLeadSec) {
  // underrun policy: if the scheduled frontier fell behind the context
  // clock (slow pull, tab throttled), restart with a small safety lead —
  // an audible gap, never an overlap (matches the device-stream behavior:
  // late callbacks drop time, they don't replay it)
  return Math.max(nextStartTime, ctxTime + minLeadSec);
}

export function audioPullCount(nextStartTime, ctxTime, bufferAheadSec, chunkDurSec, maxPulls) {
  // how many fixed-size chunks to pull NOW to restore the buffer-ahead
  // target, bounded so one pump can't burst unboundedly after a stall
  const deficit = bufferAheadSec - (nextStartTime - ctxTime);
  if (deficit <= 0 || chunkDurSec <= 0) return 0;
  return Math.min(maxPulls, Math.max(1, Math.ceil(deficit / chunkDurSec)));
}

export function audioCursorReset(version, seenVersion) {
  // a server-side seek/track-switch bumped cursor_version: everything
  // already scheduled is pre-seek audio and must be flushed
  // (reference: stream.rs:110 reset_for_cursor)
  return seenVersion !== null && version !== seenVersion;
}

export function deinterleavePcm(pcm, channels, nFrames, channel) {
  // wire chunks are interleaved frames; AudioBuffer wants one lane per
  // channel.  Values are already f32 so the copy is exact.
  const lane = new Float32Array(nFrames);
  for (let i = 0; i < nFrames; i++) lane[i] = pcm[i * channels + channel];
  return lane;
}

export function fmtTime(sec) {
  // transport time display HH:MM:SS.mmm, floor-to-ms (axis.rs
  // seconds_to_label convention)
  if (!isFinite(sec) || sec < 0) sec = 0;
  const h = Math.floor(sec / 3600);
  const m = Math.floor(sec / 60) % 60;
  const s = Math.floor(sec) % 60;
  const ms = Math.floor((sec % 1) * 1000);
  return `${String(h).padStart(2, "0")}:${String(m).padStart(2, "0")}:` +
    `${String(s).padStart(2, "0")}.${String(ms).padStart(3, "0")}`;
}
