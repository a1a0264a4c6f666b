// Main viewer app: track rows, zoom/pan state, controls, playback,
// multi-select, DnD reorder, editable axis ranges, fit/follow modes.
// State model follows the reference MainViewer (startSec, pxPerSec, hzRange,
// ampRange, fit mode, follow-playhead; cursor-anchored zoom both axes) —
// src/prototypes/MainViewer/MainViewer.tsx:92-1258, selection semantics
// src/hooks/useSelectedTracks.ts:5-126, SplitView src/modules/SplitView.tsx.

import { api, jsonNumber } from "./api.js";
import { createAudioPlayer } from "./audioplayer.js";
import { Compositor, TrackViewport } from "./viewport.js";
import {
  lastAxisMarkers, timeTickParams, updateAmpAxis, updateFreqAxis, updateTimeAxis,
} from "./axes.js";
import { Overview, drawColorbar } from "./overview.js";
// ALL pure interaction math lives in applogic.js (executed Python twins in
// viewer/twin_app.py golden-test it against the reference formulas); this
// file only wires DOM events to it.
import * as L from "./applogic.js";

const state = {
  trackIds: [], // display order (DnD reorder permutes this)
  nextId: 0,
  viewports: new Map(), // idChStr -> TrackViewport
  startSec: 0,
  pxPerSec: 100,
  blend: 0.5,
  maxSec: 0,
  maxTrackHz: 0,
  hzRange: null, // null -> full [0, maxTrackHz]
  ampRanges: new Map(), // trackId -> [min, max] (reference AmpAxis.tsx)
  freqScale: "Mel",
  dbRange: null, // [minDb, maxDb] as drawn on the colorbar (tooltip source)
  rowHeight: 160, // height-zoomable (reference MainViewer.tsx:414-489)
  playing: false,
  playerAnchor: { positionSec: 0, at: performance.now(), isPlaying: false },
  currentPlayingTrack: -1, // usePlayer.ts:27 — track loaded into the player
  pendingSeek: null, // {sec, atMs} — usePlayer.ts:34-35 seek TTL for track switch
  erroredTracks: [], // reload-failed ids (reference useTracks.ts:30,122-133)
  selected: [], // ORDERED ids (reference useSelectedTracks.ts pivot rules)
  selectPivot: -1,
  selectedTrack: null, // primary (playback) selection
  fitMode: false,
  followPlayhead: true,
  needFollowCursor: true, // cleared by user pan/zoom while playing
  prevSelectSec: 0,
  needsRedraw: true,
};

const $ = (sel) => document.querySelector(sel);
const rowsEl = $("#rows");
// ONE canvas composites all visible rows (reference: single PixiJS WebGL
// canvas, AudioTrackViewport.tsx:93+); scrolling/resizing just repaints it
const compositor = new Compositor($("#compositor"), rowsEl);
rowsEl.addEventListener("scroll", () => { state.needsRedraw = true; });
window.addEventListener("resize", () => { state.needsRedraw = true; });
let overview = null;
let colormapRgba = null;

// width of everything left of a row's viewport: info pane + splitter
// slot (8) + ch-label (14) + amp axis (45) + freq axis (45).  MUST match
// style.css --left-off and the .ch-label/.amp-axis/.freq-axis widths —
// omitting the ch-label misaligned the time axis, overview, zoom anchor
// and fit width by 14px (review finding)
const LEFT_FIXED_PX = 8 + 14 + 45 + 45;

function leftOffset() {
  const infoW = parseFloat(
    getComputedStyle(document.documentElement).getPropertyValue("--info-w")
  ) || 200;
  return infoW + LEFT_FIXED_PX;
}

function viewWidth() {
  return Math.max(rowsEl.clientWidth - leftOffset(), 50);
}

function hzRangeOrFull() {
  return state.hzRange || [0, state.maxTrackHz || 1];
}

// cursor/center-anchored freq-range zoom (math in applogic.js; the menu
// freq-zoom-in/out analogue, menu.rs:427-445)
function zoomFreqRangeAt(factor, anchorFrac) {
  state.hzRange = L.zoomFreqRangeAt(
    state.hzRange, state.maxTrackHz || 1, state.freqScale, factor, anchorFrac
  );
}

// a freq-range result from the FreqAxis interactions: hi === Infinity (or
// the track max) means "reset to full" = null in our state
function setHzRangeResult(range) {
  state.hzRange =
    range[1] === Infinity || (range[0] <= 0 && range[1] >= (state.maxTrackHz || 1))
      ? null : [range[0], range[1]];
}

function ampRangeOf(trackId) {
  return state.ampRanges.get(trackId) ?? [-1.0, 1.0];
}

// every lens (startSec, pxPerSec) change funnels through the reference's
// normalize pipeline (MainViewer.tsx:373-392 via applogic.updateLensParams)
function setLens(params, turnOffFollowCursor = true) {
  if (state.playing && turnOffFollowCursor) state.needFollowCursor = false;
  const out = L.updateLensParams(
    { startSec: state.startSec, pxPerSec: state.pxPerSec },
    params, state.maxSec, viewWidth()
  );
  state.startSec = out.startSec;
  state.pxPerSec = out.pxPerSec;
  return out;
}

// ---------------------------------------------------------------------------
// error box (reference: src/modules/ErrorBox + useTracks erroredTrackIds)

// Per-row errored state for reload failures (reference: useTracks.ts:122-133
// sets erroredTrackIds; MainViewer.tsx:1149-1163 overlays an ErrorBox with
// Reload / Ignore / Close on each errored row; App.tsx:71-73 keeps the
// player off an errored selection).
function setTrackErrored(trackId) {
  if (!state.erroredTracks.includes(trackId)) state.erroredTracks.push(trackId);
  for (const row of rowsEl.children) {
    if (Number(row.dataset.trackId) !== trackId) continue;
    if (row.querySelector(".track-error")) continue;
    const box = document.createElement("div");
    box.className = "track-error";
    const msg = document.createElement("span");
    msg.textContent = "The file cannot be read";
    box.appendChild(msg);
    const mk = (label, fn) => {
      const b = document.createElement("button");
      b.textContent = label;
      b.onclick = async (e) => {
        e.stopPropagation();
        await fn();
      };
      box.appendChild(b);
    };
    mk("Reload", async () => {
      const ok = await api.reloadTracks([trackId]);
      if (ok.includes(trackId)) clearTrackErrored(trackId);
      await refreshAll();
      await rebuildAllRowInfo();
      redraw();
    });
    mk("Ignore", () => clearTrackErrored(trackId));
    mk("Close", () => removeTracks([trackId]));
    row.querySelector(".viewport-wrap").appendChild(box);
  }
  syncPlayerToSelection();
}

function clearTrackErrored(trackId) {
  if (!state.erroredTracks.includes(trackId)) return;
  state.erroredTracks = state.erroredTracks.filter((x) => x !== trackId);
  for (const row of rowsEl.children) {
    if (Number(row.dataset.trackId) !== trackId) continue;
    row.querySelector(".track-error")?.remove();
  }
  syncPlayerToSelection();
}

function showError(message) {
  const box = $("#error-box");
  const item = document.createElement("div");
  item.className = "error-item";
  item.textContent = message;
  const x = document.createElement("button");
  x.textContent = "✕";
  x.onclick = () => item.remove();
  item.appendChild(x);
  box.appendChild(item);
  setTimeout(() => item.remove(), 15000);
}

// ---------------------------------------------------------------------------
// track management

async function addPaths(paths, insertIndex = null) {
  // dedupe against already-open paths (reference App.tsx:103-131)
  const fresh = [];
  const reload = [];
  for (const p of paths) {
    const existing = await api.findIdByPath(p);
    if (existing >= 0) reload.push(existing);
    else fresh.push(p);
  }
  if (reload.length) {
    // re-opening an already-open path reloads it; a read failure marks the
    // row errored (useTracks.ts:122-133 via App.tsx add flows)
    const ok = await api.reloadTracks(reload);
    for (const id of reload) {
      if (!ok.includes(id)) setTrackErrored(id);
      else clearTrackErrored(id);
    }
  }
  if (fresh.length) {
    const ids = fresh.map(() => state.nextId++);
    const prevIds = displayOrder();
    const added = await api.addTracks(ids, fresh);
    const failed = fresh.filter((_, i) => !added.includes(ids[i]));
    if (failed.length) showError(`Could not open: ${failed.join(", ")}`);
    await refreshAll();
    for (const id of added) await buildRow(id);
    // dropped files insert at the drop row (useTracks.ts:92-100 splice);
    // buildRow appended them, so move their rows before the anchor track
    if (insertIndex !== null && insertIndex < prevIds.length && added.length) {
      const anchorId = prevIds[insertIndex];
      const anchorRow = [...rowsEl.children].find(
        (r) => Number(r.dataset.trackId) === anchorId
      );
      if (anchorRow) {
        for (const row of [...rowsEl.children]) {
          if (added.includes(Number(row.dataset.trackId))) {
            rowsEl.insertBefore(row, anchorRow);
          }
        }
        state.trackIds = displayOrder();
      }
    }
    // select exactly the new tracks (useSelectedTracks.ts:77-80)
    applySelection(L.selectAfterAddTracks(prevIds, displayOrder()));
  } else {
    await refreshAll();
    await rebuildAllRowInfo();
  }
  fitIfFirst();
  redraw();
}

async function refreshAll() {
  await api.applyTrackListChanges();
  state.maxSec = await api.getLongestSec();
  state.maxTrackHz = await api.getMaxTrackHz();
  // revalidate a zoomed freq range against the (possibly smaller) new
  // global max: an inverted range 400s the marker API and maps spectrogram
  // rows past the image top
  if (state.hzRange && state.maxTrackHz > 0) {
    const [lo, hi] = state.hzRange;
    if (lo >= state.maxTrackHz) state.hzRange = null;
    else if (hi > state.maxTrackHz) state.hzRange = [lo, state.maxTrackHz];
  }
  await Promise.all(
    [...state.viewports.values()].map((vp) => vp.refreshMetadata())
  );
  if (overview && state.selectedTrack !== null) {
    await overview.setTrack(state.selectedTrack, true, state.maxSec); // revisions changed
  }
  await updateColorbar();
  // deferred switches return at dispatch: everything this function just
  // read (row LUFS/guard text, min/max dB, the overview's revision-keyed
  // bins + limiter gain) is the PRE-switch state whenever the background
  // apply hasn't landed yet — without a re-read the overview and colorbar
  // would stay stale forever (the viewport watchdogs only re-adopt tiles).
  // isComputing is true from the dispatch on, so observing it here is a
  // reliable "a re-read will be needed" signal.
  if ([...state.viewports.values()].some((vp) => vp.metadata && vp.metadata.isComputing)) {
    refreshAppliedWhenSettled();
  }
  state.needsRedraw = true;
}

// Re-fetch every applied-state reader once the engine settles (deferred
// settings/normalize/guard/apply land in the background; metadata reports
// isComputing until they do).  Latest-wins: a newer schedule supersedes.
// A run of SETTLE_MAX_FAILED_ROUNDS rounds whose fetches all failed ends the
// chain (the engine is gone); a round that reads every row resets the run.
let appliedSettleGen = 0;
const SETTLE_MAX_FAILED_ROUNDS = 30;
function refreshAppliedWhenSettled() {
  const gen = ++appliedSettleGen;
  const FAILED = Symbol("fetch-failed");
  let failedRounds = 0;
  const poll = async (delay) => {
    if (gen !== appliedSettleGen) return;
    // poll the LIVE rows each tick: a transient fetch failure must retry
    // (not abandon the only settle hook mid-switch), a removed row must
    // not kill the refresh for the remaining rows, and waiting on ALL
    // rows avoids firing while another row's image stream is still landing
    const keys = [...state.viewports.keys()];
    if (!keys.length) return; // no rows left: nothing reads applied state
    const mds = await Promise.all(
      keys.map((k) => api.getMetadata(k).catch(() => FAILED))
    );
    if (gen !== appliedSettleGen) return;
    const next = () =>
      setTimeout(() => poll(delay < 1600 ? delay * 1.25 : 2000), delay);
    if (mds.some((md) => md === FAILED)) {
      failedRounds += 1;
      if (failedRounds >= SETTLE_MAX_FAILED_ROUNDS) return; // stop polling
      next(); // transient failure: retry with backoff
      return;
    }
    failedRounds = 0;
    // null = row removed since keys were read: ignore it, judge the rest
    if (mds.some((md) => md && md.isComputing)) {
      next();
      return;
    }
    await rebuildAllRowInfo();
    await updateColorbar();
    if (overview && state.selectedTrack !== null) {
      // setTrack(force) skips the bins/gain download when the waveform
      // revision is unchanged — only a landed normalize/guard/reload pays
      await overview.setTrack(state.selectedTrack, true, state.maxSec);
    }
    state.needsRedraw = true;
  };
  setTimeout(() => poll(300), 200);
}

async function updateColorbar() {
  if (!colormapRgba) return;
  const [minDb, maxDb] = await Promise.all([api.getMinDb(), api.getMaxDb()]);
  state.dbRange = [minDb, maxDb]; // colorbar hover tooltip reads these
  drawColorbar($("#colorbar"), colormapRgba, minDb, maxDb);
}

async function buildRow(trackId) {
  const nCh = await api.getChannelCounts(trackId);
  const tpl = document.querySelector("#row-template");
  // every channel gets a row (reference: track.rs:359-366 id_ch_tuples
  // spans 0..n_ch; TrackInfo.tsx:82-90 renders one sub-row per channel)
  for (let ch = 0; ch < nCh; ch++) {
    const idChStr = `${trackId}_${ch}`;
    if (state.viewports.has(idChStr)) continue;
    const row = tpl.content.cloneNode(true).firstElementChild;
    row.dataset.idCh = idChStr;
    row.dataset.trackId = trackId;
    rowsEl.appendChild(row);
    const vp = new TrackViewport(idChStr);
    vp.onNeedsRedraw = () => { state.needsRedraw = true; };
    // register BEFORE the metadata fetch: refreshMetadata polls with
    // backoff while a long track is computing, and awaiting it here left
    // the row blank (not even the computing placeholder) and blocked the
    // rest of the add flow
    state.viewports.set(idChStr, vp);
    vp.refreshMetadata().then(() => { state.needsRedraw = true; })
      .catch(() => {
        // one transient failure must not leave the row permanently blank
        // (review finding): retry once shortly; refreshAll also heals it
        setTimeout(() => {
          vp.refreshMetadata().then(() => { state.needsRedraw = true; })
            .catch((err) => showError(`metadata ${idChStr}: ${err.message ?? err}`));
        }, 1000);
      });
    row.querySelector(".track-remove").onclick = (e) => {
      e.stopPropagation();
      removeTracks([trackId]);
    };
    row.querySelector(".track-reload").onclick = async (e) => {
      e.stopPropagation();
      // reloadTracks returns no_err_ids (unchanged files included) —
      // absence means the file could not be READ (track.rs:241-276)
      const ok = await api.reloadTracks([trackId]);
      if (!ok.includes(trackId)) setTrackErrored(trackId);
      else clearTrackErrored(trackId);
      await refreshAll();
      await rebuildAllRowInfo();
      redraw();
    };
    setupRowSelection(row, trackId);
    setupRowDnD(row, trackId);
    setupRowContextMenu(row, trackId);
    setupAmpAxisEditing(row, trackId);
    setupFreqAxisEditing(row);
    const vpc = row.querySelector(".viewport");
    // which locator a grab at x targets: the solid playhead while playing,
    // the dashed select cursor while paused (reference MainViewer.tsx:497 —
    // isOnLocator checks the select locator; the playhead is seek-dragged
    // through changeLocatorByMouse with isPlayhead=isPlaying)
    const grabbedLocator = (e) => {
      if (Number(row.dataset.trackId) !== state.selectedTrack) return null;
      const sec = state.playing
        ? L.playerPosition(state.playerAnchor, performance.now())
        : state.selectCursorSec;
      if (sec === undefined) return null;
      const x = (sec - state.startSec) * state.pxPerSec;
      return Math.abs(e.offsetX - x) <= 4
        ? (state.playing ? "playhead" : "select") : null;
    };
    vpc.addEventListener("mousemove", (e) => {
      showTooltip(e, vp, row);
      // locator affordance (reference: MainViewer.tsx:515-521 col-resize)
      if (Number(row.dataset.trackId) === state.selectedTrack) {
        vpc.style.cursor = grabbedLocator(e) ? "ew-resize" : "crosshair";
      }
    });
    vpc.addEventListener("mouseleave", hideTooltip);
    vpc.addEventListener("mousedown", (e) => {
      // a click is always preceded by a mousedown on this element, so a
      // suppress flag left over from a drag released OUTSIDE the viewport
      // (no click ever fired) must not swallow this fresh interaction
      // (review finding); the locator-drag up() re-sets it afterwards
      state.suppressNextViewportClick = false;
      // drag a locator: playing -> scrub-seek the playhead; paused -> drag
      // the select cursor (reference MainViewer.tsx:491-513,635-667)
      const kind = grabbedLocator(e);
      if (!kind) return;
      e.preventDefault();
      const rect = vpc.getBoundingClientRect();
      const secAt = (ev) =>
        L.scrubSecAt(ev.clientX, rect.left, state.startSec, state.pxPerSec);
      if (kind === "select") {
        axisDrag = {
          move(ev) {
            state.selectCursorSec = L.clampSelectSec(secAt(ev), state.maxSec);
            redraw();
          },
          up() {
            // suppress the click the browser fires after mouseup so it
            // can't collapse a multi-selection or re-place the cursor
            state.suppressNextViewportClick = true;
          },
        };
        return;
      }
      clearTimeout(pollTimer); // polls would fight the scrub position
      let lastSeek = 0;
      let lastSec = 0;
      axisDrag = {
        move(ev) {
          lastSec = secAt(ev);
          state.playerAnchor = {
            positionSec: lastSec, at: performance.now(), isPlaying: state.playing,
          };
          const now = performance.now();
          if (now - lastSeek > 80) {
            lastSeek = now;
            trackedSeek(lastSec); // no poll until the drag ends
          }
          redraw();
        },
        up(ev) {
          lastSec = ev ? secAt(ev) : lastSec;
          // the browser fires a click on the viewport after this mouseup;
          // letting it through would collapse a ctrl/shift multi-selection
          // and re-seek as a side effect of finishing the scrub
          state.suppressNextViewportClick = true;
          trackedSeek(lastSec).then(pollPlayer); // final position flush
        },
      };
    });
    vpc.addEventListener("click", async (e) => {
      if (state.suppressNextViewportClick) {
        state.suppressNextViewportClick = false;
        return;
      }
      // reference MainViewer.tsx:491-513: mousedown on a viewport selects
      // the row, then moves the locator — playing: player.seek (recorded as
      // a pending seek, so the selection-driven track switch keeps this
      // position); paused: move the select cursor only
      const sec = L.clampSelectSec(
        state.startSec + e.offsetX / state.pxPerSec, state.maxSec
      );
      if (state.playing) {
        await trackedSeek(sec);
      } else {
        state.selectCursorSec = sec;
      }
      selectClick(trackId, e);
      redraw();
      pollPlayer();
    });
    await updateRowInfo(row, trackId, ch, nCh);
  }
  if (!state.trackIds.includes(trackId)) state.trackIds.push(trackId);
}

async function updateRowInfo(row, trackId, ch, nCh) {
  // TrackSummary fields (reference: TrackSummary.tsx:38-174)
  const [name, fmt, sec, sr, lufs, guard] = await Promise.all([
    api.getFileName(trackId), api.getFormatInfo(trackId),
    api.getLengthSec(trackId), api.getSampleRate(trackId),
    api.getGlobalLufs(trackId), api.getGuardClipStats(trackId),
  ]);
  // per-channel label from the reference's CHANNEL table (M / L / R;
  // tracks.ts:8-12).  Past stereo the table is empty — fall back to the
  // channel number so >2-ch rows stay distinguishable (the reference UI
  // has no defined rendering there).
  const chLabel = L.channelLabel(nCh, ch) || (nCh > 1 ? `ch${ch}` : "");
  row.querySelector(".track-name").textContent =
    chLabel && nCh > 1 ? `${name} [${chLabel}]` : name;
  row.querySelector(".ch-label").textContent = chLabel;
  // TrackSummary.tsx:15-20: time is HH:MM:SS.mmm; the LUFS number goes
  // through formatNumberLabel(·, 2) — served by the backend axis command
  // (same function the reference calls in WASM)
  const lufsTxt = L.lufsLabel(
    Number.isFinite(lufs) ? await api.formatNumberLabel(lufs, 2)
      : L.nonFiniteNumberLabel(lufs));
  row.querySelector(".track-meta").textContent =
    `${L.fmtTime(sec)} · ${L.trackMetaLine(fmt.name, fmt.bitDepth, fmt.bitrate, sr)}`;
  const guardTxt = guard.filter(([c]) => c === -1 || c === ch)
    .map(([, s]) => s).join("; ");
  row.querySelector(".track-stats").textContent =
    guardTxt ? `${lufsTxt} · ${guardTxt}` : lufsTxt;
}

async function removeTracks(trackIds) {
  const prevIds = displayOrder();
  await api.removeTracks(trackIds);
  for (const trackId of trackIds) {
    state.trackIds = state.trackIds.filter((x) => x !== trackId);
    state.ampRanges.delete(trackId);
    for (const [key] of [...state.viewports]) {
      if (key.startsWith(`${trackId}_`)) {
        rowsEl.querySelector(`[data-id-ch="${key}"]`)?.remove();
        state.viewports.delete(key);
      }
    }
    if (state.selectedTrack === trackId) state.selectedTrack = null;
  }
  // removed tracks can no longer be errored (useTracks.ts:155)
  state.erroredTracks = state.erroredTracks.filter(
    (x) => !trackIds.includes(x)
  );
  // survivors keep their selection; otherwise walk outward from the old
  // pivot for the nearest remaining track (useSelectedTracks.ts:82-113)
  applySelection(
    L.selectAfterRemoveTracks(prevIds, displayOrder(), state.selected, state.selectPivot)
  );
  await refreshAll();
  redraw();
}

function fitIfFirst() {
  if (state.trackIds.length >= 1 && state.maxSec > 0) {
    if (state.startSec === 0 && Math.abs(state.pxPerSec - 100) < 1e-9) {
      state.pxPerSec = L.fitPxPerSec(viewWidth(), state.maxSec);
    }
    if (state.fitMode) applyFit();
  }
}

// ---------------------------------------------------------------------------
// selection (math in applogic.js — reference useSelectedTracks.ts:5-126
// pivot semantics over the ORDERED selection array)

function displayOrder() {
  return [...new Set([...rowsEl.children].map((r) => Number(r.dataset.trackId)))];
}

function applySelectionClasses() {
  for (const row of rowsEl.children) {
    const tid = Number(row.dataset.trackId);
    row.classList.toggle("selected", state.selected.includes(tid));
    row.classList.toggle("primary", tid === state.selectedTrack);
  }
}

// Selection changes retarget the player (reference: App.tsx:71-73 passes the
// last-selected id into usePlayer; its effect at usePlayer.ts:120-130 switches
// the loaded track).  Switches are serialized so a fire-and-forget call from a
// sync event handler can't interleave with togglePlay's awaited one.
let playerSwitchChain = Promise.resolve();

function syncPlayerToSelection() {
  // an errored last-selected track maps to "no playing track"
  // (reference App.tsx:71-73 passes -1 into usePlayer)
  const target =
    state.selectedTrack !== null &&
    !state.erroredTracks.includes(state.selectedTrack)
      ? state.selectedTrack : null;
  const p = playerSwitchChain.then(() => setPlayingTrack(target));
  playerSwitchChain = p.catch(() => {});
  return p;
}

function applySelection(result) {
  if (!result) return;
  state.selected = result.selected;
  state.selectPivot = result.pivotId;
  state.selectedTrack = result.selected.length
    ? result.selected[result.selected.length - 1] : null;
  if (overview && state.selectedTrack !== null) {
    overview.setTrack(state.selectedTrack, false, state.maxSec).then(redraw);
  } else if (overview && state.selectedTrack === null) {
    overview.setTrack(null);
  }
  syncPlayerToSelection();
  applySelectionClasses();
}

function selectOnly(trackId) {
  applySelection({ selected: [trackId], pivotId: trackId });
}

function selectClick(trackId, e) {
  applySelection(
    L.selectTrack(state.selected, state.selectPivot, trackId, displayOrder(), {
      command: e.metaKey || e.ctrlKey,
      shift: e.shiftKey,
    })
  );
}

function selectAll() {
  applySelection(L.selectAllTracks(state.selected, displayOrder()));
}

function setupRowSelection(row, trackId) {
  row.querySelector(".track-info").addEventListener("mousedown", (e) => {
    if (e.target.tagName === "BUTTON") return;
    selectClick(trackId, e);
  });
}

// ---------------------------------------------------------------------------
// DnD reorder (reference: MainViewer.tsx track DnD + TrackInfoDragLayer).
// Dragging a row that belongs to a multi-selection moves the WHOLE selection:
// the other selected rows collapse for the duration of the drag and re-emerge
// right below the dragged track on release, in selection order
// (TrackInfo.tsx:161-185 hideTracks/showHiddenTracks, useTracks.ts:166-192).

let dragRow = null;
let dragHiddenTids = []; // ordered other-selected ids, collapsed mid-drag

function finishRowDrag() {
  // runs on EVERY drag end (dropped or cancelled), like the reference's
  // useDrag end() → showHiddenTracks(item.index) at useTracks.ts:187-192:
  // hidden rows re-insert right after the dragged track's rows.
  if (dragRow && dragHiddenTids.length) {
    const tid = dragRow.dataset.trackId;
    const kids = [...rowsEl.children];
    let last = -1;
    for (let i = 0; i < kids.length; i++) {
      if (kids[i].dataset.trackId === tid) last = i;
    }
    // anchor = first NON-collapsing row after the drag rows, so inserting
    // the hidden rows before it keeps them in selection order
    let anchor = null;
    for (let i = last + 1; i < kids.length; i++) {
      if (!dragHiddenTids.includes(Number(kids[i].dataset.trackId))) {
        anchor = kids[i];
        break;
      }
    }
    for (const ht of dragHiddenTids) {
      for (const r of kids) {
        if (Number(r.dataset.trackId) !== ht) continue;
        rowsEl.insertBefore(r, anchor);
      }
    }
  }
  for (const r of rowsEl.children) {
    r.classList.remove("drop-above", "drop-below", "drag-hidden");
  }
  dragRow = null;
  dragHiddenTids = [];
  state.trackIds = displayOrder();
  redraw();
}

function setupRowDnD(row, _trackId) {
  const handle = row.querySelector(".track-info");
  handle.draggable = true;
  handle.addEventListener("dragstart", (e) => {
    const tid = Number(row.dataset.trackId);
    // dragging a non-selected row resets the selection to it
    // (TrackInfo.tsx:168: selectTrack(null, id) when not included)
    if (!state.selected.includes(tid)) selectOnly(tid);
    dragRow = row;
    dragHiddenTids = state.selected.filter((t) => t !== tid);
    for (const r of rowsEl.children) {
      if (dragHiddenTids.includes(Number(r.dataset.trackId))) {
        r.classList.add("drag-hidden");
      }
    }
    row.classList.add("dragging");
    // drag-layer badge == reference TrackInfoDragLayer numDragging
    if (dragHiddenTids.length) {
      row.dataset.dragCount = String(state.selected.length);
    }
    e.dataTransfer.effectAllowed = "move";
    e.dataTransfer.setData("text/plain", row.dataset.idCh);
  });
  handle.addEventListener("dragend", () => {
    row.classList.remove("dragging");
    delete row.dataset.dragCount;
    finishRowDrag();
  });
  row.addEventListener("dragover", (e) => {
    if (!dragRow || row.dataset.trackId === dragRow.dataset.trackId) return;
    e.preventDefault();
    const rect = row.getBoundingClientRect();
    const above = e.clientY < rect.top + rect.height / 2;
    row.classList.toggle("drop-above", above);
    row.classList.toggle("drop-below", !above);
  });
  row.addEventListener("dragleave", () => {
    row.classList.remove("drop-above", "drop-below");
  });
  row.addEventListener("drop", (e) => {
    if (!dragRow || row.dataset.trackId === dragRow.dataset.trackId) return;
    e.preventDefault();
    const rect = row.getBoundingClientRect();
    const above = e.clientY < rect.top + rect.height / 2;
    // move ALL rows of the dragged track together (multi-channel rows);
    // collapsed group rows follow at dragend via finishRowDrag
    const tid = dragRow.dataset.trackId;
    const kids = [...rowsEl.children];
    const moving = kids.filter((r) => r.dataset.trackId === tid);
    const after = kids[kids.indexOf(row) + 1];
    const anchor = above ? row : (after === undefined ? null : after);
    if (anchor !== null && moving.includes(anchor)) return; // already there
    for (const r of moving) rowsEl.insertBefore(r, anchor);
    row.classList.remove("drop-above", "drop-below");
  });
}

// ---------------------------------------------------------------------------
// editable axis ranges (reference: FreqAxis.tsx / AmpAxis.tsx drag +
// double-click floating input; MainViewer.tsx:414-489 vertical zoom)

let floatingInput = null;

function openFloatingInput(x, y, initial, onCommit) {
  closeFloatingInput();
  floatingInput = document.createElement("input");
  floatingInput.type = "text";
  floatingInput.value = initial;
  floatingInput.className = "floating-input";
  floatingInput.style.left = `${x}px`;
  floatingInput.style.top = `${y}px`;
  document.body.appendChild(floatingInput);
  floatingInput.focus();
  floatingInput.select();
  floatingInput.onkeydown = (e) => {
    if (e.key === "Enter") {
      onCommit(floatingInput.value);
      closeFloatingInput();
    } else if (e.key === "Escape") {
      closeFloatingInput();
    }
    e.stopPropagation();
  };
  floatingInput.onblur = () => closeFloatingInput();
}

function closeFloatingInput() {
  floatingInput?.remove();
  floatingInput = null;
}

async function parseHzLabel(text) {
  // exact reference parser (axis.rs freqLabelToHz: "12345", "12.3k", "1k5")
  // served by the backend axis API; any failure means "not parseable"
  try {
    const v = await api.freqLabelToHz(text);
    return typeof v === "number" && isFinite(v) ? v : null;
  } catch {
    return null;
  }
}

// ONE shared drag dispatcher for every axis canvas: rows come and go, so
// per-row window listeners would leak (and keep removed rows alive)
let axisDrag = null; // {move(e)} set on axis mousedown, cleared on mouseup

window.addEventListener("mousemove", (e) => axisDrag?.move(e));
window.addEventListener("mouseup", (e) => {
  axisDrag?.up?.(e); // final flush (e.g. last scrub position)
  axisDrag = null;
});

function setupFreqAxisEditing(row) {
  // three drag zones (reference FreqAxis.tsx:30-34): top third rescales the
  // upper limit, middle shifts the window, bottom third rescales the lower
  const axis = row.querySelector(".freq-axis");
  axis.style.cursor = "ns-resize";
  axis.addEventListener("mousedown", (e) => {
    const h = axis.clientHeight || 1;
    const maxHz = state.maxTrackHz || 1;
    const range = hzRangeOrFull();
    const zone = L.freqAxisCursorState(e.offsetY, h);
    const anchor = {
      cursorAxisPos: e.offsetY,
      hzRange: range,
      zeroHzPos: L.freqHzToPos(state.freqScale, 0, h, range[0], range[1], maxHz),
      maxTrackHzPos: L.freqHzToPos(state.freqScale, maxHz, h, range[0], range[1], maxHz),
    };
    const startClientY = e.clientY;
    axisDrag = {
      move(ev) {
        const pos = anchor.cursorAxisPos + (ev.clientY - startClientY);
        let result;
        if (zone === "control-max-hz") {
          result = L.freqMaxDrag(anchor, pos, h, state.freqScale, maxHz);
        } else if (zone === "control-min-hz") {
          result = L.freqMinDrag(anchor, pos, state.freqScale, maxHz);
        } else {
          result = L.freqShiftDrag(anchor, pos, h, state.freqScale, maxHz);
        }
        setHzRangeResult(result);
        redraw();
      },
    };
  });
  axis.addEventListener("dblclick", (e) => {
    // top/bottom zones open the limit input (reference FreqAxis.tsx:196-211
    // + menu events edit-freq-upper/lower-limit-{id})
    const h = axis.clientHeight || 1;
    const zone = L.freqAxisCursorState(e.offsetY, h);
    if (zone === "shift-hz-range") return;
    const editUpper = zone === "control-max-hz";
    const [lo, hi] = hzRangeOrFull();
    openFloatingInput(e.clientX, e.clientY, String(Math.round(editUpper ? hi : lo)), async (text) => {
      const v = await parseHzLabel(text);
      if (v === null) return;
      const maxHz = state.maxTrackHz || 1;
      const r = hzRangeOrFull().slice();
      if (editUpper) setHzRangeResult([r[0], L.clampMaxHz(v, r[0], maxHz)]);
      else setHzRangeResult([L.clampMinHz(v, r[1]), r[1]]);
      redraw();
    });
  });
  axis.addEventListener("wheel", (e) => {
    // alt+wheel rescales the upper limit (reference FreqAxis.tsx:178-195)
    if (!e.altKey) return;
    e.preventDefault();
    if (Math.abs(e.deltaY) < Math.abs(e.deltaX)) return;
    setHzRangeResult(
      L.freqWheelMaxHz(hzRangeOrFull(), e.deltaY, state.freqScale, state.maxTrackHz || 1)
    );
    redraw();
  }, { passive: false });
  axis.addEventListener("click", (e) => {
    if (e.altKey) { state.hzRange = null; redraw(); } // alt+click reset
  });
  axis.addEventListener("contextmenu", (e) => {
    e.preventDefault();
    state.hzRange = null; // reset-axis-range (menu.rs reset events)
    redraw();
  });
  // hover tooltip (reference FreqAxis.tsx:214-221: wasm frequency tooltip
  // through the current freq-scale mapping, "12.3k" -> "12.3 kHz")
  attachAxisTooltip(axis, false, async (pos, length) => {
    const maxHz = state.maxTrackHz;
    if (!maxHz) return null;
    const [lo, hi] = hzRangeOrFull();
    const a = L.freqTooltipArgs(state.freqScale, pos, length, lo, hi, maxHz);
    const label = await api.formatFrequencyAxisTooltip(a.hz, a.resolutionHz);
    return L.freqTooltipLabel(label);
  });
}

function setupAmpAxisEditing(row, trackId) {
  // zero-anchored interval rescale (reference AmpAxis.tsx:42-108): the amp
  // value grabbed under the cursor follows it; clamp [1e-5, 5] per side
  const axis = row.querySelector(".amp-axis");
  axis.style.cursor = "ns-resize";
  axis.addEventListener("mousedown", (e) => {
    const h = axis.clientHeight || 1;
    const range = ampRangeOf(trackId);
    const zone = L.ampAxisCursorState(e.offsetY, h);
    const anchor = {
      cursorRatio: L.limitAmpCursorRatio(zone, e.offsetY / h, range),
      ampRange: range.slice(),
    };
    const startClientY = e.clientY;
    const startOffsetY = e.offsetY;
    axisDrag = {
      move(ev) {
        if (!state.trackIds.includes(trackId)) return; // row removed mid-drag
        const ratio = (startOffsetY + (ev.clientY - startClientY)) / h;
        state.ampRanges.set(trackId, L.ampDrag(zone, ratio, anchor));
        redraw();
      },
    };
  });
  axis.addEventListener("wheel", (e) => {
    // alt+wheel zooms the interval around zero (reference AmpAxis.tsx:98-108)
    if (!e.altKey) return;
    e.preventDefault();
    if (Math.abs(e.deltaY) < Math.abs(e.deltaX)) return;
    state.ampRanges.set(trackId, L.ampWheel(ampRangeOf(trackId), e.deltaY));
    redraw();
  }, { passive: false });
  axis.addEventListener("click", (e) => {
    if (e.altKey) { state.ampRanges.delete(trackId); redraw(); } // reset
  });
  axis.addEventListener("dblclick", (e) => {
    const cur = ampRangeOf(trackId)[1];
    openFloatingInput(e.clientX, e.clientY, String(cur), (text) => {
      const v = parseFloat(text);
      if (!isNaN(v) && v > 0) {
        state.ampRanges.set(trackId, L.clampAmpRange([-v, v]));
        redraw();
      }
    });
  });
  axis.addEventListener("contextmenu", (e) => {
    e.preventDefault();
    state.ampRanges.delete(trackId);
    redraw();
  });
  // hover tooltip (reference AmpAxis.tsx:123-130: linear top-down value,
  // 1-px resolution, tick unit of the drawn markers; maxFractionDigits 9)
  attachAxisTooltip(axis, false, async (pos, length) => {
    const r = ampRangeOf(trackId);
    const a = L.linearTooltipArgs(pos, length, r[1], r[0], lastAxisMarkers(axis));
    return api.formatLinearAxisTooltip(a.value, a.resolution, a.tickUnit, 9);
  });
}

// ---------------------------------------------------------------------------
// rendering loop

function redraw() { state.needsRedraw = true; }

function applyFit() {
  // fit mode: whole longest track in view (reference MainViewer fit button)
  if (state.maxSec > 0) {
    state.pxPerSec = L.fitPxPerSec(viewWidth(), state.maxSec);
    state.startSec = 0;
  }
}

function leaveFit() {
  if (state.fitMode) {
    state.fitMode = false;
    $("#btn-fit").classList.remove("active");
  }
}

// axis markers come from the backend; during continuous zoom/pan a fetch
// per frame would flood the API (the reference computes these client-side
// in WASM). Trailing-edge throttle at ~70 Hz — the reference's own control
// throttle cadence (MainViewer.tsx:357).
let axisUpdateTimer = null;
let axisUpdatePending = null;

function scheduleAxisUpdate(hzRange) {
  axisUpdatePending = { hzRange };
  if (axisUpdateTimer !== null) return;
  axisUpdateTimer = setTimeout(() => {
    axisUpdateTimer = null;
    const { hzRange: hr } = axisUpdatePending;
    updateTimeAxis($("#time-axis"), state.startSec, state.pxPerSec, state.maxSec);
    const tickParams = timeTickParams(state.pxPerSec);
    const tickUnit = tickParams ? tickParams.tickUnit : 3600;
    $("#time-unit").textContent =
      tickUnit >= 1 ? `grid ${tickUnit} s` : `grid ${(tickUnit * 1000).toPrecision(3)} ms`;
    for (const row of rowsEl.children) {
      const vp = state.viewports.get(row.dataset.idCh);
      if (!vp || !vp.metadata) continue;
      updateAmpAxis(
        row.querySelector(".amp-axis"), ampRangeOf(Number(row.dataset.trackId))
      );
      updateFreqAxis(
        row.querySelector(".freq-axis"), hr, state.freqScale,
        state.maxTrackHz || vp.metadata.sampleRate / 2
      );
    }
  }, 1000 / 70);
}

function renderFrame() {
  // playhead extrapolation (reference: usePlayer.ts:44-52)
  const a = state.playerAnchor;
  const pos = L.playerPosition(a, performance.now());
  // PlayerControl.tsx:30-44: the position readout shows the playhead while
  // playing and the SELECT cursor while paused, and never overwrites an
  // in-progress edit (FloatingUserInput isEditing == focused)
  const td = $("#time-display");
  if (document.activeElement !== td) {
    td.value = L.fmtTime(a.isPlaying ? pos : (state.selectCursorSec ?? 0));
  }

  // follow-playhead autoscroll (reference MainViewer.tsx:853-871): while
  // playing, scroll only when the playhead leaves the view (and the user
  // hasn't panned away); paused, follow the select cursor's jumps
  const endSec = state.startSec + viewWidth() / state.pxPerSec;
  if (a.isPlaying) {
    if (state.followPlayhead && state.needFollowCursor) {
      const ns = L.followPlayheadStartSec(pos, state.startSec, endSec);
      if (ns !== null) {
        setLens({ startSec: ns }, false);
        state.needsRedraw = true;
      }
    }
  } else {
    state.needFollowCursor = true;
    const sel = state.selectCursorSec;
    if (sel !== undefined) {
      const ns = L.selectSecAutoScroll(
        sel, state.prevSelectSec, state.startSec, endSec, viewWidth(), state.pxPerSec
      );
      if (ns !== null) {
        setLens({ startSec: ns }, false);
        state.needsRedraw = true;
      }
      state.prevSelectSec = sel;
    }
  }

  if (a.isPlaying) state.needsRedraw = true; // animate the playhead
  if (state.needsRedraw) {
    state.needsRedraw = false;
    const hzRange = hzRangeOrFull();
    compositor.render((ctx, row, w, h, dpr) => {
      const vp = state.viewports.get(row.dataset.idCh);
      if (!vp) return;
      vp.draw(ctx, w, h, dpr, {
        startSec: state.startSec,
        pxPerSec: state.pxPerSec,
        blend: state.blend,
        hzRange,
        maxTrackHz: state.maxTrackHz,
        freqScale: state.freqScale,
        ampRange: ampRangeOf(Number(row.dataset.trackId)),
      });
      // locator overlays: dashed select cursor + solid playhead — the
      // compositor clears the whole canvas each frame, so strokes never
      // accumulate (reference: src/modules/Locator.tsx locators)
      if (Number(row.dataset.trackId) !== state.selectedTrack) return;
      const x = (pos - state.startSec) * state.pxPerSec;
      if (state.selectCursorSec !== undefined) {
        const sx = (state.selectCursorSec - state.startSec) * state.pxPerSec;
        if (sx >= 0 && sx <= w && Math.abs(sx - x) > 1) {
          ctx.strokeStyle = "rgba(245,145,73,0.45)";
          ctx.setLineDash([4, 4]);
          ctx.beginPath();
          ctx.moveTo(sx, 0);
          ctx.lineTo(sx, h);
          ctx.stroke();
          ctx.setLineDash([]);
        }
      }
      if (x >= 0 && x <= w) {
        ctx.strokeStyle = "#f59149";
        ctx.beginPath();
        ctx.moveTo(x, 0);
        ctx.lineTo(x, h);
        ctx.stroke();
      }
    });
    if (overview) {
      overview.draw(state.startSec, viewWidth() / state.pxPerSec, state.maxSec);
    }
    scheduleAxisUpdate(hzRange);
  }
  requestAnimationFrame(renderFrame);
}

// ---------------------------------------------------------------------------
// tooltip (reference: formatTimeAxisTooltip / formatFrequencyAxisTooltip
// via AudioTrackViewport hover)

let tooltipEl = null;
let tooltipPending = false;
let tooltipLastEvent = null;

function placeTooltip(e) {
  if (!tooltipEl) {
    tooltipEl = document.createElement("div");
    tooltipEl.style.cssText =
      "position:fixed;pointer-events:none;background:#000a;color:#dde;" +
      "padding:2px 6px;border-radius:3px;font:11px system-ui;z-index:9";
    document.body.appendChild(tooltipEl);
  }
  tooltipEl.style.left = `${e.clientX + 12}px`;
  tooltipEl.style.top = `${e.clientY + 12}px`;
  tooltipEl.style.display = "block";
}

function showTooltip(e, vp, row) {
  if (!vp.metadata) return;
  placeTooltip(e);
  // always remember the LATEST event: the throttled closure below must
  // compute content for where the box actually sits, not for the event
  // that armed the throttle up to 100 ms of mouse travel earlier
  tooltipLastEvent = e;
  if (tooltipPending) return;
  tooltipPending = true;
  setTimeout(async () => {
    tooltipPending = false;
    if (!tooltipEl || tooltipEl.style.display === "none") return;
    const ev = tooltipLastEvent || e;
    const sec = state.startSec + ev.offsetX / state.pxPerSec;
    const h = ev.target.clientHeight || 1;
    const maxHz = state.maxTrackHz || vp.metadata.sampleRate / 2;
    const [hzLo, hzHi] = hzRangeOrFull();
    // same value+resolution math as the freq axis tooltip
    // (wasm-wrapper.ts:150-158), evaluated at the hover row
    const a = L.freqTooltipArgs(state.freqScale, ev.offsetY, h, hzLo, hzHi, maxHz);
    try {
      const [t, hzLabel] = await Promise.all([
        api.formatTimeAxisTooltip(sec, "mm:ss.xxx"),
        api.formatFrequencyAxisTooltip(a.hz, a.resolutionHz),
      ]);
      if (tooltipEl) {
        tooltipEl.textContent = `${t} · ${L.freqTooltipLabel(hzLabel)}`;
      }
    } catch { /* transient */ }
  }, 100);
}

function hideTooltip() {
  if (tooltipEl) tooltipEl.style.display = "none";
}

// axis hover tooltips (reference AxisCanvas.tsx:139-166: axisPosition =
// cursor offset clamped to the axis, content from the per-axis
// formatTooltip).  compute(pos, length) resolves to the tooltip text, or
// null to leave the box unchanged.
function attachAxisTooltip(el, horizontal, compute) {
  let pending = false;
  let lastEvent = null;
  el.addEventListener("mousemove", (e) => {
    if (!state.trackIds.length) return; // enableInteraction
    placeTooltip(e);
    lastEvent = e; // latest-event throttle, same contract as showTooltip
    if (pending) return;
    pending = true;
    setTimeout(async () => {
      pending = false;
      if (!tooltipEl || tooltipEl.style.display === "none") return;
      const ev = lastEvent || e;
      const length = horizontal ? el.clientWidth : el.clientHeight;
      const raw = horizontal ? ev.offsetX : ev.offsetY;
      const pos = Math.min(Math.max(raw, 0), length);
      try {
        const text = await compute(pos, length);
        if (text !== null && tooltipEl) tooltipEl.textContent = text;
      } catch { /* transient */ }
    }, 100);
  });
  el.addEventListener("mouseleave", hideTooltip);
}

// ---------------------------------------------------------------------------
// zoom / pan (reference: MainViewer.tsx:538-595 wheel gestures;
// :414-489 cursor-anchored horizontal & vertical zoom w/ scroll correction)

// the reference's wheel-gesture table (MainViewer.tsx:538-595, normalized
// by applogic.classifyWheel): zoom chord + dominant axis decide between
// cursor-anchored time zoom, row-height zoom w/ scroll correction,
// horizontal scroll, and native vertical scroll
const IS_APPLE = /Mac|iP(hone|ad|od)/.test(navigator.platform || "");

function applyHeightZoom(delta, clientY) {
  const rows = [...rowsEl.children];
  const rowTops = rows.map((_r, i) => i * state.rowHeight);
  const rect = rowsEl.getBoundingClientRect();
  const out = L.zoomHeightAtCursor(
    rowTops, state.rowHeight, state.rowHeight, delta,
    clientY - rect.top, rowsEl.scrollTop, 0
  );
  if (!out) return;
  state.rowHeight = out.height;
  document.documentElement.style.setProperty("--row-h", `${out.height}px`);
  rowsEl.scrollTop = out.scrollTop;
  redraw();
}

rowsEl.addEventListener("wheel", (e) => {
  if (!state.trackIds.length) return;
  const g = L.classifyWheel(e, IS_APPLE);
  if (g.kind === "native") return; // let the rows container scroll
  e.preventDefault();
  const rect = rowsEl.getBoundingClientRect();
  const xInView = e.clientX - rect.left - leftOffset();
  // preventDefault-then-bounds-return matches the reference exactly
  // (MainViewer.tsx:565-575: gestures over the gutter are consumed, not
  // acted on)
  if (xInView < 0) return;
  const cur = { startSec: state.startSec, pxPerSec: state.pxPerSec };
  if (g.kind === "hzoom") {
    leaveFit();
    if (state.playing) state.needFollowCursor = false;
    const out = L.horizontalZoom(cur, xInView, g.delta, state.maxSec, viewWidth());
    state.startSec = out.startSec;
    state.pxPerSec = out.pxPerSec;
  } else if (g.kind === "vzoom") {
    applyHeightZoom(g.delta, e.clientY);
  } else {
    leaveFit();
    if (state.playing) state.needFollowCursor = false;
    const out = L.horizontalScroll(cur, g.delta, state.maxSec, viewWidth());
    state.startSec = out.startSec;
  }
  redraw();
}, { passive: false });

// ---------------------------------------------------------------------------
// player polling

let pollTimer = null;
async function pollPlayer() {
  try {
    const st = await api.playerState();
    state.playerAnchor = {
      positionSec: st.positionSec, at: performance.now(), isPlaying: st.isPlaying,
    };
    state.playing = st.isPlaying;
    $("#btn-play").textContent = st.isPlaying ? "❚❚" : "▶";
    audio.setPlaying(st.isPlaying); // keep the Web Audio pump in step
    if (st.err && st.err !== state.lastPlayerErr) {
      state.lastPlayerErr = st.err;
      showError(`audio: ${st.err}`);
    } else if (!st.err) {
      state.lastPlayerErr = "";
    }
    clearTimeout(pollTimer);
    pollTimer = setTimeout(pollPlayer, st.isPlaying ? 250 : 1500);
  } catch {
    // one failed fetch (service restart, transient network) must not kill
    // the polling loop forever — back off and retry
    clearTimeout(pollTimer);
    pollTimer = setTimeout(pollPlayer, 2000);
  }
}

function connectEvents() {
  try {
    const ws = new WebSocket(`ws://${location.host}/events`);
    ws.onmessage = (m) => {
      const { event, payload } = JSON.parse(m.data);
      if (event === "player-state-changed") {
        state.playerAnchor = {
          positionSec: payload.positionSec, at: performance.now(),
          isPlaying: payload.isPlaying,
        };
        state.playing = payload.isPlaying;
        $("#btn-play").textContent = payload.isPlaying ? "❚❚" : "▶";
        audio.setPlaying(payload.isPlaying);
      }
    };
  } catch { /* polling fallback is always active */ }
}

// ---------------------------------------------------------------------------
// window file drop (reference: App.tsx addDroppedFile + MainViewer drop row)

function setupFileDrop() {
  const indicator = $("#drop-indicator");
  // per-track vertical spans for the drop-index math (one trackInfo rect
  // per track in the reference; channel rows merge into their track here)
  const trackSpans = () => {
    const spans = [];
    for (const row of rowsEl.children) {
      const id = Number(row.dataset.trackId);
      const rect = row.getBoundingClientRect();
      const last = spans[spans.length - 1];
      if (last && last.id === id) last.height += rect.height;
      else spans.push({ id, top: rect.top, height: rect.height });
    }
    return spans;
  };
  const clearDropMark = () => {
    for (const row of rowsEl.children) {
      row.classList.remove("drop-above", "drop-below");
    }
  };
  const markDropIndex = (index, spans) => {
    clearDropMark();
    const rows = [...rowsEl.children];
    if (!rows.length) return;
    if (index < spans.length) {
      const anchor = rows.find(
        (r) => Number(r.dataset.trackId) === spans[index].id
      );
      if (anchor) anchor.classList.add("drop-above");
    } else {
      rows[rows.length - 1].classList.add("drop-below");
    }
  };
  const dropIndexOf = (clientY, spans) => L.fileDropIndex(
    clientY ?? Infinity, // no coordinate -> append past the end
    spans.map((s) => s.top), spans.map((s) => s.height)
  );
  let lastDropMark = null; // dragover fires continuously — re-mark only
  window.addEventListener("dragover", (e) => { // when the index changes
    if ([...e.dataTransfer.types].includes("Files")) {
      e.preventDefault();
      indicator.classList.add("visible");
      // reference MainViewer.tsx:191-195: the drop row indicator follows
      // the cursor while dragging over
      const spans = trackSpans();
      const index = dropIndexOf(e.clientY, spans);
      if (index === lastDropMark) return;
      lastDropMark = index;
      markDropIndex(index, spans);
    }
  });
  window.addEventListener("dragleave", (e) => {
    if (e.relatedTarget === null) {
      indicator.classList.remove("visible");
      clearDropMark();
      lastDropMark = null;
    }
  });
  window.addEventListener("drop", async (e) => {
    indicator.classList.remove("visible");
    clearDropMark();
    lastDropMark = null;
    if (!e.dataTransfer.files.length) return;
    e.preventDefault();
    const index = dropIndexOf(e.clientY, trackSpans());
    // unsupported extensions are rejected before upload with the file-open
    // error message (App.tsx:85-101 + SUPPORTED_TYPES)
    const names = [...e.dataTransfer.files].map((f) => f.name);
    const { unsupported } = L.splitSupportedPaths(names);
    if (unsupported.length) {
      showError(`Unsupported file type: ${unsupported.join(", ")}`);
    }
    const paths = [];
    for (const f of e.dataTransfer.files) {
      if (unsupported.includes(f.name)) continue;
      try {
        paths.push(await api.upload(f));
      } catch {
        showError(`Upload failed: ${f.name}`);
      }
    }
    if (paths.length) await addPaths(paths, index);
  });
}

// ---------------------------------------------------------------------------
// context menu (reference: context_menu.rs:22-139 — track / track-info /
// empty-space menus emitting remove/reload/select-all)

let ctxMenuEl = null;

function closeContextMenu() {
  ctxMenuEl?.remove();
  ctxMenuEl = null;
}

function openContextMenu(x, y, items) {
  closeContextMenu();
  ctxMenuEl = document.createElement("div");
  ctxMenuEl.className = "context-menu";
  ctxMenuEl.style.left = `${x}px`;
  ctxMenuEl.style.top = `${y}px`;
  for (const [label, action] of items) {
    if (label === "-") {
      const hr = document.createElement("div");
      hr.className = "context-sep";
      ctxMenuEl.appendChild(hr);
      continue;
    }
    const it = document.createElement("div");
    it.className = "context-item";
    it.textContent = label;
    it.onmousedown = (e) => {
      e.preventDefault();
      closeContextMenu();
      action();
    };
    ctxMenuEl.appendChild(it);
  }
  document.body.appendChild(ctxMenuEl);
  const r = ctxMenuEl.getBoundingClientRect();
  if (r.bottom > innerHeight) ctxMenuEl.style.top = `${y - r.height}px`;
  if (r.right > innerWidth) ctxMenuEl.style.left = `${x - r.width}px`;
}

window.addEventListener("mousedown", (e) => {
  if (ctxMenuEl && !ctxMenuEl.contains(e.target)) closeContextMenu();
});

function setupRowContextMenu(row, trackId) {
  row.addEventListener("contextmenu", (e) => {
    if (e.target.closest(".freq-axis") || e.target.closest(".amp-axis")) return;
    e.preventDefault();
    if (!state.selected.includes(trackId)) selectClick(trackId, e);
    const sel = [...state.selected];
    openContextMenu(e.clientX, e.clientY, [
      [sel.length > 1 ? `Remove ${sel.length} tracks` : "Remove track",
        () => removeTracks(sel)],
      ["Reload from disk", async () => {
        const ok = await api.reloadTracks(sel);
        for (const t of sel) {
          if (!ok.includes(t)) setTrackErrored(t);
          else clearTrackErrored(t);
        }
        await refreshAll();
        await rebuildAllRowInfo();
        redraw();
      }],
      ["-", null],
      ["Select all", selectAll],
      ["Reset freq axis", () => { state.hzRange = null; redraw(); }],
      ["Reset amp axis", () => { state.ampRanges.delete(trackId); redraw(); }],
    ]);
  });
}

// ---------------------------------------------------------------------------
// info-pane splitter (reference: src/modules/SplitView.tsx:30-211)

function setupSplitter() {
  const splitter = $("#info-splitter");
  // window-state persistence analogue (the reference persists window state
  // via tauri-plugin-window-state, lib.rs:744-757)
  const saved = Number(localStorage.getItem("thesia.infoW"));
  if (saved >= 90 && saved <= 480) {
    document.documentElement.style.setProperty("--info-w", `${saved}px`);
  }
  splitter.addEventListener("mousedown", (e) => {
    const start = { x: e.clientX, w: leftOffset() - LEFT_FIXED_PX };
    axisDrag = {
      move(ev) {
        const w = L.splitterWidth(start.w, ev.clientX - start.x);
        document.documentElement.style.setProperty("--info-w", `${w}px`);
        localStorage.setItem("thesia.infoW", String(w));
        redraw();
      },
    };
    e.preventDefault();
  });
}

// ---------------------------------------------------------------------------
// controls

async function setupControls() {
  $("#btn-add").onclick = () => $("#file-input").click();
  $("#btn-add-row").onclick = () => $("#file-input").click();
  $("#file-input").onchange = async (e) => {
    const input = e.target;
    const paths = [];
    for (const f of input.files) {
      try {
        const p = await api.upload(f);
        if (p) paths.push(p);
        else showError(`Upload failed: ${f.name}`);
      } catch {
        showError(`Upload failed: ${f.name}`);
      }
    }
    input.value = ""; // reset FIRST so re-selecting the same file re-fires
    if (paths.length) await addPaths(paths);
  };
  const media = await api.listMedia().catch(() => []);
  const sel = $("#media-list");
  for (const p of media) {
    const o = document.createElement("option");
    o.value = p;
    o.textContent = p.split("/").pop();
    sel.appendChild(o);
  }
  sel.onchange = () => {
    if (sel.value) addPaths([sel.value]);
    sel.value = "";
  };

  $("#btn-play").onclick = togglePlay;
  $("#btn-fit").onclick = () => {
    state.fitMode = !state.fitMode;
    $("#btn-fit").classList.toggle("active", state.fitMode);
    if (state.fitMode) applyFit();
    redraw();
  };
  $("#btn-follow").onclick = () => {
    state.followPlayhead = !state.followPlayhead;
    $("#btn-follow").classList.toggle("active", state.followPlayhead);
  };
  $("#btn-follow").classList.toggle("active", state.followPlayhead);

  // hotkeys mirror the reference's menu-emitted events (menu.rs:427-445:
  // toggle-play, jump-player, rewind-to-front, time/freq-zoom,
  // remove-selected-tracks, select-all-tracks)
  document.addEventListener("keydown", async (e) => {
    if (e.target.tagName === "INPUT" || e.target.tagName === "SELECT") return;
    const jump = L.jumpAmountSec(e.shiftKey); // PLAY_BIG_JUMP_SEC / PLAY_JUMP_SEC
    if (e.code === "Space") {
      e.preventDefault();
      togglePlay();
    } else if ((e.metaKey || e.ctrlKey) && e.code === "KeyA") {
      e.preventDefault();
      selectAll();
    } else if (e.code === "Comma" || e.code === "Period") {
      // reference usePlayer.ts:148-157: comma/period jump the player
      // (paused: the select cursor) by ±1 s, ±5 s with shift
      e.preventDefault();
      await jumpBy(e.code === "Period" ? jump : -jump);
    } else if (
      (e.metaKey || e.ctrlKey) &&
      (e.code === "ArrowLeft" || e.code === "ArrowRight")
    ) {
      // reference MainViewer.tsx:735-773: mod+left/right time zoom
      // anchored at the select cursor through the normalize pipeline
      e.preventDefault();
      if (!state.trackIds.length) return;
      leaveFit();
      setLens(L.zoomLensAtSelect(
        { startSec: state.startSec, pxPerSec: state.pxPerSec },
        state.selectCursorSec ?? 0, e.code === "ArrowLeft",
        state.maxSec, viewWidth()
      ));
      redraw();
    } else if (
      (e.metaKey || e.ctrlKey) &&
      (e.code === "ArrowDown" || e.code === "ArrowUp")
    ) {
      // reference MainViewer.tsx:691-733: mod+down/up = freq (row-height)
      // zoom keeping the content middle stable
      e.preventDefault();
      if (!state.trackIds.length) return;
      const isZoomOut = e.code === "ArrowUp";
      const base = state.rowHeight;
      const h = L.calcZoomedHeight(base, L.zoomStepDelta(base, isZoomOut));
      const st = L.freqZoomScrollTop(
        base, h, rowsEl.scrollTop, rowsEl.clientHeight, rowsEl.children.length
      );
      if (st === null) return;
      state.rowHeight = h;
      document.documentElement.style.setProperty("--row-h", `${h}px`);
      rowsEl.scrollTop = Math.max(st, 0);
      redraw();
    } else if (e.code === "ArrowDown" || e.code === "ArrowUp") {
      // reference MainViewer.tsx:783-795: up/down (shift extends the
      // range) move the selection relative to the most recent pick
      e.preventDefault();
      const id = L.nextTrackOnArrow(
        displayOrder(), state.selected, e.code === "ArrowDown"
      );
      if (id !== null) {
        applySelection(
          L.selectTrack(state.selected, state.selectPivot, id, displayOrder(), {
            command: false,
            shift: e.shiftKey,
          })
        );
        redraw();
      }
    } else if (e.code === "ArrowLeft" || e.code === "ArrowRight") {
      // reference MainViewer.tsx:680-690: arrows pan the lens by 40 css px
      // (200 with shift) — they do NOT touch the player
      e.preventDefault();
      if (!state.trackIds.length) return;
      leaveFit();
      setLens({
        startSec: L.arrowPanStartSec(
          state.startSec, state.pxPerSec, e.code === "ArrowRight", e.shiftKey
        ),
      });
      redraw();
    } else if (e.code === "Enter" || e.code === "Home") {
      // reference usePlayer.ts:181-185 rewind-to-front (Home kept as alias)
      e.preventDefault();
      await rewindToFront();
    } else if (e.key === "+" || e.key === "=") {
      leaveFit();
      setLens({ pxPerSec: state.pxPerSec * 1.5 });
      redraw();
    } else if (e.key === "-") {
      leaveFit();
      setLens({ pxPerSec: state.pxPerSec / 1.5 });
      redraw();
    } else if (e.key === "]" || e.key === "[") {
      // freq-zoom-in/out around the range center (menu.rs freq-zoom events)
      zoomFreqRangeAt(e.key === "]" ? 1 / 1.3 : 1.3, 0.5);
      redraw();
    } else if (e.code === "Delete" || e.code === "Backspace") {
      if (state.selected.length) {
        await removeTracks([...state.selected]);
      }
    }
  });
  $("#volume").oninput = (e) => api.setVolumeDb(Number(e.target.value));
  // FloatRangeInput doubleClickValue=0 (PlayerControl.tsx:100-113)
  $("#volume").ondblclick = (e) => {
    e.target.value = "0";
    api.setVolumeDb(0);
  };

  // transport buttons (PlayerControl.tsx:78-99: skip-to-beginning,
  // jump ±PLAY_JUMP_SEC, play/pause)
  $("#btn-skip-start").onclick = () => rewindToFront();
  $("#btn-jump-back").onclick = () => jumpBy(-L.jumpAmountSec(false));
  $("#btn-jump-fwd").onclick = () => jumpBy(L.jumpAmountSec(false));

  // editable position readout (PlayerControl.tsx:53-77 FloatingUserInput:
  // commit on blur only if changed; Enter commits, Escape cancels; the
  // parsed label seeks while playing and moves the select cursor paused)
  const td = $("#time-display");
  let tdChanged = false;
  td.addEventListener("input", () => { tdChanged = true; });
  td.addEventListener("keydown", (e) => {
    e.stopPropagation();
    if (e.key === "Enter") td.blur();
    else if (e.key === "Escape") {
      tdChanged = false;
      td.blur();
    }
  });
  td.addEventListener("blur", async () => {
    if (!tdChanged) return;
    tdChanged = false;
    const sec = await api.timeLabelToSeconds(td.value);
    if (typeof sec !== "number" || Number.isNaN(sec)) return;
    if (state.playing) {
      await trackedSeek(sec);
      pollPlayer();
    } else {
      state.selectCursorSec = L.clampSelectSec(sec, state.maxSec);
    }
    redraw();
  });

  // time-axis interactions (reference TimeAxis.tsx:43-77: anchored drag
  // pans the lens so the grabbed second follows the cursor; a plain click
  // moves the locator — playing seeks the playhead, paused the select
  // cursor (MainViewer.tsx:670-672); alt+click resets to fit mode
  // (resetTimeAxis, MainViewer.tsx:76,799))
  const timeAxis = $("#time-axis");
  timeAxis.style.cursor = "text";
  timeAxis.addEventListener("mousedown", (e) => {
    if (!state.trackIds.length) return; // enableInteraction
    e.preventDefault();
    const rect = timeAxis.getBoundingClientRect();
    const x0 = e.clientX - rect.left;
    if (e.altKey) {
      state.fitMode = true;
      $("#btn-fit").classList.add("active");
      applyFit();
      redraw();
      return;
    }
    const anchor = L.timeAxisDragAnchor(
      x0, rect.width, state.startSec, state.pxPerSec
    );
    let movedAxis = false;
    axisDrag = {
      move(ev) {
        const x = ev.clientX - rect.left;
        if (!movedAxis && Math.abs(x - x0) < 3) return; // click vs drag
        movedAxis = true;
        leaveFit();
        setLens({
          startSec: L.timeAxisDragStartSec(anchor, x, rect.width, state.pxPerSec),
        });
        redraw();
      },
      up(ev) {
        if (movedAxis || !ev) return;
        const x = ev.clientX - rect.left;
        if (x < 0 || x >= rect.width) return; // !allowOutside
        const sec = L.clampSelectSec(
          state.startSec + x / state.pxPerSec, state.maxSec
        );
        if (state.playing) {
          trackedSeek(sec).then(pollPlayer);
        } else {
          state.selectCursorSec = sec;
        }
        redraw();
      },
    };
  });

  // hover tooltip (reference TimeAxis.tsx:79-90: the axis's own label
  // format extended by one fractional digit; plain-seconds formats get
  // a " s" suffix).  The formatDisplay rides the sentinel last marker
  // (axis.rs: (i32::MIN, format_display)).
  attachAxisTooltip(timeAxis, true, async (pos) => {
    const markers = lastAxisMarkers(timeAxis);
    const last = markers[markers.length - 1];
    const fd = (last ? last[1] : undefined) ?? "ss";
    const { display, appendSeconds } = L.timeTooltipDisplay(fd);
    const label = await api.formatTimeAxisTooltip(
      state.startSec + pos / state.pxPerSec, display
    );
    return appendSeconds ? `${label} s` : label;
  });

  // dB colorbar hover tooltip (reference ColorMap.tsx:53-63: linear dB
  // tooltip with maxFractionDigits 6, " dB" suffix, -inf guard)
  const colorbarEl = $("#colorbar");
  if (colorbarEl) {
    attachAxisTooltip(colorbarEl, false, async (pos, length) => {
      if (!state.dbRange) return null;
      const [minDb, maxDb] = state.dbRange;
      if (minDb === -Infinity && maxDb === -Infinity) return "-∞ dB";
      const a = L.linearTooltipArgs(
        pos, length, maxDb, minDb, lastAxisMarkers(colorbarEl)
      );
      const label = await api.formatLinearAxisTooltip(
        a.value, a.resolution, a.tickUnit, 6
      );
      return `${label} dB`;
    });
  }

  // write -> read-back -> persist, like the reference's useTracks setters
  const persistSettings = async () => {
    const [spec, dbRange, guard, norm] = await Promise.all([
      api.getSpecSetting(), api.getDbRange(),
      api.getCommonGuardClipping(), api.getCommonNormalize(),
    ]);
    await api.setUserSettings({
      specSetting: spec, dBRange: dbRange, blend: state.blend,
      commonGuardClipping: guard, commonNormalize: norm,
    });
  };

  // rate shaping (reference Control.tsx:95,146-178: dB range throttled to
  // one set per frame, normalize/guard selects debounced 250 ms)
  const throttled = (ms, fn) => {
    let last = -1e12, timer = null, pending = null;
    return (arg) => {
      pending = arg;
      const now = performance.now();
      if (now - last >= ms) {
        last = now;
        fn(pending);
      } else if (timer === null) {
        timer = setTimeout(() => {
          timer = null;
          last = performance.now();
          fn(pending);
        }, ms - (now - last));
      }
    };
  };
  const debounced = (ms, fn) => {
    let timer = null;
    return (arg) => {
      clearTimeout(timer);
      timer = setTimeout(() => { timer = null; fn(arg); }, ms);
    };
  };

  // FloatRangeInput (reference modules/FloatRangeInput.tsx): a slider +
  // text pair.  Slider input applies immediately; text commits on
  // blur/Enter with slider-then-previous fallback and clamping
  // (floatRangeTextCommit); Escape restores; double-click or alt+click on
  // the slider resets to doubleClickValue.
  function setupFloatRangeInput(rangeEl, textEl, opts) {
    const lo = parseFloat(rangeEl.min), hi = parseFloat(rangeEl.max);
    const fmt = (v) => v.toFixed(opts.precision);
    let prev = parseFloat(rangeEl.value);
    const onRange = (handler) => (e) => {
      const v = parseFloat(e.target.value);
      textEl.value = fmt(v);
      handler(v);
    };
    // onInput (when provided) handles the live drag stream; onChange fires
    // once at drag end / text commit / double-click reset
    rangeEl.oninput = onRange(opts.onInput ?? opts.onChange);
    rangeEl.onchange = onRange(opts.onChange); // change fires at drag end
    rangeEl.onclick = (e) => {
      if (opts.doubleClickValue === null) return;
      if (!L.floatRangeResetClick(e.button ?? 0, e.detail ?? 0, !!e.altKey)) return;
      e.preventDefault();
      rangeEl.value = fmt(opts.doubleClickValue);
      textEl.value = fmt(opts.doubleClickValue);
      opts.onChange(opts.doubleClickValue);
    };
    textEl.onfocus = () => {
      // FloatRangeInput.tsx:95-102 — remember the pre-edit value
      let v = parseFloat(textEl.value);
      if (Number.isNaN(v)) v = parseFloat(rangeEl.value);
      if (Number.isNaN(v)) v = prev;
      prev = v;
    };
    const commitText = () => {
      const r = L.floatRangeTextCommit(textEl.value, rangeEl.value, prev, lo, hi);
      if (r.changed) {
        rangeEl.value = fmt(r.value);
        prev = r.value;
        opts.onChange(r.value);
      }
      textEl.value = fmt(parseFloat(rangeEl.value)); // resync text to slider
    };
    textEl.onblur = commitText;
    textEl.onchange = commitText; // change fires at commit time in browsers
    textEl.onkeydown = (e) => {
      if (e.key === "Enter") {
        textEl.blur();
      } else if (e.key === "Escape") {
        textEl.value = fmt(prev);
        textEl.blur();
      }
    };
    return {
      setValue(v) {
        rangeEl.value = fmt(v);
        textEl.value = fmt(v);
        prev = v;
      },
    };
  }

  // free-text window size (reference Control.tsx:97-110 via
  // FloatingUserInput: blur commits only if edited, Escape cancels;
  // < 1 ms clamps to MIN_WIN_MILLISEC, garbage restores).  The FULL
  // precision value lives in winMsCurrent; the input only shows the
  // toFixed(1) display (the reference applies 12.345 and displays 12.3).
  const winMsEl = $("#win-ms");
  let winMsCurrent = parseFloat(winMsEl.value);
  if (Number.isNaN(winMsCurrent)) winMsCurrent = 40.0;
  winMsEl.value = winMsCurrent.toFixed(1);

  const applySpec = async () => {
    await api.setSpecSetting({
      winMillisec: winMsCurrent,
      tOverlap: Number($("#t-overlap").value),
      fOverlap: 1,
      freqScale: $("#freq-scale").value,
    });
    state.freqScale = $("#freq-scale").value;
    await persistSettings();
    await refreshAll();
    redraw();
  };

  let winMsEdited = false;
  const commitWinMs = (text) => {
    const r = L.winMillisecCommit(text, winMsCurrent);
    winMsEl.value = r.display;
    if (r.set === null) return;
    winMsCurrent = r.set;
    applySpec();
  };
  winMsEl.oninput = () => { winMsEdited = true; };
  winMsEl.onblur = () => {
    const text = winMsEdited ? winMsEl.value : null;
    winMsEdited = false;
    commitWinMs(text);
  };
  winMsEl.onchange = () => {
    // browsers fire change right before blur when the value was edited
    winMsEdited = false;
    commitWinMs(winMsEl.value);
  };
  winMsEl.onkeydown = (e) => {
    if (e.key === "Enter") {
      winMsEl.blur();
    } else if (e.key === "Escape") {
      // restore the display BEFORE blurring: real browsers fire `change`
      // ahead of `blur` for a user-edited input, and the change handler
      // commits whatever text is in the box
      winMsEdited = false;
      winMsEl.value = winMsCurrent.toFixed(1);
      winMsEl.blur();
    }
  };
  $("#t-overlap").onchange = applySpec;
  $("#freq-scale").onchange = applySpec;

  // dB range: step-1 slider + text with detents; double-click resets to
  // 100 (DB_RANGE_DETENTS[len-2], Control.tsx:293-303).  The reference
  // throttles ONLY setdBRange during the drag (Control.tsx:95); mirroring
  // that, the live path sends the throttled setDbRange + the light
  // metadata/colorbar refresh (serialized, latest value wins — overlapping
  // full refreshAll chains at 70 Hz flooded the engine, review finding);
  // the persist + full refresh land once at drag end.
  let dbLiveChain = null, dbLiveNext = null;
  const dbRangeLive = (v) => {
    dbLiveNext = v;
    if (dbLiveChain) return;
    dbLiveChain = (async () => {
      try {
        while (dbLiveNext !== null) {
          const next = dbLiveNext;
          dbLiveNext = null;
          try {
            await api.setDbRange(next);
            // quantize re-dispatch bumped revisions: viewports need the
            // new metadata to fetch re-ranged tiles; the colorbar shows
            // the range
            await Promise.all(
              [...state.viewports.values()].map((vp) => vp.refreshMetadata())
            );
            await updateColorbar();
          } catch (err) {
            // a transient failure mid-drag must not strand the pending
            // value as an unhandled rejection — surface it and keep
            // draining so the final value still applies
            showError(`dB range: ${err.message ?? err}`);
          }
          state.needsRedraw = true;
        }
      } finally {
        dbLiveChain = null;
      }
    })();
  };
  const applyDbRange = async (v) => {
    dbRangeLive(v);
    await dbLiveChain; // drain the drag chain before the full refresh
    await persistSettings();
    await refreshAll();
    redraw();
  };
  setupFloatRangeInput($("#db-range"), $("#db-range-val"), {
    precision: 0,
    doubleClickValue: L.DB_RANGE_DBLCLICK,
    onInput: throttled(1000 / 70, dbRangeLive),
    onChange: applyDbRange,
  });

  let blendPersist = null;
  const setBlend = (v) => {
    state.blend = v;
    clearTimeout(blendPersist);
    blendPersist = setTimeout(persistSettings, 500);
    redraw();
  };
  $("#blend").oninput = (e) => setBlend(Number(e.target.value));
  $("#blend").onclick = (e) => {
    // double-click / alt+click resets to 0.5 (Control.tsx:80-87)
    if (!L.floatRangeResetClick(e.button ?? 0, e.detail ?? 0, !!e.altKey)) return;
    e.preventDefault();
    e.target.value = "0.5";
    setBlend(0.5);
  };

  // deferred normalize/guard switches return at dispatch; refreshAll's
  // settled re-read (refreshAppliedWhenSettled) refetches the row text,
  // colorbar and overview bins once the background apply lands
  const applyNormalize = async (target) => {
    await api.setCommonNormalize(target);
    await persistSettings();
    await refreshAll();
    await rebuildAllRowInfo();
    redraw();
  };
  // per-family target memory (Control.tsx:63-68: PeakdB separate, init
  // 0.0; LUFS/RMSdB shared, init -18.0, seeded from the persisted
  // normalize restored into the controls by boot() only when its type is
  // exactly LUFS — the reference quirk: an RMSdB persist does NOT seed it)
  const normType0 = $("#norm-type").value;
  const normV0 = parseFloat($("#norm-target").value);
  const normMem = {
    peak: normType0 === "PeakdB" && !Number.isNaN(normV0)
      ? normV0 : L.NORMALIZE_PEAK_DEFAULT_DB,
    db: normType0 === "LUFS" && !Number.isNaN(normV0)
      ? normV0 : L.NORMALIZE_DB_DEFAULT,
  };
  const debouncedNormalize = debounced(250, applyNormalize);
  const normTargetInput = setupFloatRangeInput(
    $("#norm-target"), $("#norm-target-text"), {
      precision: 2,
      doubleClickValue: null,
      onChange: (value) => {
        // Control.tsx:160-166: ignored while Off; remember per family
        const type = $("#norm-type").value;
        if (type === "Off") return;
        if (type === "PeakdB") normMem.peak = value;
        else normMem.db = value;
        debouncedNormalize({ type, target: value });
      },
    }
  );
  const setNormTargetDisabled = (off) => {
    $("#norm-target").disabled = off;
    $("#norm-target-text").disabled = off;
    // disabled shows the range floor (Control.tsx:399-404 initialValue)
    if (off) normTargetInput.setValue(L.MIN_COMMON_NORMALIZE_DB);
  };
  setNormTargetDisabled(normType0 === "Off");
  if (normType0 !== "Off" && !Number.isNaN(normV0)) {
    normTargetInput.setValue(normV0);
  }
  $("#norm-type").onchange = () => {
    // Control.tsx:118-151: switching families restores that family's
    // remembered target; the backend call is debounced 250 ms
    const type = $("#norm-type").value;
    const target = L.normalizeSelectTarget(type, normMem.peak, normMem.db);
    setNormTargetDisabled(type === "Off");
    if (type !== "Off") normTargetInput.setValue(target.target);
    debouncedNormalize(target);
  };
  const applyGuard = async (mode) => {
    await api.setCommonGuardClipping(mode);
    await persistSettings();
    await refreshAll();
    await rebuildAllRowInfo();
    redraw();
  };
  // Control.tsx:171-178: guard mode select debounced 250 ms
  const debouncedGuard = debounced(250, applyGuard);
  $("#guard-mode").onchange = (e) => debouncedGuard(e.target.value);
}

// live engine timing panel fed by /debug/metrics (SURVEY §5 tracing)
let metricsTimer = null;

function setupMetricsPanel() {
  const toggle = $("#metrics-toggle");
  const panel = $("#metrics-panel");
  const refresh = async () => {
    try {
      const m = await fetch("/debug/metrics").then((r) => r.json())
        .then((j) => j.result);
      panel.textContent = Object.entries(m)
        .map(([k, v]) =>
          v && v.count !== undefined
            ? `${k}\n  n=${v.count} p50=${v.p50_ms}ms p95=${v.p95_ms}ms`
            : `${k}\n  ${JSON.stringify(v)}`)  // e.g. shape_warmer {compiled, idle}
        .join("\n") || "(no samples yet)";
    } catch {
      panel.textContent = "(metrics unavailable)";
    }
  };
  toggle.onclick = () => {
    panel.hidden = !panel.hidden;
    toggle.textContent = panel.hidden ? "Engine stats ▸" : "Engine stats ▾";
    clearInterval(metricsTimer);
    if (!panel.hidden) {
      refresh();
      metricsTimer = setInterval(refresh, 2000);
    }
  };
}

async function rebuildAllRowInfo() {
  for (const row of rowsEl.children) {
    const trackId = Number(row.dataset.trackId);
    const ch = Number(row.dataset.idCh.split("_")[1]);
    const nCh = await api.getChannelCounts(trackId);
    await updateRowInfo(row, trackId, ch, nCh);
  }
}

async function trackedSeek(sec) {
  // reference: usePlayer.ts:85-90 — every explicit seek is remembered so a
  // selection-driven track switch within 1 s starts from it
  const clamped = L.clampSelectSec(sec, state.maxSec);
  state.pendingSeek = { sec: clamped, atMs: performance.now() };
  await api.seekPlayer(clamped);
}

async function setPlayingTrack(trackId) {
  // reference: usePlayer.ts:92-110 (switch) + :120-130 (deselect effect)
  if (trackId === null || trackId < 0) {
    if (state.currentPlayingTrack !== -1) {
      state.currentPlayingTrack = -1;
      await api.seekPlayer(0);
      await api.pausePlayer();
      state.selectCursorSec = 0;
      pollPlayer();
    }
    return;
  }
  if (trackId === state.currentPlayingTrack) return;
  const startSec = L.playingTrackStartSec(
    state.pendingSeek, performance.now(), state.playerAnchor,
    state.selectCursorSec ?? 0, state.maxSec
  );
  state.pendingSeek = null;
  await api.setTrackPlayer(trackId, startSec);
  state.currentPlayingTrack = trackId;
  pollPlayer();
}

async function jumpBy(jumpSec) {
  // reference: usePlayer.ts:141-147 — playing: seek; paused: select cursor
  const pos = L.playerPosition(state.playerAnchor, performance.now());
  const res = L.jumpTargetSec(
    state.playing, pos, state.selectCursorSec ?? 0, jumpSec, state.maxSec
  );
  if (res.seekSec !== null) {
    await trackedSeek(res.seekSec);
    pollPlayer();
  } else {
    state.selectCursorSec = res.selectSec;
  }
  redraw();
}

async function rewindToFront() {
  // reference: usePlayer.ts:181-185
  if (state.playing) {
    await trackedSeek(0);
    pollPlayer();
  } else {
    state.selectCursorSec = 0;
  }
  redraw();
}

// remote audio: the AudioContext attaches as the player's output device and
// schedules the engine's PCM pulls (audioplayer.js; reference parity:
// src-tauri/src/player/stream.rs:501-639).  Created lazily inside the play
// gesture — browsers only allow AudioContexts from user gestures.
const audio = createAudioPlayer();

async function togglePlay() {
  // reference: usePlayer.ts:112-118 — play always starts from the select
  // cursor; with nothing selected, select the first track (our convenience —
  // the reference's space is a no-op there, but its App auto-selects on add)
  if (state.playing) {
    await api.pausePlayer();
  } else {
    if (state.selectedTrack === null && state.trackIds.length) {
      selectOnly(state.trackIds[0]);
    }
    // an errored selection maps to "no playing track" (App.tsx:71-73), and
    // the reference's togglePlay is a no-op there (usePlayer.ts:112-118)
    if (
      state.selectedTrack !== null &&
      !state.erroredTracks.includes(state.selectedTrack)
    ) {
      await syncPlayerToSelection(); // no-op when already on the track
      await trackedSeek(state.selectCursorSec ?? 0);
      // attach/resume the AudioContext INSIDE the gesture, before resume —
      // the first pulls race the resume harmlessly (a paused server returns
      // silence without advancing position)
      await audio.ensureStarted();
      await api.resumePlayer();
      audio.setPlaying(true);
    }
  }
  pollPlayer();
}

// ---------------------------------------------------------------------------
// boot

(async function boot() {
  const colormap = await fetch("/api/get_default_colormap", { method: "POST" })
    .then((r) => r.json()).then((j) => j.result);
  colormapRgba = colormap;
  const initRes = await api.init(colormap);
  // restore persisted user settings into the controls
  // (reference: main.tsx passes ConstsAndUserSettings into App)
  const us = initRes?.userSettings;
  if (us) {
    if (us.specSetting) {
      // full precision: setupControls() captures this into winMsCurrent
      // and then formats the visible display to one decimal
      $("#win-ms").value = String(us.specSetting.winMillisec ?? 40);
      $("#t-overlap").value = String(us.specSetting.tOverlap ?? 4);
      $("#freq-scale").value = us.specSetting.freqScale ?? "Mel";
      state.freqScale = $("#freq-scale").value;
    }
    if (us.dBRange !== undefined) {
      $("#db-range").value = String(us.dBRange);
      $("#db-range-val").value = us.dBRange.toFixed(0);
    }
    if (us.blend !== undefined) {
      state.blend = us.blend;
      $("#blend").value = String(us.blend);
    }
    if (us.commonGuardClipping) $("#guard-mode").value = us.commonGuardClipping;
    if (us.commonNormalize) {
      $("#norm-type").value = us.commonNormalize.type ?? "Off";
      if (us.commonNormalize.target !== undefined) {
        $("#norm-target").value = String(us.commonNormalize.target);
        $("#norm-target-text").value = us.commonNormalize.target.toFixed(2);
      }
      // setupControls() seeds its per-family memory + disabled state from
      // these restored values
    }
  }
  // overview lens callbacks route through the reference's moveLens /
  // resizeLensLeft / resizeLensRight normalize pipeline
  // (MainViewer.tsx:394-412 via applogic)
  overview = new Overview($("#overview"));
  overview.onMoveLens = (sec, anchorRatio) => {
    leaveFit();
    setLens({
      startSec: L.moveLensStartSec(sec, anchorRatio, state.pxPerSec, viewWidth()),
    });
    redraw();
  };
  overview.onResizeLensLeft = (sec) => {
    leaveFit();
    if (state.playing) state.needFollowCursor = false;
    const cur = { startSec: state.startSec, pxPerSec: state.pxPerSec };
    const out = L.resizeLensLeft(cur, sec, state.maxSec, viewWidth());
    state.startSec = out.startSec;
    state.pxPerSec = out.pxPerSec;
    redraw();
  };
  overview.onResizeLensRight = (sec) => {
    leaveFit();
    if (state.playing) state.needFollowCursor = false;
    const cur = { startSec: state.startSec, pxPerSec: state.pxPerSec };
    const out = L.resizeLensRight(cur, sec, state.maxSec, viewWidth());
    state.startSec = out.startSec;
    state.pxPerSec = out.pxPerSec;
    redraw();
  };
  await setupControls();
  setupSplitter();
  setupFileDrop();
  setupMetricsPanel();
  connectEvents();
  pollPlayer();
  // argv/file-association paths (reference: open-audio-tracks event)
  try {
    const pending = await fetch("/pending_open_paths").then((r) => r.json())
      .then((j) => j.result);
    if (pending && pending.length) await addPaths(pending);
  } catch { /* none */ }
  window.addEventListener("resize", () => {
    if (state.fitMode) applyFit();
    redraw();
  });
  requestAnimationFrame(renderFrame);
})();
