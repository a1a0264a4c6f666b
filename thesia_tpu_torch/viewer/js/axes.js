// Axis canvases: time axis (top) and per-track frequency axes.
// Marker computation is served by the backend axis API (the reference
// computes these client-side in WASM; same functions, same outputs).

import { api } from "./api.js";

// Tick scale tables, values IDENTICAL to the reference's
// (reference: src/prototypes/constants/tracks.ts:47-80 TIME_TICK_SIZE,
// :90-125 AMP_TICK_NUM, :135-155 FREQ_TICK_NUM, :169-175 DB_TICK_NUM).
// Lookup rule mirrors useAxisMarkers.ts getTickScale: boundaries DESC,
// first boundary <= value wins; below the smallest boundary -> no markers.
// Entries: [boundary, a, b] where (a, b) = (minor tick sec, subtick count)
// for time and (max ticks, max labels) for the vertical axes.
export const TIME_TICK_SIZE = [
  [309128, 0.0001, 10], [234256, 0.0002, 5], [159384, 0.0005, 2],
  [84512.5, 0.001, 1], [44960.7, 0.001, 2], [16902.5, 0.001, 5],
  [7635.0, 0.002, 5], [4061.0, 0.01, 2], [1527.0, 0.01, 5],
  [681.875, 0.02, 5], [362.757, 0.1, 2], [136.375, 0.1, 5],
  [57.0, 0.2, 5], [30.324, 1, 2], [11.4, 1, 5], [5.7, 2, 5],
  [3.0324, 10, 2], [2.28, 10, 3], [0.73325, 10, 6], [0.32507, 60, 2],
  [0.12221, 60, 5], [0.0611, 120, 5], [0.03251, 600, 2],
  [0.02444, 600, 3], [0.00544, 600, 6], [0.00241, 3600, 2],
  [0.00091, 3600, 5],
];

export const AMP_TICK_NUM = [
  [3500, 203, 203], [2000, 101, 101], [1210, 65, 65], [1185, 63, 63],
  [1165, 61, 61], [1070, 59, 59], [1035, 57, 57], [995, 55, 55],
  [985, 53, 53], [940, 51, 51], [920, 49, 49], [835, 47, 47],
  [790, 45, 45], [765, 43, 43], [740, 41, 41], [660, 39, 39],
  [635, 37, 37], [610, 35, 35], [590, 33, 33], [560, 31, 31],
  [530, 29, 29], [505, 27, 27], [495, 25, 25], [480, 25, 25],
  [405, 23, 23], [340, 21, 21], [320, 19, 19], [305, 17, 17],
  [300, 15, 15], [230, 13, 13], [80, 5, 5],
];

export const FREQ_TICK_NUM = [
  [1500, 100, 60], [1000, 60, 40], [850, 50, 30], [700, 40, 25],
  [600, 30, 20], [500, 28, 18], [450, 25, 16], [400, 22, 14],
  [360, 18, 12], [320, 15, 10], [280, 14, 9], [240, 12, 8],
  [200, 11, 7], [150, 10, 6], [120, 9, 5], [100, 6, 4],
  [90, 6, 3], [80, 4, 2],
];

export const DB_TICK_NUM = [
  [1000, 60, 60], [520, 25, 25], [250, 13, 13], [120, 6, 6], [80, 4, 4],
];

export function tickScale(table, value) {
  for (const [boundary, a, b] of table) {
    if (value >= boundary) return [a, b];
  }
  return null;
}

export function timeTickParams(pxPerSec) {
  const scale = tickScale(TIME_TICK_SIZE, pxPerSec);
  if (!scale) return null;
  return { tickUnit: scale[0], labelInterval: scale[1] };
}

export function drawMarkersH(canvas, markers, startFrac = 0) {
  // horizontal axis: marker position is 0..1 fraction of visible range
  const dpr = window.devicePixelRatio || 1;
  const w = canvas.clientWidth, h = canvas.clientHeight;
  canvas.width = w * dpr;
  canvas.height = h * dpr;
  const ctx = canvas.getContext("2d");
  ctx.setTransform(dpr, 0, 0, dpr, 0, 0);
  ctx.clearRect(0, 0, w, h);
  ctx.strokeStyle = "#4a4f5a";
  ctx.fillStyle = "#9aa0ac";
  ctx.font = "10px system-ui";
  ctx.textBaseline = "top";
  for (const [pos, label] of markers) {
    if (pos < -1e6) continue; // sentinel element
    const x = pos * w;
    if (x < -40 || x > w + 40) continue;
    ctx.beginPath();
    ctx.moveTo(x, h - (label ? 8 : 4));
    ctx.lineTo(x, h);
    ctx.stroke();
    if (label) ctx.fillText(label, x + 2, 2);
  }
}

export function drawMarkersV(canvas, markers) {
  // vertical axis: position 0 = top, 1 = bottom
  const dpr = window.devicePixelRatio || 1;
  const w = canvas.clientWidth, h = canvas.clientHeight;
  canvas.width = w * dpr;
  canvas.height = h * dpr;
  const ctx = canvas.getContext("2d");
  ctx.setTransform(dpr, 0, 0, dpr, 0, 0);
  ctx.clearRect(0, 0, w, h);
  ctx.strokeStyle = "#4a4f5a";
  ctx.fillStyle = "#9aa0ac";
  ctx.font = "9px system-ui";
  ctx.textBaseline = "middle";
  ctx.textAlign = "right";
  for (const [pos, label] of markers) {
    const y = Math.min(Math.max(pos * h, 1), h - 1);
    ctx.beginPath();
    ctx.moveTo(w - (label ? 6 : 3), y);
    ctx.lineTo(w, y);
    ctx.stroke();
    if (label) ctx.fillText(label, w - 8, y);
  }
}

// per-canvas fetch sequence: an earlier in-flight marker response that
// resolves AFTER a later one must not repaint the axis with stale ticks
// (continuous zoom fires a fetch every ~14 ms against a thread pool that
// can reorder responses)
const axisSeq = new WeakMap();

function bumpSeq(canvas) {
  const n = (axisSeq.get(canvas) || 0) + 1;
  axisSeq.set(canvas, n);
  return n;
}

// last markers drawn per canvas: hover tooltips derive their formatDisplay
// (time axis, reference TimeAxis.tsx:81) and tick unit (linear axes,
// reference wasm-wrapper.ts:139-147) from what is actually on screen
const lastMarkersMap = new WeakMap();

export function setLastAxisMarkers(canvas, markers) {
  lastMarkersMap.set(canvas, markers);
}

export function lastAxisMarkers(canvas) {
  return lastMarkersMap.get(canvas) || [];
}

export async function updateTimeAxis(canvas, startSec, pxPerSec, maxSec) {
  const w = canvas.clientWidth;
  const endSec = startSec + w / pxPerSec;
  const params = timeTickParams(pxPerSec);
  if (!params) { setLastAxisMarkers(canvas, []); return drawMarkersH(canvas, []); }
  const seq = bumpSeq(canvas);
  const markers = await api.calcTimeAxisMarkers(
    startSec, endSec, params.tickUnit, params.labelInterval, maxSec
  );
  if (axisSeq.get(canvas) !== seq) return; // superseded while in flight
  setLastAxisMarkers(canvas, markers);
  drawMarkersH(canvas, markers);
}

export async function updateAmpAxis(canvas, ampRange = [-1, 1]) {
  const scale = tickScale(AMP_TICK_NUM, canvas.clientHeight);
  if (!scale) { setLastAxisMarkers(canvas, []); return drawMarkersV(canvas, []); }
  const seq = bumpSeq(canvas);
  const markers = await api.calcAmpAxisMarkers(
    scale[0], scale[1], ampRange[0], ampRange[1]
  );
  if (axisSeq.get(canvas) !== seq) return;
  setLastAxisMarkers(canvas, markers);
  drawMarkersV(canvas, markers);
}

export async function updateFreqAxis(canvas, hzRange, freqScale, maxTrackHz) {
  const scale = tickScale(FREQ_TICK_NUM, canvas.clientHeight);
  if (!scale) { setLastAxisMarkers(canvas, []); return drawMarkersV(canvas, []); }
  const seq = bumpSeq(canvas);
  const markers = await api.calcFreqAxisMarkers(
    hzRange[0], hzRange[1], freqScale, scale[0], scale[1], maxTrackHz
  );
  if (axisSeq.get(canvas) !== seq) return;
  setLastAxisMarkers(canvas, markers);
  drawMarkersV(canvas, markers);
}
