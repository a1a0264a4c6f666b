// Overview strip: whole-track waveform of the selected track, limiter gain
// envelope band, and a draggable lens showing the visible range.
// reference: src/prototypes/Overview/OverviewWaveformViewport.tsx.

import { api } from "./api.js";
import * as L from "./applogic.js";
import { setLastAxisMarkers } from "./axes.js";

const GAIN_COLOR = "#da972e"; // OverviewWaveformViewport.tsx:22
const WAVE_COLOR = "#1389eb"; // waveform-renderer.ts:7 WAV_COLOR
const CLIP_COLOR = "#c42232"; // waveform-renderer.ts:8 WAV_CLIPPING_COLOR
const OUT_TRACK_FILL = "rgba(0, 0, 0, 0.2)"; // OverviewWaveformViewport.tsx:23-24
const LENS_FILL = "rgba(255,255,255,0.08)";
const LENS_EDGE = "rgba(255,255,255,0.35)";

export class Overview {
  constructor(canvas) {
    this.canvas = canvas;
    this.ctx = canvas.getContext("2d");
    this.trackId = null;
    this.idChStr = null;
    this.metadata = null;
    this.bins = null; // [Float32Array of (min,max,mean)*N] per channel lane
    this.gain = null;
    // reference Overview.tsx handler trio: inside/outside the lens moves it
    // (anchored at the grab fraction), edges resize through the
    // MainViewer's normalize pipeline (resizeLensLeft/Right)
    this.onMoveLens = () => {}; // (sec, anchorRatio)
    this.onResizeLensLeft = () => {}; // (sec)
    this.onResizeLensRight = () => {}; // (sec)
    this._drag = null; // {state, anchorRatio}
    this._lens = { startSec: 0, durationSec: 0 }; // set each draw()
    canvas.addEventListener("mousemove", (e) => {
      if (this._drag) return;
      const s = this._cursorState(e);
      canvas.style.cursor =
        s === "left" || s === "right" ? "col-resize" : "ew-resize";
    });
    canvas.addEventListener("mousedown", (e) => {
      if (!this.metadata) return;
      const rect = this.canvas.getBoundingClientRect();
      const cursorState = this._cursorState(e);
      const anchorRatio = L.overviewDragAnchor(
        cursorState, e.clientX - rect.left, rect.width || 1,
        this._timelineSec(), this._lens.startSec, this._lens.durationSec
      );
      this._drag = { state: cursorState, anchorRatio };
      this._applyDrag(e);
    });
    window.addEventListener("mousemove", (e) => {
      if (this._drag) this._applyDrag(e);
    });
    window.addEventListener("mouseup", () => (this._drag = null));
  }

  _timelineSec() {
    // the overview x axis spans the LONGEST track (reference:
    // Overview.tsx:49-52 pxPerSec = width / maxTrackSec), not the
    // selected track's own length
    return Math.max(this._maxSec ?? this.metadata?.trackSec ?? 1, 1e-8);
  }

  _cursorState(e) {
    // reference: Overview.tsx:158-173 (left | inlens | right | outlens)
    const rect = this.canvas.getBoundingClientRect();
    const pxPerSec = (rect.width || 1) / this._timelineSec();
    return L.overviewCursorState(
      e.clientX - rect.left, this._lens.startSec, this._lens.durationSec, pxPerSec
    );
  }

  _applyDrag(e) {
    if (!this.metadata || !this._drag) return;
    const rect = this.canvas.getBoundingClientRect();
    const sec = L.overviewSecFromX(
      e.clientX - rect.left, rect.width || 1, this._timelineSec()
    );
    if (this._drag.state === "left") this.onResizeLensLeft(sec);
    else if (this._drag.state === "right") this.onResizeLensRight(sec);
    else this.onMoveLens(sec, this._drag.anchorRatio);
  }

  async setTrack(trackId, force = false, maxSec = null) {
    if (maxSec) this._maxSec = maxSec;
    if (trackId === this.trackId && !force && this.bins) return; // no refetch
    const gen = (this._gen = (this._gen || 0) + 1); // kill in-flight races
    this.trackId = trackId;
    if (trackId === null) {
      this.metadata = this.bins = this.gain = null;
      return;
    }
    this.idChStr = `${trackId}_0`;
    const metadata = await api.getMetadata(this.idChStr);
    if (gen !== this._gen) return;
    this.metadata = metadata;
    if (!this.metadata) return;
    // up to OVERVIEW_MAX_CH stacked channel lanes
    // (reference: constants/tracks.ts:211, OverviewWaveformViewport.tsx)
    const nCh = Math.min(
      await api.getChannelCounts(trackId).catch(() => 1), L.OVERVIEW_MAX_CH
    );
    const width = this.canvas.clientWidth || 600;
    // bins-per-pixel ~1 over the track's actual span: the x axis covers
    // the LONGEST track, so a short track occupies only its share of the
    // canvas (reference derives the level from pxPerSec = width/maxTrackSec,
    // OverviewWaveformViewport.tsx:384,396)
    const trackWidth = Math.max(
      1, width * (this.metadata.trackSec / this._timelineSec())
    );
    const level = L.overviewWaveLevel(this.metadata.sampleCount, trackWidth);
    if (
      force && this.bins && this._binsKey
      && this._binsKey.trackId === trackId
      && this._binsKey.revision === metadata.waveformRevision
      && this._binsKey.level === level
    ) {
      // forced refresh (refreshAll after a spec/dB change) but the
      // waveform data is unchanged — the revision only bumps on
      // normalize/guard/reload.  Re-downloading the bins AND the
      // per-sample limiter gain JSON on every settings change was the
      // overview's biggest wire cost (review finding).
      return;
    }
    const spb = 1 << level;
    const tileSamples = 1024 * spb;
    const nTiles = Math.ceil(this.metadata.sampleCount / tileSamples);
    const bins = await Promise.all(
      Array.from({ length: nCh }, async (_, ch) => {
        const parts = await Promise.all(
          Array.from({ length: nTiles }, (_x, i) =>
            api.getWaveformTile(`${trackId}_${ch}`, level, i)
          )
        );
        const total = parts.reduce((a, p) => a + p.binCount, 0);
        const chBins = new Float32Array(total * 3);
        let off = 0;
        for (const p of parts) {
          chBins.set(p.bins, off);
          off += p.binCount * 3;
        }
        return chBins;
      })
    );
    const gain = await api.getLimiterGain(trackId).catch(() => null);
    if (gen !== this._gen) return;
    this.bins = bins;
    this.gain = gain;
    this._binsKey = {
      trackId, revision: this.metadata.waveformRevision, level,
    };
  }

  draw(viewStartSec, viewWidthSec, maxSec) {
    const { canvas, ctx } = this;
    const dpr = window.devicePixelRatio || 1;
    const w = canvas.clientWidth, h = canvas.clientHeight;
    if (canvas.width !== w * dpr || canvas.height !== h * dpr) {
      canvas.width = w * dpr;
      canvas.height = h * dpr;
    }
    ctx.setTransform(dpr, 0, 0, dpr, 0, 0);
    ctx.fillStyle = "#111317";
    ctx.fillRect(0, 0, w, h);
    if (!this.metadata || !this.bins || !this.bins.length) return;
    this._maxSec = maxSec || this.metadata.trackSec;
    const pxPerSec = w / this._timelineSec();
    // reference: OverviewWaveformViewport.tsx:383-417 — stacked lanes
    // with gaps, the gain band carving the lane top+bottom, ONE shared
    // amp range, a clipping-colored unclamped pass under the waveform,
    // and the out-of-track region dimmed
    const trackWidth = Math.min(this.metadata.trackSec * pxPerSec, w);
    const nCh = this.bins.length;
    const hasGain = !!(this.gain && this.gain.length > 1);
    const isClipped = !!this.metadata.isClipped;
    // geometry cache: draw() runs every animation frame while playing, but
    // only the LENS changes between frames — recomputing the limiter-gain
    // envelopes (O(n_samples): the gain sequence is per-sample) and the
    // wave polygons each frame stuttered playback on Limiter-mode tracks
    // (review finding; the reference retains its drawn layer).  Keyed on
    // geometry + the data arrays' identity (setTrack replaces them).
    const key = `${w}:${h}:${trackWidth}:${nCh}:${hasGain}:${isClipped}`;
    let sc = this._scene;
    if (!sc || sc.key !== key || sc.bins !== this.bins || sc.gain !== this.gain) {
      const lanes = L.overviewLaneLayout(nCh, h, hasGain);
      const ampRange = L.ampRangeFromBins(this.bins);
      const waves = [];
      for (let ch = 0; ch < nCh; ch++) {
        const lane = lanes[ch];
        waves.push({
          lane,
          // unclamped pass in the clipping color peeks out wherever the
          // clamped waveform saturates (OverviewWaveformViewport.tsx:453-463)
          clipPts: isClipped
            ? L.overviewWavePoints(this.bins[ch], lane, trackWidth, ampRange, false)
            : null,
          pts: L.overviewWavePoints(
            this.bins[ch], lane, trackWidth, ampRange, isClipped
          ),
          gainEnvs: hasGain && lane.gainHeight > 0
            ? L.calcLimiterGainEnvelopes(
                this.gain, trackWidth, lane.gainHeight, [0.5, 1]
              )
            : null,
        });
      }
      sc = this._scene = { key, bins: this.bins, gain: this.gain, waves };
    }
    for (const wv of sc.waves) {
      if (wv.gainEnvs) this._drawGainBands(wv.lane, wv.gainEnvs);
      if (wv.clipPts) {
        ctx.fillStyle = CLIP_COLOR;
        this._fillPath(wv.clipPts);
      }
      ctx.fillStyle = WAVE_COLOR;
      this._fillPath(wv.pts);
    }
    if (trackWidth < w) {
      ctx.fillStyle = OUT_TRACK_FILL;
      ctx.fillRect(trackWidth, 0, w - trackWidth, h);
    }
    // lens
    this._lens = { startSec: viewStartSec, durationSec: viewWidthSec };
    const x0 = viewStartSec * pxPerSec;
    const x1 = (viewStartSec + viewWidthSec) * pxPerSec;
    ctx.fillStyle = LENS_FILL;
    ctx.fillRect(x0, 0, Math.max(x1 - x0, 2), h);
    ctx.strokeStyle = LENS_EDGE;
    ctx.strokeRect(x0 + 0.5, 0.5, Math.max(x1 - x0, 2) - 1, h - 1);
  }

  _drawGainBands(lane, envelopes) {
    // reference: OverviewWaveformViewport.tsx:123-143 drawLimiterGain —
    // each sub-unity envelope painted hanging from the lane's top band
    // and mirrored rising from the bottom band, over gainRange [0.5, 1]
    const { ctx } = this;
    ctx.fillStyle = GAIN_COLOR;
    const yAbove = lane.y - lane.gainHeight;
    const yBelow = lane.y + lane.height;
    for (const env of envelopes) {
      this._fillPath(env.map(([x, y]) => [x, y + yAbove]));
      this._fillPath(env.map(([x, y]) => [x, yBelow + lane.gainHeight - y]));
    }
  }

  _fillPath(points) {
    if (points.length < 2) return;
    const { ctx } = this;
    ctx.beginPath();
    for (let i = 0; i < points.length; i++) {
      if (i === 0) ctx.moveTo(points[i][0], points[i][1]);
      else ctx.lineTo(points[i][0], points[i][1]);
    }
    ctx.closePath();
    ctx.fill();
  }
}

// dB colorbar: vertical colormap gradient + dB axis labels.
// reference: src/prototypes/MainViewer/ColorBarCanvas.tsx.
export async function drawColorbar(canvas, colormap, minDb, maxDb) {
  const dpr = window.devicePixelRatio || 1;
  const w = canvas.clientWidth, h = canvas.clientHeight;
  canvas.width = w * dpr;
  canvas.height = h * dpr;
  const ctx = canvas.getContext("2d");
  ctx.setTransform(dpr, 0, 0, dpr, 0, 0);
  const barW = 12;
  const n = colormap.length / 4;
  for (let y = 0; y < h; y++) {
    // top = max dB = end of colormap (skipping the reserved black at 0)
    const idx = L.colorbarColorIndex(y, h, n);
    ctx.fillStyle = `rgb(${colormap[idx * 4]},${colormap[idx * 4 + 1]},${colormap[idx * 4 + 2]})`;
    ctx.fillRect(0, y, barW, 1);
  }
  if (isFinite(minDb) && isFinite(maxDb) && maxDb > minDb) {
    const { DB_TICK_NUM, tickScale } = await import("./axes.js");
    const scale = tickScale(DB_TICK_NUM, h) || [4, 4];
    const markers = await api.calcDbAxisMarkers(scale[0], scale[1], minDb, maxDb);
    setLastAxisMarkers(canvas, markers); // dB tooltip reads the drawn ticks
    ctx.fillStyle = "#9aa0ac";
    ctx.font = "9px system-ui";
    ctx.textBaseline = "middle";
    for (const [pos, label] of markers) {
      const y = Math.min(Math.max(pos * h, 5), h - 5);
      ctx.strokeStyle = "#4a4f5a";
      ctx.beginPath();
      ctx.moveTo(barW, y);
      ctx.lineTo(barW + 4, y);
      ctx.stroke();
      if (label) ctx.fillText(label, barW + 6, y);
    }
  } else {
    setLastAxisMarkers(canvas, []); // no ticks drawn -> no tooltip tick unit
  }
}
