// Per-track viewport rendering: spectrogram tile compositing + waveform
// rendering, LOD selection, byte-budgeted shared caches, LOD crossfade,
// scrim blend compositing.
// Design follows the reference compositor (src/modules/AudioTrackViewport.tsx:
// LOD math :385-476, crossfade :30-35,642-684, scrim blend :30-35; waveform
// mesh styling src/lib/waveform-renderer.ts:6-11,227-407) with a 2D-canvas
// backend instead of PixiJS: like the reference's single WebGL canvas over
// all rows (AudioTrackViewport.tsx:93+), ONE shared Compositor canvas draws
// every visible row — one dpr-scaled backing store and one present pass per
// frame instead of one per row, with visible-row culling.

import { api } from "./api.js";
import { pendingFetches, specTileCache, waveTileCache } from "./caches.js";
import { relativeFreqPos } from "./freqscale.js";

const TILE = 512;
const WAVE_BINS = 1024;
const WAVE_COLOR = "#1389eb"; // waveform-renderer.ts:7 WAV_COLOR
const WAVE_LINE_COLOR = "#7cc0f2"; // representative mid line (lighter)
const CLIP_COLOR = "#c42232"; // waveform-renderer.ts:8 WAV_CLIPPING_COLOR
const CLIP_LINE_COLOR = "#f2948f";
const CROSSFADE_MS = 200; // reference: AudioTrackViewport.tsx:30-35
// a run of this many polls whose fetch failed ends _watchComputing (the
// engine is gone); a poll that reads the metadata resets the run
const WATCH_MAX_FAILED_POLLS = 30;

// ONE canvas composites every visible row's viewport.  Absolutely
// positioned over the scrolling rows pane with pointer-events: none, so
// hit-testing stays on the per-row .viewport divs; rows scrolled out of
// view are culled (reference culls rows the same way).
export class Compositor {
  constructor(canvas, rowsEl) {
    this.canvas = canvas;
    this.ctx = canvas.getContext("2d");
    this.rowsEl = rowsEl;
  }

  // drawRow(ctx, rowEl, w, h, dpr) is called once per visible row with the
  // context translated to the row's viewport origin and clipped to its rect.
  render(drawRow) {
    const { canvas, ctx, rowsEl } = this;
    const dpr = window.devicePixelRatio || 1;
    // clientWidth/Height exclude the scrollbar, so the overlay never covers it
    const w = rowsEl.clientWidth, h = rowsEl.clientHeight;
    canvas.style.left = `${rowsEl.offsetLeft}px`;
    canvas.style.top = `${rowsEl.offsetTop}px`;
    canvas.style.width = `${w}px`;
    canvas.style.height = `${h}px`;
    const bw = Math.max(1, Math.round(w * dpr));
    const bh = Math.max(1, Math.round(h * dpr));
    if (canvas.width !== bw || canvas.height !== bh) {
      canvas.width = bw;
      canvas.height = bh;
    }
    ctx.setTransform(dpr, 0, 0, dpr, 0, 0);
    ctx.clearRect(0, 0, w, h);
    const host = rowsEl.getBoundingClientRect();
    for (const row of rowsEl.children) {
      const vpEl = row.querySelector(".viewport");
      if (!vpEl) continue;
      const r = vpEl.getBoundingClientRect();
      const x = r.left - host.left, y = r.top - host.top;
      if (y + r.height <= 0 || y >= h || r.width <= 0 || r.height <= 0) continue;
      ctx.save();
      ctx.translate(x, y);
      ctx.beginPath();
      ctx.rect(0, 0, r.width, r.height);
      ctx.clip();
      drawRow(ctx, row, r.width, r.height, dpr);
      ctx.restore();
    }
  }
}

export class TrackViewport {
  constructor(idChStr) {
    this.idChStr = idChStr;
    this.metadata = null;
    this.onNeedsRedraw = () => {};
    this._waveFade = null; // {fromLevel, start}
    this._lastWaveLevel = null;
  }

  async refreshMetadata() {
    // retry while spectrogram is still computing (reference retries 20x100ms;
    // our engine additionally reports isComputing while the image streams
    // from the device, so long tracks keep polling with backoff instead of
    // sitting empty after 2 s)
    let delay = 100;
    for (let i = 0; i < 60; i++) {
      this.metadata = await api.getMetadata(this.idChStr);
      if (!this.metadata) return;
      if (this.metadata.spectrogramWidth > 0) break;
      if (i >= 19 && !this.metadata.isComputing) break;
      await new Promise((r) => setTimeout(r, delay));
      delay = Math.min(delay * 1.25, 2000);
    }
    const md = this.metadata;
    // drop stale revisions for this row (server bumped on settings change)
    const specPrefix = `${this.idChStr}:`;
    specTileCache.retain(
      (k) => !k.startsWith(specPrefix) || k.startsWith(`${specPrefix}${md.spectrogramRevision}:`)
    );
    waveTileCache.retain(
      (k) => !k.startsWith(specPrefix) || k.startsWith(`${specPrefix}${md.waveformRevision}:`)
    );
    // deferred settings switch / background image stream: keep polling so
    // this row adopts the NEW revision (and repaints) when the engine's
    // isComputing flips false — the switch itself returns at dispatch
    if (md.isComputing) this._watchComputing();
  }

  _watchComputing() {
    const gen = (this._computingGen = (this._computingGen || 0) + 1);
    const FAILED = Symbol("fetch-failed");
    let failedPolls = 0;
    const poll = async (delay) => {
      if (gen !== this._computingGen) return; // a newer refresh took over
      // a transient fetch error must RETRY with backoff, not kill the only
      // poll loop mid-switch (distinct from a null result = track removed)
      const md = await api.getMetadata(this.idChStr).catch(() => FAILED);
      if (gen !== this._computingGen) return;
      if (md === FAILED) {
        failedPolls += 1;
        if (failedPolls >= WATCH_MAX_FAILED_POLLS) return; // stop polling
        setTimeout(() => poll(Math.min(delay * 1.25, 2000)), delay);
        return;
      }
      failedPolls = 0;
      if (!md) return; // track gone: stop
      const changed =
        !this.metadata ||
        md.spectrogramRevision !== this.metadata.spectrogramRevision ||
        md.waveformRevision !== this.metadata.waveformRevision ||
        md.isComputing !== this.metadata.isComputing;
      this.metadata = md;
      if (changed) {
        const specPrefix = `${this.idChStr}:`;
        specTileCache.retain(
          (k) => !k.startsWith(specPrefix) || k.startsWith(`${specPrefix}${md.spectrogramRevision}:`)
        );
        waveTileCache.retain(
          (k) => !k.startsWith(specPrefix) || k.startsWith(`${specPrefix}${md.waveformRevision}:`)
        );
        this.onNeedsRedraw();
      }
      if (md.isComputing) {
        setTimeout(() => poll(Math.min(delay * 1.25, 2000)), delay);
      }
    };
    setTimeout(() => poll(400), 250);
  }

  // ---- LOD math (reference: AudioTrackViewport.tsx:385-476) ----
  specLevels(pxPerSec, viewH, rowsVisibleFrac) {
    const md = this.metadata;
    const basePxPerSec = md.spectrogramWidth / md.trackSec;
    const levelX = Math.max(0, Math.floor(Math.log2(basePxPerSec / pxPerSec)));
    const visibleRows = Math.max(md.spectrogramHeight * rowsVisibleFrac, 1);
    // floor like the reference's log2Level (AudioTrackViewport.tsx:91) —
    // ceil picked a one-level-coarser (blurrier) vertical LOD whenever the
    // ratio wasn't an exact power of two
    const levelY = Math.max(0, Math.floor(Math.log2(Math.max(visibleRows / Math.max(viewH, 1), 1))));
    return { levelX, levelY, basePxPerSec };
  }

  waveLevel(pxPerSec, dpr) {
    // reference: waveform-renderer.ts:44-50 (level 0 while near-per-sample)
    const md = this.metadata;
    const samplesPerPx = md.sampleRate / (pxPerSec * dpr);
    if (pxPerSec * 2 * dpr >= md.sampleRate / 2) return 0;
    if (samplesPerPx <= 2) return 0;
    return Math.max(0, Math.ceil(Math.log2(samplesPerPx)));
  }

  _specKey(md, lx, ly, tx, ty) {
    return `${this.idChStr}:${md.spectrogramRevision}:${lx}:${ly}:${tx}:${ty}`;
  }

  _waveKey(md, level, ti) {
    return `${this.idChStr}:${md.waveformRevision}:${level}:${ti}`;
  }

  async fetchSpecTile(levelX, levelY, tileX, tileY) {
    const md = this.metadata;
    const key = this._specKey(md, levelX, levelY, tileX, tileY);
    if (specTileCache.has(key) || pendingFetches.has(key)) return;
    pendingFetches.add(key);
    try {
      const t = await api.getSpectrogramTile(this.idChStr, levelX, levelY, tileX, tileY);
      if (t.width === 0 || t.height === 0 || t.revision !== BigInt(md.spectrogramRevision)) {
        return;
      }
      const img = new ImageData(t.rgba.slice(0, t.width * t.height * 4), t.width, t.height);
      t.bitmap = await createImageBitmap(img);
      t.rgba = null; // CPU copy released after upload (reference GPU cache)
      specTileCache.set(key, t, t.width * t.height * 4);
      this.onNeedsRedraw();
    } catch {
      /* transient */
    } finally {
      pendingFetches.delete(key);
    }
  }

  async fetchWaveTile(level, tileIndex) {
    const md = this.metadata;
    const key = this._waveKey(md, level, tileIndex);
    if (waveTileCache.has(key) || pendingFetches.has(key)) return;
    pendingFetches.add(key);
    try {
      const t = await api.getWaveformTile(this.idChStr, level, tileIndex);
      // revision guard like the spectrogram path: a settings change can
      // bump the revision while this fetch is in flight — caching the new
      // bytes under the old-revision key would mix old and new waveforms
      if (t.revision !== BigInt(md.waveformRevision)) return;
      waveTileCache.set(key, t, t.binCount * 12 + 24);
      this.onNeedsRedraw();
    } catch {
      /* transient */
    } finally {
      pendingFetches.delete(key);
    }
  }

  // ---- drawing ----
  draw(ctx, w, h, dpr, view) {
    // view: {startSec, pxPerSec, blend, hzRange, maxTrackHz, freqScale,
    //        ampRange}; ctx is the shared Compositor context, already
    // translated to this row's viewport origin and clipped to (w, h)
    ctx.fillStyle = "#0c0d10";
    ctx.fillRect(0, 0, w, h);
    if (!this.metadata || this.metadata.trackSec === 0) {
      // loading state (reference: AudioTrackViewport loading spinner)
      ctx.fillStyle = "#7b8190";
      ctx.font = "12px system-ui";
      ctx.textAlign = "center";
      ctx.fillText("computing spectrogram…", w / 2, h / 2);
      ctx.textAlign = "start";
      return;
    }

    const blend = view.blend ?? 0.5;
    // scrim compositing (reference AudioTrackViewport.tsx:30-35):
    //   blend = 1 -> spectrogram only; 0 -> waveform only; 0.5 -> both full.
    //   Below 0.5 a black scrim dims the spectrogram; above 0.5 the
    //   waveform's alpha fades out.
    if (blend > 0 && this.metadata.spectrogramWidth > 0) {
      this.drawSpectrogram(ctx, view, w, h);
      if (blend < 0.5) {
        ctx.fillStyle = `rgba(12,13,16,${1 - 2 * blend})`;
        ctx.fillRect(0, 0, w, h);
      }
    }
    const wavAlpha = blend > 0.5 ? 2 * (1 - blend) : 1;
    if (wavAlpha > 0.02) {
      ctx.globalAlpha = wavAlpha;
      this.drawWaveform(ctx, view, w, h, dpr);
      ctx.globalAlpha = 1;
    }
  }

  drawSpectrogram(ctx, view, w, h) {
    const md = this.metadata;
    const maxHz = view.maxTrackHz || md.sampleRate / 2;
    const hzRange = view.hzRange || [0, maxHz];
    const scale = view.freqScale || "Mel";
    // visible full-res image rows (0 = bottom = 0 Hz), image spans [0,maxHz]
    const rLo = relativeFreqPos(hzRange[0], maxHz, scale) * md.spectrogramHeight;
    const rHi = relativeFreqPos(hzRange[1], maxHz, scale) * md.spectrogramHeight;
    const rowsVisible = Math.max(rHi - rLo, 1);
    const { levelX, levelY, basePxPerSec } = this.specLevels(
      view.pxPerSec, h, rowsVisible / md.spectrogramHeight
    );
    const lodPxPerSec = basePxPerSec / (1 << levelX);
    const lodWidth = Math.ceil(md.spectrogramWidth / (1 << levelX));
    const lodHeight = Math.ceil(md.spectrogramHeight / (1 << levelY));
    const rLoLod = rLo / (1 << levelY);
    const rHiLod = rHi / (1 << levelY);
    const xStart = view.startSec * lodPxPerSec;
    const xEnd = (view.startSec + w / view.pxPerSec) * lodPxPerSec;
    const t0 = Math.max(0, Math.floor(xStart / TILE));
    const t1 = Math.min(Math.ceil(lodWidth / TILE) - 1, Math.floor(xEnd / TILE));
    const ty0 = Math.max(0, Math.floor(rLoLod / TILE));
    const ty1 = Math.min(Math.ceil(lodHeight / TILE) - 1, Math.floor(Math.max(rHiLod - 1e-9, 0) / TILE));
    const scaleX = view.pxPerSec / lodPxPerSec;
    const scaleY = h / Math.max(rHiLod - rLoLod, 1e-9);
    // prefetch one tile column beyond each edge for smoother panning
    const tMax = Math.ceil(lodWidth / TILE) - 1;
    for (const tx of [t0 - 1, t1 + 1]) {
      if (tx < 0 || tx > tMax) continue;
      for (let ty = ty0; ty <= ty1; ty++) {
        if (!specTileCache.has(this._specKey(md, levelX, levelY, tx, ty))) {
          this.fetchSpecTile(levelX, levelY, tx, ty);
        }
      }
    }
    for (let ty = ty0; ty <= ty1; ty++) {
      for (let tx = t0; tx <= t1; tx++) {
        const tile = specTileCache.get(this._specKey(md, levelX, levelY, tx, ty));
        if (tile === undefined) {
          this.fetchSpecTile(levelX, levelY, tx, ty);
          continue;
        }
        if (!tile || !tile.bitmap) continue;
        // tile bitmap rows are high-freq-first; its top row is image row
        // (originY + height) from the bottom
        const dx = (tile.originX - xStart) * scaleX;
        const dy = h - (tile.originY + tile.height - rLoLod) * scaleY;
        ctx.drawImage(
          tile.bitmap, dx, dy, tile.width * scaleX, tile.height * scaleY
        );
      }
    }
  }

  drawWaveform(ctx, view, w, h, dpr) {
    const level = this.waveLevel(view.pxPerSec, dpr);
    // LOD crossfade, 200 ms equal-power
    // (reference: AudioTrackViewport.tsx:30-35,642-684)
    const now = performance.now();
    if (this._lastWaveLevel !== null && this._lastWaveLevel !== level) {
      this._waveFade = { fromLevel: this._lastWaveLevel, start: now };
    }
    this._lastWaveLevel = level;
    let fadeT = 1;
    if (this._waveFade) {
      fadeT = (now - this._waveFade.start) / CROSSFADE_MS;
      if (fadeT >= 1) {
        this._waveFade = null;
        fadeT = 1;
      }
    }
    const baseAlpha = ctx.globalAlpha;
    if (this._waveFade) {
      ctx.globalAlpha = baseAlpha * Math.cos((fadeT * Math.PI) / 2);
      this._drawWaveformLevel(ctx, view, w, h, this._waveFade.fromLevel);
      ctx.globalAlpha = baseAlpha * Math.sin((fadeT * Math.PI) / 2);
      this._drawWaveformLevel(ctx, view, w, h, level);
      ctx.globalAlpha = baseAlpha;
      this.onNeedsRedraw(); // keep animating until the fade completes
    } else {
      this._drawWaveformLevel(ctx, view, w, h, level);
    }
  }

  _drawWaveformLevel(ctx, view, w, h, level) {
    const md = this.metadata;
    const spb = 1 << level;
    const tileSamples = WAVE_BINS * spb;
    const sr = md.sampleRate;
    const s0 = view.startSec * sr;
    const s1 = (view.startSec + w / view.pxPerSec) * sr;
    // +/-1 tile overscan (reference waveform-renderer.ts:52-68)
    const ti0 = Math.max(0, Math.floor(s0 / tileSamples) - 1);
    const ti1 = Math.min(
      Math.ceil(md.sampleCount / tileSamples) - 1, Math.floor(s1 / tileSamples) + 1
    );
    const amp = view.ampRange || [-1, 1];
    const yOf = (v) => ((amp[1] - v) / (amp[1] - amp[0])) * h;
    ctx.lineWidth = 1;
    ctx.lineJoin = "round";
    ctx.lineCap = "round";
    for (let ti = ti0; ti <= ti1; ti++) {
      const tile = waveTileCache.get(this._waveKey(md, level, ti));
      if (tile === undefined) {
        this.fetchWaveTile(level, ti);
        continue;
      }
      if (!tile || tile.binCount === 0) continue;
      const xOf = (b) =>
        ((ti * tileSamples + b * spb) / sr - view.startSec) * view.pxPerSec;
      // clipped tracks: tiles carry the PRE-clip waveform; draw it red
      // underneath, then the +/-1-clamped waveform blue on top
      // (reference: waveform-renderer.ts clipped two-layer draw)
      if (md.isClipped) {
        this._drawTile(ctx, tile, spb, xOf, yOf, CLIP_COLOR, CLIP_LINE_COLOR, null);
      }
      const clamp = md.isClipped ? 1.0 : Infinity;
      this._drawTile(ctx, tile, spb, xOf, yOf, WAVE_COLOR, WAVE_LINE_COLOR, clamp);
    }
  }

  _drawTile(ctx, tile, spb, xOf, yOf, fillColor, lineColor, clampAbs) {
    const cl = (v) =>
      clampAbs === null || clampAbs === Infinity
        ? v
        : Math.min(Math.max(v, -clampAbs), clampAbs);
    const bins = tile.bins;
    if (spb === 1) {
      // per-sample polyline with round joins
      // (reference: waveform-renderer.ts:227-268 samplesPerBin==1 branch)
      ctx.strokeStyle = lineColor;
      ctx.lineWidth = 1.5;
      ctx.beginPath();
      for (let b = 0; b < tile.binCount; b++) {
        const y = yOf(cl(bins[b * 3 + 2])); // mean == the sample at level 0
        if (b === 0) ctx.moveTo(xOf(b), y);
        else ctx.lineTo(xOf(b), y);
      }
      ctx.stroke();
      ctx.lineWidth = 1;
      return;
    }
    // min/max envelope fill with border + representative mean line
    // (reference: waveform-renderer.ts:270-407)
    ctx.strokeStyle = fillColor;
    ctx.fillStyle = fillColor;
    ctx.beginPath();
    for (let b = 0; b < tile.binCount; b++) {
      const y = yOf(cl(bins[b * 3 + 1]));
      if (b === 0) ctx.moveTo(xOf(b), y);
      else ctx.lineTo(xOf(b), y);
    }
    for (let b = tile.binCount - 1; b >= 0; b--) {
      ctx.lineTo(xOf(b), yOf(cl(bins[b * 3])));
    }
    ctx.closePath();
    const a = ctx.globalAlpha;
    ctx.globalAlpha = a * 0.85;
    ctx.fill();
    ctx.globalAlpha = a;
    ctx.stroke(); // envelope border
    ctx.strokeStyle = lineColor;
    ctx.beginPath();
    for (let b = 0; b < tile.binCount; b++) {
      const y = yOf(cl(bins[b * 3 + 2]));
      if (b === 0) ctx.moveTo(xOf(b), y);
      else ctx.lineTo(xOf(b), y);
    }
    ctx.stroke();
  }
}
