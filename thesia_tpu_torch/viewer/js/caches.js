// Byte-budgeted LRU caches for decoded tiles, shared across all viewports.
// Budgets mirror the reference client: 128 MiB for GPU-resident spectrogram
// textures, 32 MiB for decoded waveform bins
// (reference: src/modules/AudioTrackViewport.tsx:25-26,
//  src/lib/audio-render-tiles.ts:25-152 retire+destroy lifecycle).

export class LruByteCache {
  constructor(budgetBytes) {
    this.budget = budgetBytes;
    this.bytes = 0;
    this.map = new Map(); // key -> {value, bytes}; Map preserves insert order
  }

  get(key) {
    const e = this.map.get(key);
    if (e === undefined) return undefined;
    // refresh recency
    this.map.delete(key);
    this.map.set(key, e);
    return e.value;
  }

  has(key) {
    return this.map.has(key);
  }

  set(key, value, bytes) {
    const prev = this.map.get(key);
    if (prev) {
      this.bytes -= prev.bytes;
      this.map.delete(key);
      this._dispose(prev.value);
    }
    this.map.set(key, { value, bytes });
    this.bytes += bytes;
    this._evict();
  }

  delete(key) {
    const e = this.map.get(key);
    if (e) {
      this.bytes -= e.bytes;
      this.map.delete(key);
      this._dispose(e.value);
    }
  }

  // drop all entries whose key fails `keep(key)` (revision invalidation)
  retain(keep) {
    for (const key of [...this.map.keys()]) {
      if (!keep(key)) this.delete(key);
    }
  }

  clear() {
    for (const key of [...this.map.keys()]) this.delete(key);
  }

  _evict() {
    for (const key of this.map.keys()) {
      if (this.bytes <= this.budget) break;
      this.delete(key);
    }
  }

  _dispose(value) {
    // ImageBitmaps hold GPU/raster memory; release it eagerly like the
    // reference destroys retired Pixi textures
    if (value && typeof value.close === "function") {
      try { value.close(); } catch { /* already closed */ }
    }
    if (value && value.bitmap && typeof value.bitmap.close === "function") {
      try { value.bitmap.close(); } catch { /* already closed */ }
    }
  }
}

export const SPEC_TILE_CACHE_BYTES = 128 * 1024 * 1024;
export const WAVE_TILE_CACHE_BYTES = 32 * 1024 * 1024;

export const specTileCache = new LruByteCache(SPEC_TILE_CACHE_BYTES);
export const waveTileCache = new LruByteCache(WAVE_TILE_CACHE_BYTES);
// in-flight fetch de-dup (pending promises are not budgeted)
export const pendingFetches = new Set();
