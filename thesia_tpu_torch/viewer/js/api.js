// Backend command client + binary tile decoders.
// Mirrors the reference's src/api/backend-wrapper.ts (41 commands + decoders);
// binary layouts: waveform 24 B header + 12 B/bin, spectrogram 40 B header +
// RGBA rows (high frequencies first).

async function call(command, args = {}) {
  const r = await fetch(`/api/${command}`, {
    method: "POST",
    headers: { "Content-Type": "application/json" },
    body: JSON.stringify(args),
  });
  if (!r.ok) {
    // error bodies are JSON from the service, but a proxy 502 / mid-restart
    // page is HTML — parse defensively so the surfaced error names the
    // command + status instead of a JSON SyntaxError (review finding)
    let detail = r.status;
    try {
      detail = (await r.json()).error || r.status;
    } catch (_e) { /* non-JSON body */ }
    throw new Error(`${command}: ${detail}`);
  }
  return (await r.json()).result;
}

async function callBinary(command, args = {}) {
  const r = await fetch(`/api/${command}`, {
    method: "POST",
    headers: { "Content-Type": "application/json" },
    body: JSON.stringify(args),
  });
  if (!r.ok) throw new Error(`${command}: ${r.status}`);
  return await r.arrayBuffer();
}

export function decodeWaveformTile(buf) {
  const dv = new DataView(buf);
  const revision = dv.getBigUint64(0, true);
  const binCount = dv.getUint32(8, true);
  const samplesPerBin = dv.getUint32(12, true);
  const tileIndex = dv.getUint32(16, true);
  const bins = new Float32Array(buf, 24, binCount * 3);
  return { revision, binCount, samplesPerBin, tileIndex, bins };
}

export function decodeSpectrogramTile(buf) {
  const dv = new DataView(buf);
  return {
    revision: dv.getBigUint64(0, true),
    width: dv.getUint32(8, true),
    height: dv.getUint32(12, true),
    levelX: dv.getUint32(16, true),
    levelY: dv.getUint32(20, true),
    tileX: dv.getUint32(24, true),
    tileY: dv.getUint32(28, true),
    originX: dv.getUint32(32, true),
    originY: dv.getUint32(36, true),
    rgba: new Uint8ClampedArray(buf, 40),
  };
}

export function decodePcmChunk(buf) {
  // wire layout from thesia_tpu/player/player.py encode_pcm_chunk: 32 B
  // header (u32 nFrames, u32 channels, u32 sampleRate, u32 flags, f64
  // positionSec, u32 cursorVersion, u32 pad) + interleaved f32le frames
  const dv = new DataView(buf);
  const flags = dv.getUint32(12, true);
  return {
    nFrames: dv.getUint32(0, true),
    channels: dv.getUint32(4, true),
    sampleRate: dv.getUint32(8, true),
    isPlaying: (flags & 1) !== 0,
    ended: (flags & 2) !== 0,
    positionSec: dv.getFloat64(16, true),
    cursorVersion: dv.getUint32(24, true),
    pcm: new Float32Array(buf, 32),
  };
}

async function playerPost(path, args) {
  const r = await fetch(path, {
    method: "POST",
    headers: { "Content-Type": "application/json" },
    body: JSON.stringify(args || {}),
  });
  if (!r.ok) {
    let detail = r.status;
    try {
      detail = (await r.json()).error || r.status;
    } catch (_e) { /* non-JSON body */ }
    throw new Error(`${path}: ${detail}`);
  }
  return r;
}

export function jsonNumber(x) {
  if (!x || typeof x !== "object") return x;
  switch (x.type) {
    case "Finite": return x.value;
    case "Infinity": return Infinity;
    case "NegInfinity": return -Infinity;
    default: return NaN;
  }
}

export const api = {
  init: (colormapRgba) => call("init", { colormapRgba }),
  setUserSettings: (userSettings) => call("set_user_settings", { userSettings }),
  addTracks: (trackIds, paths) => call("add_tracks", { trackIds, paths }),
  reloadTracks: (trackIds) => call("reload_tracks", { trackIds }),
  removeTracks: (trackIds) => call("remove_tracks", { trackIds }),
  applyTrackListChanges: () => call("apply_track_list_changes"),
  findIdByPath: (path) => call("find_id_by_path", { path }),
  getSpecSetting: () => call("get_spec_setting"),
  setSpecSetting: (specSetting) => call("set_spec_setting", { specSetting }),
  getDbRange: () => call("get_dB_range"),
  setDbRange: (dBRange) => call("set_dB_range", { dBRange }),
  setCommonNormalize: (target) => call("set_common_normalize", { target }),
  setCommonGuardClipping: (mode) => call("set_common_guard_clipping", { mode }),
  getMetadata: (idChStr) => call("get_audio_render_metadata", { idChStr }),
  getWaveformTile: (idChStr, level, tileIndex) =>
    callBinary("get_waveform_tile", { idChStr, level, tileIndex }).then(decodeWaveformTile),
  getSpectrogramTile: (idChStr, levelX, levelY, tileX, tileY) =>
    callBinary("get_spectrogram_tile", { idChStr, levelX, levelY, tileX, tileY })
      .then(decodeSpectrogramTile),
  getLimiterGain: (trackId) => call("get_limiter_gain", { trackId }),
  getMaxTrackHz: () => call("get_max_track_hz"),
  getLongestSec: () => call("get_longest_track_length_sec"),
  getChannelCounts: (trackId) => call("get_channel_counts", { trackId }),
  getLengthSec: (trackId) => call("get_length_sec", { trackId }),
  getSampleRate: (trackId) => call("get_sample_rate", { trackId }),
  getFormatInfo: (trackId) => call("get_format_info", { trackId }),
  getMinDb: () => call("get_min_dB").then(jsonNumber),
  getMaxDb: () => call("get_max_dB").then(jsonNumber),
  getCommonGuardClipping: () => call("get_common_guard_clipping"),
  getCommonNormalize: () => call("get_common_normalize"),
  calcDbAxisMarkers: (maxNumTicks, maxNumLabels, dBRangeMin, dBRangeMax) =>
    call("calc_dB_axis_markers", { maxNumTicks, maxNumLabels, dBRangeMin, dBRangeMax }),
  freqLabelToHz: (label) => call("freq_label_to_hz", { label }),
  getGlobalLufs: (trackId) => call("get_global_lufs", { trackId }).then(jsonNumber),
  getRmsDb: (trackId) => call("get_rms_dB", { trackId }).then(jsonNumber),
  getMaxPeakDb: (trackId) => call("get_max_peak_dB", { trackId }).then(jsonNumber),
  getGuardClipStats: (trackId) => call("get_guard_clip_stats", { trackId }),
  getFileName: (trackId) => call("get_file_name", { trackId }),
  setVolumeDb: (volumeDB) => call("set_volume_dB", { volumeDB }),
  setTrackPlayer: (trackId, sec) => call("set_track_player", { trackId, sec }),
  seekPlayer: (sec) => call("seek_player", { sec }),
  pausePlayer: () => call("pause_player"),
  resumePlayer: () => call("resume_player"),
  playerState: () => fetch("/player/state").then((r) => r.json()).then((j) => j.result),
  // remote audio: the viewer's AudioContext attaches as the player's output
  // device and pulls the PCM chunks it schedules (reference parity:
  // src-tauri/src/player/stream.rs:501-639 — the cpal callback's last hop)
  attachPcm: (sampleRate, channels) =>
    playerPost("/player/attach_pcm", { sampleRate, channels })
      .then((r) => r.json()).then((j) => j.result),
  detachPcm: () => playerPost("/player/detach_pcm", {}).then(() => null),
  pullPcm: (frames) =>
    playerPost("/player/pcm", { frames })
      .then((r) => r.arrayBuffer()).then(decodePcmChunk),
  calcTimeAxisMarkers: (startSec, endSec, tickUnit, labelInterval, maxSec) =>
    call("calc_time_axis_markers", { startSec, endSec, tickUnit, labelInterval, maxSec }),
  calcFreqAxisMarkers: (hzRangeMin, hzRangeMax, freqScale, maxNumTicks, maxNumLabels, maxTrackHz) =>
    call("calc_freq_axis_markers",
      { hzRangeMin, hzRangeMax, freqScale, maxNumTicks, maxNumLabels, maxTrackHz }),
  calcAmpAxisMarkers: (maxNumTicks, maxNumLabels, ampRangeMin, ampRangeMax) =>
    call("calc_amp_axis_markers", { maxNumTicks, maxNumLabels, ampRangeMin, ampRangeMax }),
  // axis hover tooltips (reference: wasm-wrapper.ts formatLinearAxisTooltip /
  // formatFrequencyAxisTooltip, TimeAxis.tsx formatTimeAxisTooltip).  NaN
  // tickUnit (no positive tick gap) JSON-encodes as null; the service maps
  // null back to NaN.
  formatLinearAxisTooltip: (value, resolution, tickUnit, maxFractionDigits) =>
    call("format_linear_axis_tooltip", {
      value, resolution,
      tickUnit: Number.isFinite(tickUnit) ? tickUnit : null,
      maxFractionDigits,
    }),
  formatFrequencyAxisTooltip: (hz, resolutionHz) =>
    call("format_frequency_axis_tooltip", { hz, resolutionHz }),
  // TrackSummary's LUFS number (reference: wasm-wrapper.ts
  // formatNumberLabel — Rust {:.N} half-even).  Finite values only; the
  // non-finite branch (axis.rs format_non_finite_float) is the client-side
  // applogic.nonFiniteNumberLabel.
  formatNumberLabel: (value, fractionDigits) =>
    call("format_number_label", { value, fractionDigits }),
  formatTimeAxisTooltip: (sec, formatDisplay) =>
    call("format_time_axis_tooltip", { sec, formatDisplay }),
  secondsToLabel: (sec) => call("seconds_to_label", { sec }),
  timeLabelToSeconds: (label) => call("time_label_to_seconds", { label }),
  listMedia: () => fetch("/media").then((r) => r.json()).then((j) => j.result),
  upload: async (file) => {
    const fd = new FormData();
    fd.append("file", file);
    const r = await fetch("/upload", { method: "POST", body: fd });
    if (!r.ok) throw new Error(`upload failed: HTTP ${r.status}`);
    return (await r.json()).result;
  },
};
