// Client-side frequency-scale position math (pure, synchronous) for
// viewport cropping and axis interactions.  Same published Slaney mel
// formulas the backend uses (reference: src-common/src/lib.rs:11-43 mel<->hz,
// :105-160 FreqScale relative-position mapping).

const MIN_LOG_HZ = 1000.0;
const MIN_LOG_MEL = 15.0;
const LINEAR_MEL_STEP = 200.0 / 3.0;
const LOGSTEP = Math.log(6.4) / 27.0;

export function melFromHz(hz) {
  if (hz >= MIN_LOG_HZ) return MIN_LOG_MEL + Math.log(hz / MIN_LOG_HZ) / LOGSTEP;
  return hz / LINEAR_MEL_STEP;
}

export function melToHz(mel) {
  if (mel >= MIN_LOG_MEL) return MIN_LOG_HZ * Math.exp(LOGSTEP * (mel - MIN_LOG_MEL));
  return mel * LINEAR_MEL_STEP;
}

// relative position of `hz` in [0, maxHz], 0 = bottom, 1 = top
export function relativeFreqPos(hz, maxHz, freqScale) {
  if (maxHz <= 0) return 0;
  if (freqScale === "Mel") return melFromHz(hz) / melFromHz(maxHz);
  return hz / maxHz;
}

export function hzFromRelativePos(pos, maxHz, freqScale) {
  if (freqScale === "Mel") return melToHz(pos * melFromHz(maxHz));
  return pos * maxHz;
}
