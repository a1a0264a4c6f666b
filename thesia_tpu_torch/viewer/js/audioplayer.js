// Web Audio playback of the engine's PCM stream — the deployable last hop
// of the player.  The reference's cpal output callback runs in-process on
// the user's machine (reference: src-tauri/src/player/stream.rs:501-639);
// in the service deployment the user's machine is the browser, so this
// module attaches the AudioContext as the player's output device
// (/player/attach_pcm), pulls fixed-size PCM chunks (/player/pcm — each
// pull runs the engine's exact mix->volume->clamp fill), and schedules
// them on the AudioContext clock.  All scheduling MATH lives in
// applogic.js (audioChunkStartTime / audioPullCount / audioCursorReset /
// deinterleavePcm) with executed Python twins; this file only wires it to
// Web Audio + fetch.
//
// Policies:
//  * buffer-ahead target AUDIO_BUFFER_AHEAD_SEC, pump every
//    AUDIO_PUMP_INTERVAL_MS and after state changes;
//  * underrun: restart the scheduled frontier at ctx.currentTime +
//    AUDIO_MIN_LEAD_SEC (gap, never overlap);
//  * seek/track switch: the wire chunk carries cursor_version
//    (reference: stream.rs:110 reset_for_cursor) — on a bump, everything
//    scheduled is pre-seek audio: stop it and restart the frontier;
//  * pause: the server flags isPlaying in each chunk; pulling stops and
//    the poll-driven setPlaying(false) silences what was scheduled (a
//    paused server returns silence and does not advance the position, so
//    a late pull is harmless);
//  * end: the chunk flagged ended carries the track's LAST real frames —
//    it is scheduled, pulling stops, and the scheduled tail drains to
//    completion instead of being flushed (drainEnd; mirrors the device
//    callback's end-drain in stream.rs fill()).

import { api } from "./api.js";
import * as L from "./applogic.js";

export function createAudioPlayer(opts = {}) {
  const makeContext =
    opts.createContext ||
    (() => {
      const Ctor = window.AudioContext || window.webkitAudioContext;
      return Ctor ? new Ctor() : null;
    });
  const timer = opts.setTimeout || ((fn, ms) => setTimeout(fn, ms));

  const st = {
    ctx: null,
    attached: false,
    running: false, // pump loop live
    pumping: false, // re-entrancy guard (pump is async)
    unsupported: false,
    nextStartTime: 0,
    seenVersion: null,
    scheduled: [], // live AudioBufferSourceNodes, flushed on seek/pause
    drainEnd: false, // let the scheduled tail play out after track end
    pulls: 0, // diagnostics / tests
  };

  function flushScheduled() {
    st.drainEnd = false; // anything flushed, the end-tail included, is gone
    for (const src of st.scheduled) {
      try {
        src.stop();
      } catch (_e) { /* already ended */ }
    }
    st.scheduled = [];
    st.nextStartTime = 0; // frontier restarts at ctxTime + min lead
  }

  function scheduleChunk(chunk) {
    const ctx = st.ctx;
    const buf = ctx.createBuffer(chunk.channels, chunk.nFrames, ctx.sampleRate);
    for (let c = 0; c < chunk.channels; c++) {
      buf.copyToChannel(L.deinterleavePcm(chunk.pcm, chunk.channels, chunk.nFrames, c), c);
    }
    const src = ctx.createBufferSource();
    src.buffer = buf;
    src.connect(ctx.destination);
    const startAt = L.audioChunkStartTime(
      st.nextStartTime, ctx.currentTime, L.AUDIO_MIN_LEAD_SEC
    );
    src.start(startAt);
    st.nextStartTime = startAt + chunk.nFrames / ctx.sampleRate;
    st.scheduled.push(src);
    src.onended = () => {
      st.scheduled = st.scheduled.filter((s) => s !== src);
    };
  }

  async function pump() {
    if (st.pumping || !st.running || !st.attached) return;
    st.pumping = true;
    try {
      const ctx = st.ctx;
      const chunkDur = L.AUDIO_CHUNK_FRAMES / ctx.sampleRate;
      let n = L.audioPullCount(
        st.nextStartTime, ctx.currentTime,
        L.AUDIO_BUFFER_AHEAD_SEC, chunkDur, L.AUDIO_MAX_PULLS_PER_TICK
      );
      while (n > 0 && st.running) {
        const chunk = await api.pullPcm(L.AUDIO_CHUNK_FRAMES);
        st.pulls += 1;
        if (L.audioCursorReset(chunk.cursorVersion, st.seenVersion)) {
          flushScheduled(); // pre-seek audio must not play (stream.rs:110)
        }
        st.seenVersion = chunk.cursorVersion;
        // The final fill of a track flags isPlaying=false AND ended=true in
        // the same chunk that carries the last real frames (player.pull_pcm)
        // — it must be scheduled or the end is audibly truncated, defeating
        // the fill()'s own end-drain.  A pure pause chunk (isPlaying=false,
        // no ended) is silence and is not scheduled.
        if (chunk.isPlaying || chunk.ended) scheduleChunk(chunk);
        n -= 1;
        if (chunk.ended) {
          // Track ran out: stop pulling but let the scheduled tail play —
          // the poll-driven setPlaying(false) must not flush it.
          st.drainEnd = true;
          st.running = false;
          break;
        }
        if (!chunk.isPlaying) {
          st.running = false; // paused server-side (poll will silence us)
          break;
        }
      }
    } catch (_e) {
      // transient fetch failure / detach race: stop pumping, the next
      // play-state change restarts the loop (and re-attaches if needed)
      st.running = false;
      st.attached = false;
    } finally {
      st.pumping = false;
    }
    if (st.running) timer(pump, L.AUDIO_PUMP_INTERVAL_MS);
  }

  async function ensureStarted() {
    // NEVER throws: remote audio is an enhancement over the server-side
    // output path — an attach failure (service mid-restart, proxy hiccup)
    // must not break the play command it piggybacks on.
    if (st.unsupported) return false;
    try {
      if (!st.ctx) {
        st.ctx = makeContext(); // needs a user gesture; callers are handlers
        if (!st.ctx) {
          st.unsupported = true;
          return false;
        }
      }
      if (st.ctx.resume) await st.ctx.resume();
      if (!st.attached) {
        await api.attachPcm(st.ctx.sampleRate, 2);
        st.attached = true;
        st.seenVersion = null;
        st.nextStartTime = 0;
      }
      if (!st.running) {
        st.running = true;
        await pump();
      }
      return true;
    } catch (_e) {
      return false; // transient: the next play state change retries
    }
  }

  function setPlaying(isPlaying) {
    if (!st.ctx || st.unsupported) return;
    if (isPlaying) {
      st.drainEnd = false;
      if (!st.attached) {
        // a pump failure detached us (transient fetch error / server
        // restart); re-attaching needs no user gesture — the context
        // already exists from the original play gesture
        ensureStarted();
      } else if (!st.running) {
        st.running = true;
        pump();
      }
    } else {
      st.running = false;
      // end-of-track (drainEnd): the scheduled tail is real audio — let
      // onended reap it.  The flag persists across the repeated poll-driven
      // setPlaying(false) calls and clears on the next play or flush.
      if (!st.drainEnd) {
        flushScheduled(); // pause silences immediately, like a device stream
      }
    }
  }

  return { ensureStarted, setPlaying, _state: st };
}
