// Batched dynamics for Hopper in float64: K9 (K-weighted LUFS with the sum of
// squares and the peak), K8 (the limiter's gain sequence) and K10 (the
// normalize gain and the guard applied to a track's samples).
//
// Replaces the JAX package's two device programs of the dynamics path (XLA
// programs, not Pallas kernels):
//   * K9: thesia_tpu/dynamics/stats_device.py:264, _lufs_kernel (with
//     _biquad_scan :237), every add of two or more tracks;
//   * K8: thesia_tpu/dynamics/stats_device.py:161, _limiter_gain_kernel (with
//     _sliding_min :101, _release_scan :127, _box_filter :146), the Limiter
//     over two or more tracks.
// Their plain versions are the torch programs lufs_program and
// limiter_gain_program of thesia_tpu_torch/dynamics/stats_device.py.
//
// What bounds them on the H100: the bytes.  Their f64 arithmetic, a few tens
// of operations a sample, stays under the bytes at the card's 34 TFLOP/s of
// f64 outside the tensor cores (kernels/dynamics.py: lufs_work,
// limiter_work), and tensor cores buy nothing here.  So the design reads
// each sample as few times as the carries allow, keeps every intermediate
// signal in shared memory (per-block states, maps and partial sums are all
// that reach device memory besides the outputs and pass 1's run starts),
// stages samples by cp.async, and spends few instructions a sample: f32
// buffers where f32 is exact, one scan a block, no pass that walks doubling
// windows, no f64 division in a loop.  What holds them back now is
// instruction throughput in the per-thread walks and scans (PERF.md).
// K9 and K8 sum nothing with atomics: every reduction runs in a fixed order,
// so two calls on the same samples give the same bits.  At most five launches
// a group.
//
// K9 (k9_sums, k9_carry, k9_energy, k9_gate, k9_tail; rows r = item * C + channel,
// each row's first ns[item] samples):
//   The two K-weighting DF2T biquads form one 4-state affine recurrence
//   S_t = M S_{t-1} + g x_t (M block lower triangular, so are its powers).
//   A block owns G whole 100 ms segments (ch = G s100 samples), staged in
//   shared memory by cp.async; each of its T threads one run of `run`
//   samples.  The host gives, from exact squarings of M in extended
//   precision rounded once to f64 (kernels/dynamics.py: k9_tables,
//   k9_carry_table), the weights W[k] = M^k g (k < run), M^k (k <= run), and
//   for P = M^run and P = M^(ch K) the ladder P^(2^l), lane powers P^l and
//   warp powers P^(32 w) that a two-level (shuffle, then warp totals) scan
//   reads.
//   1. k9_sums, no recurrence: a run from zero ends in sum_t W[n-1-t] x_t,
//      4 FMAs a sample (a short last run reads the weights at an offset).
//      One scan of the runs' end states gives each run's start from a zero
//      block start (written for pass 3, 32 bytes a run) and, with M^cnt from
//      the host for the last run of cnt samples, the block's end state.
//      Also the sum of squares and the NaN-propagating peak of the raw
//      samples.
//   2. k9_carry, one block a row: each block's true start state.  Each
//      thread carries K consecutive block ends to their last one's end
//      (Horner with M^ch), one scan of those with the powers of M^(ch K)
//      (K the least power of two, at most 8, with K TC blocks covering the
//      row, the host's table for it), then walks its blocks again for their
//      starts; the states pass through shared memory in coalesced copies.
//   3. k9_energy, no scan: each run's true start is P^j R plus its start
//      from zero (pass 1), R the block's start state, P^j = P^lane P^(32
//      warp) two matrix-vector products; each thread runs its samples
//      through the two biquads, squares the output and sums it into the (at
//      most two, run <= s100) segments its run touches; a warp per segment
//      adds the threads' parts in order.  So a sample takes the weights' 4
//      FMAs once and the recurrence once, and a block one scan (in pass 1).
//   4. k9_gate, per item and tile of 400 ms blocks: their energies from four
//      segment sums a channel (surround channels weighted), ebur128's
//      histogram bin (an f32 log2 estimate, then exact against the f64
//      bounds), kept as int16, and the tile's count and energy above the -70
//      LUFS absolute gate.
//   5. k9_tail, one block an item: the tiles' sums, the -10 LU relative gate
//      over the bins, the means and log10; the raw stats summed over the
//      blocks' partials.
//   The carry stays a launch of its own: a single pass with decoupled
//   look-back would read the samples once, but its combine order would
//   depend on timing (no bitwise repeatability).
//
// K8 (k8_spans, k8_carry, k8_gain; rows = items, channels reduced in the
// loader; every position t < L):
//   Chunks of ch output positions; chunk k's release span is [k ch - hbox,
//   (k+1) ch - hbox) (the last one's runs to L), hbox = sum(box - 1) the box
//   stack's delay.  The hold: the limiter's gain thr / (v + eps) falls as the
//   level v rises (a correctly rounded quotient is monotone), so the minimum
//   gain over a window is the gain of the window's maximum level; the kernels
//   slide a max over the f32 NaN-ignoring channel maxima (-inf before t = 0)
//   and take the gain after it.  The max is van Herk/Gil-Werman over the
//   threads' segments: each thread's suffix maxima and segment maximum in
//   shared memory, then per position the suffix at the window's start, the
//   whole segments between and the thread's running prefix (a hold no longer
//   than a segment is taken directly).  The gain's quotient is the
//   hardware reciprocal, two Newton steps and one exact residual (an f64
//   division's slow-path call spilled registers).  The release works on
//   centred values eta = y - 1: the steps eta -> min(h - 1, (1 - slew) eta +
//   slew (h - 1)) compose into triples eta -> min(C, A eta + E)
//   (stats_device.py _release_scan), so a stretch the limiter leaves alone
//   maps 0 to exactly 0 and the identity is exact.
//   1. k8_spans, per chunk: the levels of its span and hold halo (one or two
//      channels staged by cp.async), the hold, the span's composed triple
//      (an ordered shuffle reduction).
//   2. k8_carry scans the triples into every chunk's start value (y_{-1} = 1),
//      K consecutive chunks a thread (composed in order, one scan, then a
//      walk), the maps staged in shared memory by coalesced copies.
//   3. k8_gain, per chunk: the levels, the hold and the release again from
//      the f32 samples (no hold row in device memory), an ordered scan of the
//      threads' triples for their start values, the centred release values'
//      prefix sums in shared memory (0 before t = 0, the box stack's
//      pre-history), the box stack on each thread's fixed share as
//      differences of block prefix sums, min(eta + 1, 1), written once.
//
// K10 (k10_peak, k10_apply; rows = the channels of one track, n samples each):
//   Replaces no TPU kernel: the JAX package applies the gain and the guard in
//   numpy on the host (thesia_tpu/dynamics/guard.py:64-109, called from
//   Audio.mutate in thesia_tpu/engine/audio.py).  Here they run on the
//   original's device copy, which the spectrogram already holds, so a knob
//   turn uploads nothing and lands only the f32 results.  Bound: the bytes,
//   about a read and a write of the track (4 C n each) a pass; a few
//   operations a sample.  Grid-stride loops over each row, one block reduction
//   and one integer atomic a block and statistic (max, min and add of
//   integers are exact in any order, so two calls give the same bits).
//   1. k10_peak: gained = float32(g) x, one correctly rounded f32 multiply
//      (the host's np.float32(g) * wavs); each row's abs max with NaN skipped
//      and a 0 floor (stats.py nan_safe_abs_max), as the bits of a
//      non-negative float, and whether the row holds a NaN; gained is written
//      only where it is asked for (Clip's pre-clip waveform).
//   2. k10_apply<MODE> forms gained again and writes the guard's output:
//      K10_GAIN gained; K10_CLIP clamp(gained, -1, 1), and per row the count of
//      |gained| > 1; K10_SCALE f32 of clip(f64(gained) * s, -1, 1); K10_SEQ the
//      same with s = seq[t] (K8's f64 gains), and from row 0 the gains rounded
//      to f32, their count of != 1 and their least value (the largest
//      complement of an ordered key, so that every statistic starts at 0).
//      One f64 multiply (__dmul_rn, nothing to contract), the clip by
//      comparisons, so that NaN passes through as np.clip passes it (fmin and
//      fmax would drop it), then one round to f32: the host's bits.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#ifndef PHASE  // tools/profile_dynamics_phases.py defines them to count cycles a phase
#define PHASE_BEGIN
#define PHASE(i)
#endif

namespace {

constexpr int T = 256;   // threads of K9's passes and k9_gate
constexpr int TC = 512;  // threads of k9_carry
constexpr int TT = 512;  // threads of k9_tail
constexpr int WARPS = T / 32;
constexpr int POW_STEPS = 10;
constexpr int POW_TABLE = 16 * (POW_STEPS + 32 + 33);  // kernels/dynamics.py POW_TABLE
constexpr int K8_MAX_BOX = 4;
constexpr double F64_EPS = 0x1p-52;
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// shared helpers

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

// an item's valid samples, within [0, L] (the plain version reads no further)
__device__ __forceinline__ int64_t valid_n(const int64_t* ns, int item, int64_t L) {
  return max64(min64(ns[item], L), 0);
}

__device__ __forceinline__ float nan_max(float p, float q) {
  return (q > p || q != q) ? q : p;  // NaN wins, as torch's amax
}

// The sum of v over the block of NT threads, the same value in every thread
// and the same bits in every run (a fixed butterfly, then the warps in order).
template <int NT>
__device__ double block_sum(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double s = 0.0;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

template <int NT>
__device__ float block_nan_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(FULL, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) s = nan_max(s, red[w]);
  __syncthreads();
  return s;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// Starts copying x[0, n) (any 4-byte alignment) into shared memory, sample
// i at xs[pad + i] with pad < 4 chosen so that the 16-byte copies land
// aligned (xs is 16-byte aligned and holds n + 3 floats); returns pad.
// stage_wait() waits for it.
__device__ int stage_async(const float* x, int n, float* xs) {
  const int head = (int)((16 - ((uintptr_t)x & 15)) & 15) >> 2;
  const int h = min(head, n);
  const int pad = (4 - h) & 3;
  const int nv = (n - h) >> 2;
  for (int i = threadIdx.x; i < h; i += blockDim.x) cp_async4(xs + pad + i, x + i);
  for (int v = threadIdx.x; v < nv; v += blockDim.x) cp_async16(xs + pad + h + 4 * v, x + h + 4 * v);
  for (int i = h + 4 * nv + threadIdx.x; i < n; i += blockDim.x) cp_async4(xs + pad + i, x + i);
  return pad;
}

// Waits for every copy the block started and makes them visible to all.
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// stage_async, then stage_wait.
__device__ int stage(const float* x, int n, float* xs) {
  const int pad = stage_async(x, n, xs);
  stage_wait();
  return pad;
}

// Starts copying n doubles (n even, both 16-byte aligned) into shared memory;
// the next stage() waits for them.
__device__ void stage_doubles(const double* src, int n, double* dst) {
  for (int v = threadIdx.x; v < n / 2; v += blockDim.x)
    cp_async16(reinterpret_cast<float*>(dst + 2 * v), reinterpret_cast<const float*>(src + 2 * v));
}

// ---------------------------------------------------------------------------
// K9

struct K9Coef {
  // stage 1: y = b0 x + s0; s0' = na1 s0 + s1 + c0 x; s1' = na2 s0 + c1 x
  double na1, na2, c0, c1, b0;
  // stage 2 on y, likewise: z = e0 y + u0; u0' = nb1 u0 + u1 + d0 y; u1' = nb2 u0 + d1 y
  double nb1, nb2, d0, d1, e0;
};

// The powers of one P = M^n (row-major 4x4 each): the ladder P^(2^l), l <
// POW_STEPS; the lane powers P^l, l < 32, element-major (entry e of lane l
// at 32 e + l: a warp reads one entry without bank conflicts); the warp
// powers P^(32 w), w <= 32.
struct Pow {
  const double* step;
  const double* lane;
  const double* warp;
};

__host__ __device__ __forceinline__ Pow pow_at(const double* t) {
  return {t, t + 16 * POW_STEPS, t + 16 * (POW_STEPS + 32)};
}

// doubles of a power table up to the warp power P^(32 nw): what a block of
// nw warps reads
__host__ __device__ constexpr int pow_prefix(int nw) { return 16 * (POW_STEPS + 32 + nw + 1); }

struct K9Args {
  const float* wavs;  // (R, L) rows, R = n_items * C
  const int64_t* ns;  // (n_items,) valid samples of each item's rows
  int64_t L;          // row width
  int ch, run;        // samples a block owns (G segments); samples a thread's run
  int C, s100, G, win, nb_max, n_seg_max;
  double surround, rel_gate;
  K9Coef k;
  alignas(16) double mfull[16];  // M^cnt for the last run of a full block (cnt = ch - (ch - 1) / run * run)
  int gate_tile, n_gb_max, tiles_max;  // k9_gate: 400 ms blocks a block; their most a row; tiles
  const double* w;   // (run, 4) W[k] = M^k g, the powers of M^run, M^k for k <= run
  const double* pck;  // the powers of M^(ch K), then M^ch (16), K blocks a carry thread
  int carry_k;
  double* ends;     // (R, nb_max, 4) k9_sums: each block's end state from zero
  double* rstart;   // (R, nb_max, T, 4) k9_sums: each run's start state from the block's start at zero
  double* starts;   // (R, nb_max, 4) k9_carry: each block's true start state
  double* part_sq;  // (R, nb_max) sum of x^2 of each block's samples
  float* part_pk;   // (R, nb_max) max |x| of each block's samples
  double* seg;      // (R, n_seg_max) K-weighted sum of squares per 100 ms segment
  int16_t* bins;    // (n_items, n_gb_max) k9_gate: each 400 ms block's histogram bin, -1 below the gate
  double* gate_part;  // (n_items, tiles_max, 2) k9_gate: count and energy above the absolute gate
};

// doubles k9_sums and k9_energy stage before their samples: the weights and
// the powers of M^run a block of T threads reads
__host__ __device__ __forceinline__ int k9_tab(int run) { return 4 * run + pow_prefix(WARPS); }

// One sample through both biquads; returns the K-weighted output.
__device__ __forceinline__ double k_step(const K9Coef& k, double x, double (&s)[4]) {
  const double y = fma(k.b0, x, s[0]);
  const double s0 = fma(k.c0, x, fma(k.na1, s[0], s[1]));
  const double s1 = fma(k.c1, x, k.na2 * s[0]);
  const double z = fma(k.e0, y, s[2]);
  const double u0 = fma(k.d0, y, fma(k.nb1, s[2], s[3]));
  const double u1 = fma(k.d1, y, k.nb2 * s[2]);
  s[0] = s0;
  s[1] = s1;
  s[2] = u0;
  s[3] = u1;
  return z;
}

// y += P x for a power P of M (its upper right 2x2 block is zero), P
// 16-byte aligned: six 16-byte loads.
__device__ __forceinline__ void mat_acc(const double* P, const double (&x)[4], double (&y)[4]) {
  const double2* Q = reinterpret_cast<const double2*>(P);
  const double2 r0 = Q[0], r1 = Q[2], r2 = Q[4], r3 = Q[5], r4 = Q[6], r5 = Q[7];
  y[0] = fma(r0.x, x[0], fma(r0.y, x[1], y[0]));
  y[1] = fma(r1.x, x[0], fma(r1.y, x[1], y[1]));
  y[2] = fma(r2.x, x[0], fma(r2.y, x[1], fma(r3.x, x[2], fma(r3.y, x[3], y[2]))));
  y[3] = fma(r4.x, x[0], fma(r4.y, x[1], fma(r5.x, x[2], fma(r5.y, x[3], y[3]))));
}

// y += P x for lane power P of an element-major lane table.
__device__ __forceinline__ void mat_acc_lane(const double* L, int lane, const double (&x)[4], double (&y)[4]) {
  const double* P = L + lane;
  y[0] = fma(P[0 * 32], x[0], fma(P[1 * 32], x[1], y[0]));
  y[1] = fma(P[4 * 32], x[0], fma(P[5 * 32], x[1], y[1]));
  y[2] = fma(P[8 * 32], x[0], fma(P[9 * 32], x[1], fma(P[10 * 32], x[2], fma(P[11 * 32], x[3], y[2]))));
  y[3] = fma(P[12 * 32], x[0], fma(P[13 * 32], x[1], fma(P[14 * 32], x[2], fma(P[15 * 32], x[3], y[3]))));
}

__device__ __forceinline__ void shfl_up4(const double (&v)[4], double (&o)[4], int d) {
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = __shfl_up_sync(FULL, v[i], d);
}

__device__ __forceinline__ void shfl4(const double (&v)[4], double (&o)[4], int src) {
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = __shfl_sync(FULL, v[i], src);
}

// Thread j of NT holds e, the end state of its run from zero, every run n
// samples long (P = M^n).  Returns with TOT in tot the block's end state, P^NT
// c + sum_i P^(NT-1-i) e_i, and with STARTS in s thread j's start state, P^j c +
// sum_{i<j} P^(j-1-i) e_i: a shuffle scan in each warp with the ladder, a
// shuffle scan of the warp totals (every warp alike) with P^(32 2^l), then
// the warp's and the lane's powers.  A fixed order: the same bits every run.
template <int NT, bool STARTS, bool TOT = true>
__device__ void scan_states(const double (&e)[4], const double (&c)[4], const Pow& p, double (*wt)[4],
                            double (&s)[4], double (&tot)[4]) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double v[4] = {e[0], e[1], e[2], e[3]};
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    double o[4];
    shfl_up4(v, o, 1 << l);
    if (lane >= (1 << l)) mat_acc(p.step + 16 * l, o, v);
  }
  if (lane == 31) {
#pragma unroll
    for (int i = 0; i < 4; ++i) wt[warp][i] = v[i];
  }
  __syncthreads();
  double u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) u[i] = lane < NW ? wt[lane][i] : 0.0;
#pragma unroll
  for (int l = 0; (1 << l) < NW; ++l) {
    double o[4];
    shfl_up4(u, o, 1 << l);
    if (lane >= (1 << l)) mat_acc(p.step + 16 * (5 + l), o, u);
  }
  if (TOT) {
    shfl4(u, tot, NW - 1);
    mat_acc(p.warp + 16 * NW, c, tot);
  }
  if (STARTS) {
    double x[4], ex[4];
    shfl4(u, x, warp > 0 ? warp - 1 : 0);
    shfl_up4(v, ex, 1);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (warp == 0) x[i] = 0.0;
      if (lane == 0) ex[i] = 0.0;
    }
    mat_acc(p.warp + 16 * warp, c, x);  // the warp's start state
    mat_acc_lane(p.lane, lane, x, ex);
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = ex[i];
  }
  __syncthreads();  // wt is free again
}

__global__ void __launch_bounds__(T, 3) k9_sums(const __grid_constant__ K9Args a) {
  extern __shared__ float4 dyn9[];
  double* tab = reinterpret_cast<double*>(dyn9);  // the weights, the powers of M^run
  float* xs = reinterpret_cast<float*>(tab + k9_tab(a.run));  // the block's samples
  __shared__ double wt[WARPS][4];
  __shared__ double red[WARPS];
  __shared__ float redp[WARPS];
  const int j = threadIdx.x, r = blockIdx.y, blk = blockIdx.x;
  const int64_t n = valid_n(a.ns, r / a.C, a.L);
  const int64_t b0 = (int64_t)blk * a.ch;
  if (b0 >= n) return;  // the whole block: past this row's samples
  const int nb = (int)min64(a.ch, n - b0);
  const int64_t slot = (int64_t)r * a.nb_max + blk;
  PHASE_BEGIN
  stage_doubles(a.w, k9_tab(a.run), tab);
  const int pad = stage(a.wavs + (int64_t)r * a.L + b0, nb, xs);
  const Pow prun = pow_at(tab + 4 * a.run);
  PHASE(0)
  const int p0 = j * a.run;
  const int cnt = max(0, min(a.run, nb - p0));
  const float* xr = xs + pad + p0;
  double e[4] = {0.0, 0.0, 0.0, 0.0};
  double sq = 0.0;
  float pk = 0.0f;
#pragma unroll 4
  for (int i = 0; i < cnt; ++i) {
    const float v = xr[i];
    const double d = v;
    sq = fma(d, d, sq);
    pk = nan_max(pk, fabsf(v));
    const double2* w = reinterpret_cast<const double2*>(tab + 4 * (cnt - 1 - i));
    const double2 w0 = w[0], w1 = w[1];
    e[0] = fma(w0.x, d, e[0]);
    e[1] = fma(w0.y, d, e[1]);
    e[2] = fma(w1.x, d, e[2]);
    e[3] = fma(w1.y, d, e[3]);
  }
  PHASE(1)
  // every run before the last is full, so the scan gives each run's start
  const double zero[4] = {0.0, 0.0, 0.0, 0.0};
  double s[4], tot[4];
  scan_states<T, true, false>(e, zero, prun, wt, s, tot);
  double* rs = a.rstart + (slot * T + j) * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) rs[i] = s[i];
  if (cnt > 0 && p0 + cnt == nb) {  // the last run ends the block: M^cnt s + e
    mat_acc(nb == a.ch ? a.mfull : a.w + 4 * a.run + POW_TABLE + 16 * cnt, s, e);
#pragma unroll
    for (int i = 0; i < 4; ++i) a.ends[slot * 4 + i] = e[i];
  }
  const double ssq = block_sum<T>(sq, red);
  const float spk = block_nan_max<T>(pk, redp);
  if (j == 0) {
    a.part_sq[slot] = ssq;
    a.part_pk[slot] = spk;
  }
  PHASE(2)
}

// Each thread takes carry_k consecutive block ends: their sum carried to the
// last one's end (Horner with M^ch), one scan of those with the powers of
// M^(ch K), then each block's start state walking the thread's blocks again.
// A tile's states pass through shared memory (coalesced copies; thread j's
// block i at (i TC + j) 5, a stride of 5 doubles without bank conflicts).
__global__ void __launch_bounds__(TC) k9_carry(const __grid_constant__ K9Args a) {
  extern __shared__ float4 dyn9[];
  double* sm = reinterpret_cast<double*>(dyn9);  // (K, TC, 5) a tile's states
  __shared__ double wt[TC / 32][4];
  __shared__ __align__(16) double tab[pow_prefix(TC / 32) + 16];  // powers of M^(ch K), M^ch
  const int j = threadIdx.x, r = blockIdx.x, K = a.carry_k, lk = __ffs(K) - 1;
  PHASE_BEGIN
  stage_doubles(a.pck, pow_prefix(TC / 32), tab);
  stage_doubles(a.pck + POW_TABLE, 16, tab + pow_prefix(TC / 32));
  stage_wait();
  const Pow pk = pow_at(tab);
  const double* p1 = tab + pow_prefix(TC / 32);
  PHASE(3)
  const int64_t n = valid_n(a.ns, r / a.C, a.L);
  const int64_t nb = (n + a.ch - 1) / a.ch;
  double* __restrict__ st = a.starts + (int64_t)r * a.nb_max * 4;
  const double* __restrict__ en = a.ends + (int64_t)r * a.nb_max * 4;
  double c[4] = {0.0, 0.0, 0.0, 0.0};  // the state entering the tile
  for (int64_t k0 = 0; k0 < nb; k0 += (int64_t)TC * K) {  // nb is the same in every thread
    const int nt = (int)min64((int64_t)TC * K, nb - k0);
    for (int d = j; d < TC * K * 4; d += TC) {
      const int b = d >> 2;
      sm[((b & (K - 1)) * TC + (b >> lk)) * 5 + (d & 3)] = b < nt ? en[k0 * 4 + d] : 0.0;
    }
    __syncthreads();
    double e[4] = {0.0, 0.0, 0.0, 0.0};
    for (int i = 0; i < K; ++i) {
      const double* v = sm + (i * TC + j) * 5;
      double t[4] = {v[0], v[1], v[2], v[3]};
      mat_acc(p1, e, t);
#pragma unroll
      for (int u = 0; u < 4; ++u) e[u] = t[u];
    }
    PHASE(4)
    double s[4], tot[4];
    scan_states<TC, true>(e, c, pk, wt, s, tot);
    PHASE(5)
    for (int i = 0; i < K; ++i) {
      double* v = sm + (i * TC + j) * 5;
      double t[4] = {v[0], v[1], v[2], v[3]};
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = s[u];
      mat_acc(p1, s, t);
#pragma unroll
      for (int u = 0; u < 4; ++u) s[u] = t[u];
    }
    __syncthreads();
    for (int d = j; d < nt * 4; d += TC) {
      const int b = d >> 2;
      st[k0 * 4 + d] = sm[((b & (K - 1)) * TC + (b >> lk)) * 5 + (d & 3)];
    }
    __syncthreads();  // sm is free again
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = tot[i];
    PHASE(6)
  }
}

__global__ void __launch_bounds__(T, 3) k9_energy(const __grid_constant__ K9Args a) {
  extern __shared__ float4 dyn9[];
  double* tab = reinterpret_cast<double*>(dyn9);
  float* xs = reinterpret_cast<float*>(tab + k9_tab(a.run));
  __shared__ double lo_s[T], hi_s[T];
  const int j = threadIdx.x, lane = j & 31, warp = j >> 5;
  const int r = blockIdx.y, blk = blockIdx.x;
  const int64_t n = valid_n(a.ns, r / a.C, a.L);
  const int64_t b0 = (int64_t)blk * a.ch;
  if (b0 >= n) return;
  const int nb = (int)min64(a.ch, n - b0);
  const int64_t slot = (int64_t)r * a.nb_max + blk;
  PHASE_BEGIN
  // the run's start: P^j R + its start from zero (k9_sums), P^j = P^lane P^(32
  // warp); its loads go out before the samples'
  double R[4], x[4] = {0.0, 0.0, 0.0, 0.0}, s[4];
  const double* rs = a.rstart + (slot * T + j) * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    R[i] = a.starts[slot * 4 + i];
    s[i] = rs[i];
  }
  stage_doubles(a.w, k9_tab(a.run), tab);
  const int pad = stage(a.wavs + (int64_t)r * a.L + b0, nb, xs);
  const Pow prun = pow_at(tab + 4 * a.run);
  PHASE(8)
  mat_acc(prun.warp + 16 * warp, R, x);
  mat_acc_lane(prun.lane, lane, x, s);
  PHASE(9)
  // re-run from the start state, squares into the segments the run touches
  const int p0 = j * a.run;
  const int cnt = max(0, min(a.run, nb - p0));
  const float* xr = xs + pad + p0;
  const int first = (p0 / a.s100 + 1) * a.s100 - p0;  // samples left in p0's segment
  double lo = 0.0, hi = 0.0;
#pragma unroll 4
  for (int i = 0; i < cnt; ++i) {
    const double z = k_step(a.k, xr[i], s);
    if (i < first)
      lo = fma(z, z, lo);
    else
      hi = fma(z, z, hi);
  }
  lo_s[j] = lo;
  hi_s[j] = hi;
  __syncthreads();
  PHASE(11)
  // a warp per whole segment adds its threads' parts in order
  const int64_t n_seg = n / a.s100;
  for (int k = warp; k < a.G; k += WARPS) {
    const int64_t g = (int64_t)blk * a.G + k;
    if (g >= n_seg) break;
    const int j0 = k * a.s100 / a.run, j1 = ((k + 1) * a.s100 - 1) / a.run;
    double t = 0.0;
    for (int jj = j0 + lane; jj <= j1; jj += 32) t += jj * a.run / a.s100 == k ? lo_s[jj] : hi_s[jj];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(FULL, t, o);
    if (lane == 0) a.seg[(int64_t)r * a.n_seg_max + g] = t;
  }
  PHASE(12)
}

// searchsorted(bounds, z, right=True) - 1, clamped to [0, 999], for z >=
// bounds[0]: bounds[i] = 10^((i/10 - 70 + 0.691)/10), so i is near 100
// log10(z) + 693.09; the f32 estimate is then moved to the exact bin.
__device__ __forceinline__ int hist_bin(const double* bounds, double z) {
  float f = 30.1029995664f * log2f((float)z) + 693.09f;
  f = fminf(fmaxf(f, 0.0f), 1000.0f);
  int i = (int)f;
  while (i < 1000 && bounds[i + 1] <= z) ++i;
  while (i > 0 && bounds[i] > z) --i;
  return min(i, 999);
}

__device__ __forceinline__ int64_t gating_blocks(const K9Args& a, int64_t n) {
  return n >= a.win ? (n - a.win) / a.s100 + 1 : 0;
}

// Per item and tile of gate_tile 400 ms blocks: each block's energy (the
// weighted channel sums of its four segments, staged in shared memory), its
// histogram bin (-1 below the -70 LUFS absolute gate) and the tile's count
// and energy above that gate.
__global__ void __launch_bounds__(T) k9_gate(const __grid_constant__ K9Args a, const double* bounds,
                                             const double* energies) {
  extern __shared__ float4 dyn9[];
  double* sg = reinterpret_cast<double*>(dyn9);  // (C, gate_tile + 3) segment sums
  __shared__ double red[WARPS];
  const int tile = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const int64_t n_blocks = gating_blocks(a, valid_n(a.ns, b, a.L));
  const int64_t t0 = (int64_t)tile * a.gate_tile;
  if (t0 >= n_blocks) return;
  const int nt = (int)min64(a.gate_tile, n_blocks - t0);
  const int w = a.gate_tile + 3;
  PHASE_BEGIN
  for (int c = 0; c < a.C; ++c) {
    const double* src = a.seg + ((int64_t)b * a.C + c) * a.n_seg_max + t0;
    for (int i = j; i < nt + 3; i += T) sg[c * w + i] = src[i];
  }
  __syncthreads();
  PHASE(13)
  const double floor0 = __ldg(bounds);
  double cnt = 0.0, tot = 0.0;
  for (int i = j; i < nt; i += T) {
    double z = 0.0;
    for (int c = 0; c < a.C; ++c) {
      const double* s4 = sg + c * w + i;
      z += (c >= 3 ? a.surround : 1.0) * (s4[0] + s4[1] + s4[2] + s4[3]);
    }
    z /= a.win;
    int bin = -1;
    if (z >= floor0) {
      bin = hist_bin(bounds, z);
      cnt += 1.0;
      tot += __ldg(energies + bin);
    }
    a.bins[(int64_t)b * a.n_gb_max + t0 + i] = (int16_t)bin;
  }
  cnt = block_sum<T>(cnt, red);
  tot = block_sum<T>(tot, red);
  if (j == 0) {
    double* o = a.gate_part + ((int64_t)b * a.tiles_max + tile) * 2;
    o[0] = cnt;
    o[1] = tot;
  }
  PHASE(14)
}

// One block an item: the raw stats over the blocks' partials, the absolute
// gate's count and energy over the tiles', the -10 LU relative gate over the
// bins, the means and log10.
__global__ void __launch_bounds__(TT) k9_tail(const __grid_constant__ K9Args a, const double* energies,
                                              double* lufs, double* sum_sq, double* peak) {
  __shared__ double red[TT / 32];
  __shared__ float redp[TT / 32];
  __shared__ double es[1000];
  const int b = blockIdx.x, j = threadIdx.x;
  for (int i = j; i < 1000; i += TT) es[i] = energies[i];
  const int64_t n = valid_n(a.ns, b, a.L);
  const int64_t nb = (n + a.ch - 1) / a.ch;
  double s = 0.0;
  float p = 0.0f;
  for (int c = 0; c < a.C; ++c) {
    const int64_t row = ((int64_t)b * a.C + c) * a.nb_max;
    for (int64_t k = j; k < nb; k += TT) {
      s += a.part_sq[row + k];
      p = nan_max(p, a.part_pk[row + k]);
    }
  }
  const int64_t n_blocks = gating_blocks(a, n);
  const int64_t tiles = (n_blocks + a.gate_tile - 1) / a.gate_tile;
  double cnt = 0.0, tot = 0.0;
  for (int64_t k = j; k < tiles; k += TT) {
    cnt += a.gate_part[((int64_t)b * a.tiles_max + k) * 2];
    tot += a.gate_part[((int64_t)b * a.tiles_max + k) * 2 + 1];
  }
  s = block_sum<TT>(s, red);  // its barrier also publishes es
  p = block_nan_max<TT>(p, redp);
  cnt = block_sum<TT>(cnt, red);
  tot = block_sum<TT>(tot, red);
  const double gate = tot / fmax(cnt, 1.0) * a.rel_gate;
  double cnt2 = 0.0, tot2 = 0.0;
  const int16_t* bins = a.bins + (int64_t)b * a.n_gb_max;
  for (int64_t t = j; t < n_blocks; t += TT) {
    const int bin = bins[t];
    if (bin >= 0) {
      const double q = es[bin];
      if (q > gate) {
        cnt2 += 1.0;
        tot2 += q;
      }
    }
  }
  cnt2 = block_sum<TT>(cnt2, red);
  tot2 = block_sum<TT>(tot2, red);
  if (j == 0) {
    lufs[b] = cnt2 > 0.0 ? -0.691 + 10.0 * log10(fmax(tot2 / cnt2, 1e-300)) : -CUDART_INF;
    sum_sq[b] = s;
    peak[b] = (double)p;
  }
}

// ---------------------------------------------------------------------------
// K8

constexpr int T8 = 256;    // threads of k8_spans and k8_gain
constexpr int T8C = 1024;  // threads of k8_carry

struct K8Args {
  const float* wavs;  // (B, C, L)
  int64_t L, ch;      // row width; output positions a chunk owns
  int C, hold, n_box, hbox, nb, buf;  // buf: positions a block's level buffers hold
  int carry_k;    // chunks a k8_carry thread takes
  int bufp;       // buf rounded up to 4: the levels at 0, their suffix maxima (bufp + 4) after
  bool stage2;    // k8_gain stages a second channel in its release buffer
  int box[K8_MAX_BOX];
  double thr, slew;
  double* tri;     // (B, nb, 3) each chunk's release map (A, E, C)
  double* starts;  // (B, nb) release value entering each chunk's span
  double* out;     // (B, L) the gains
};

// A composed stretch of release steps on centred values eta = y - 1: eta ->
// min(C, A eta + E).  Centred, a stretch the limiter leaves alone maps 0 to
// exactly 0, and the identity is exact.
struct Tri {
  double A, E, C;
};

__device__ __forceinline__ Tri tri_identity() { return {1.0, 0.0, CUDART_INF}; }

// later o earlier
__device__ __forceinline__ Tri compose(const Tri& l, const Tri& e) {
  return {l.A * e.A, fma(l.A, e.E, l.E), fmin(l.C, e.C == CUDART_INF ? CUDART_INF : fma(l.A, e.C, l.E))};
}

__device__ __forceinline__ double apply(const Tri& f, double eta) { return fmin(f.C, fma(f.A, eta, f.E)); }

__device__ __forceinline__ Tri shfl_up_tri(const Tri& f, int d) {
  return {__shfl_up_sync(FULL, f.A, d), __shfl_up_sync(FULL, f.E, d), __shfl_up_sync(FULL, f.C, d)};
}

__device__ __forceinline__ Tri shfl_down_tri(const Tri& f, int d) {
  return {__shfl_down_sync(FULL, f.A, d), __shfl_down_sync(FULL, f.E, d), __shfl_down_sync(FULL, f.C, d)};
}

// The composition of the block's NT threads' maps, thread 0's applied
// first; valid in thread 0 (an ordered tree in each warp, then the warps in
// order).
template <int NT>
__device__ Tri reduce_tri(Tri f, Tri* wt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Tri o = shfl_down_tri(f, d);
    if ((lane & (2 * d - 1)) == 0) f = compose(o, f);
  }
  if (lane == 0) wt[warp] = f;
  __syncthreads();
  Tri t = tri_identity();
  if (threadIdx.x == 0)
    for (int w = 0; w < NT / 32; ++w) t = compose(wt[w], t);
  return t;
}

// The composition of threads 0 .. j-1's maps in p (the identity for j = 0)
// and of all NT of them in tot, in every thread (a fixed order).
template <int NT>
__device__ void scan_tri(const Tri& f, Tri* wt, Tri& p, Tri& tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Tri v = f;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Tri o = shfl_up_tri(v, d);
    if (lane >= d) v = compose(v, o);
  }
  if (lane == 31) wt[warp] = v;
  __syncthreads();
  Tri x = tri_identity();
  tot = tri_identity();
  for (int w = 0; w < NT / 32; ++w) {
    if (w == warp) x = tot;
    tot = compose(wt[w], tot);
  }
  Tri ex = shfl_up_tri(v, 1);
  if (lane == 0) ex = tri_identity();
  p = lane == 0 ? x : compose(ex, x);
  __syncthreads();
}

// The exclusive prefix sum of v over the block's NT threads, in a fixed
// order; its first barrier follows every thread's earlier reads.
template <int NT>
__device__ double scan_sum(double v, double* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double o = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v = o + v;
  }
  if (lane == 31) ws[warp] = v;
  __syncthreads();
  double x = 0.0;
  for (int w = 0; w < warp; ++w) x += ws[w];
  double ex = __shfl_up_sync(FULL, v, 1);
  if (lane == 0) ex = 0.0;
  __syncthreads();
  return x + ex;
}

// 1 / d for finite d >= 2^-52 to within an ulp: the hardware's estimate and
// two Newton steps (an f64 division compiles to a call with a slow path,
// whose saved registers spill).
__device__ __forceinline__ double recip(double d) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(d));
  r = fma(r, fma(-d, r, 1.0), r);
  return fma(r, fma(-d, r, 1.0), r);
}

// s / l correctly rounded but for rare ties, by the reciprocal inv and one
// exact residual: l / l is exactly 1.
__device__ __forceinline__ double div_by(double s, double l, double inv) {
  const double q = s * inv;
  return fma(fma(-q, l, s), inv, q);
}

// thr / (v + eps) where the level v exceeds the threshold, else 1 (also for
// v = -inf: before t = 0, or only NaN channels); 0 for v = inf.
__device__ __forceinline__ double gain_of(const K8Args& a, float v) {
  const double d = v;
  if (!(d > a.thr)) return 1.0;
  const double den = d + F64_EPS;
  return den == CUDART_INF ? 0.0 : div_by(a.thr, den, recip(den));
}

// This thread's share [lo, hi) of m positions, q = ceil(m / NT) a thread.
template <int NT>
__device__ __forceinline__ int share(int m, int& lo, int& hi) {
  const int q = (m + NT - 1) / NT;
  lo = min((int)threadIdx.x * q, m);
  hi = min(lo + q, m);
  return q;
}

// lv[i] = the NaN-ignoring channel max of |x| at position r0 + i, i < n;
// -inf before t = 0.  One channel, or two where st1 is given, are staged by
// cp.async into st0 and st1 (n + 3 floats each) first; more are read
// directly.
template <int NT>
__device__ void load_levels(const K8Args& a, const float* x, int64_t r0, int n, float* lv, float* st0,
                            float* st1) {
  const int skip = (int)max64(-r0, 0);  // positions before t = 0
  if (a.C == 1 || (a.C == 2 && st1)) {
    const int p0 = stage_async(x + r0 + skip, n - skip, st0);
    const int p1 = a.C == 2 ? stage_async(x + a.L + r0 + skip, n - skip, st1) : 0;
    stage_wait();
    for (int i = threadIdx.x; i < n; i += NT) {
      float v = -CUDART_INF_F;
      if (i >= skip) {
        const float m0 = fabsf(st0[p0 + i - skip]);
        if (m0 > v) v = m0;  // false for NaN
        if (a.C == 2) {
          const float m1 = fabsf(st1[p1 + i - skip]);
          if (m1 > v) v = m1;
        }
      }
      lv[i] = v;
    }
    return;
  }
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += NT) {
    const int64_t t = r0 + i;
    float v = -CUDART_INF_F;
    if (t >= 0)
      for (int c = 0; c < a.C; ++c) {
        const float m = fabsf(__ldg(x + (int64_t)c * a.L + t));
        if (m > v) v = m;  // false for NaN
      }
    lv[i] = v;
  }
}

// The hold: the max of lv over the hold - 1 positions before i and i itself,
// for every i >= hold - 1 of the n levels; returns where it lies (lv itself,
// overwritten, or sfx).  Van Herk/Gil-Werman over the threads' segments of q
// positions: each thread's suffix maxima (sfx) and segment maximum, then a
// walk with the running prefix.  A hold no longer than a segment is taken
// directly into sfx.
template <int NT>
__device__ float* hold_max(const K8Args& a, float* lv, float* sfx, float* segmax, int n) {
  const int j = threadIdx.x, w = a.hold;
  int lo, hi;
  const int q = share<NT>(n, lo, hi);
  if (w <= q) {
    for (int i = max(lo, w - 1); i < hi; ++i) {
      float v = lv[i];
      for (int u = i - w + 1; u < i; ++u) v = fmaxf(v, lv[u]);
      sfx[i] = v;
    }
    __syncthreads();
    return sfx;
  }
  float run = -CUDART_INF_F;
#pragma unroll 4
  for (int i = hi - 1; i >= lo; --i) {
    run = fmaxf(run, lv[i]);
    sfx[i] = run;
  }
  segmax[j] = run;
  __syncthreads();
  if (hi > max(lo, w - 1)) {
    // the window's start i - w + 1 lies in segment sa0 or sa0 + 1; the whole
    // segments between it and this one, for both
    const int sa0 = max(lo - w + 1, 0) / q;
    float mid1 = -CUDART_INF_F;
#pragma unroll 4
    for (int s = sa0 + 2; s < j; ++s) mid1 = fmaxf(mid1, segmax[s]);
    const float mid0 = sa0 + 1 < j ? fmaxf(mid1, segmax[sa0 + 1]) : mid1;
    const int edge = (sa0 + 1) * q;  // window starts from here on lie in segment sa0 + 1
    float pre = -CUDART_INF_F;
#pragma unroll 4
    for (int i = lo; i < hi; ++i) {
      pre = fmaxf(pre, lv[i]);
      if (i >= w - 1) {
        const int s0 = i - w + 1;
        lv[i] = fmaxf(fmaxf(sfx[s0], s0 < edge ? mid0 : mid1), pre);
      }
    }
  }
  __syncthreads();
  return lv;
}

// The release steps of positions t0 + lo .. t0 + hi - 1 at holds mv[lo ..),
// composed (positions before t = 0 are the identity).  Step: eta -> min(h -
// 1, (1 - slew) eta + slew (h - 1)).
__device__ Tri release_map(const K8Args& a, const float* mv, int64_t t0, int lo, int hi) {
  const double ra = 1.0 - a.slew;
  Tri f = tri_identity();
  float last = CUDART_NAN_F;
  double hm = 0.0, se = 0.0;
#pragma unroll 4
  for (int i = max(lo, (int)max64(-t0, 0)); i < hi; ++i) {
    const float m = mv[i];
    if (!(m == last)) {  // the hold keeps its level for long stretches
      hm = gain_of(a, m) - 1.0;
      se = a.slew * hm;
      last = m;
    }
    if (f.C == CUDART_INF) {
      f = {ra, se, hm};
    } else {
      f.A *= ra;
      f.E = fma(ra, f.E, se);
      f.C = fmin(hm, fma(ra, f.C, se));
    }
  }
  return f;
}

__global__ void __launch_bounds__(T8) k8_spans(const __grid_constant__ K8Args a) {
  extern __shared__ float4 dyn8[];
  float* lv = reinterpret_cast<float*>(dyn8);
  __shared__ float segmax[T8];
  __shared__ Tri wt[T8 / 32];
  const int k = blockIdx.x, b = blockIdx.y;
  const float* x = a.wavs + (int64_t)b * a.C * a.L;
  const int64_t p0 = (int64_t)k * a.ch - a.hbox;  // this chunk's span [p0, p1)
  const int64_t p1 = k == a.nb - 1 ? a.L : p0 + a.ch;
  const int64_t r0 = p0 - (a.hold - 1);
  const int n = (int)(p1 - r0);
  PHASE_BEGIN
  float* sfx = lv + a.bufp;
  load_levels<T8>(a, x, r0, n, lv, sfx, sfx + a.bufp + 4);
  __syncthreads();
  PHASE(16)
  const float* mv = hold_max<T8>(a, lv, sfx, segmax, n) + (a.hold - 1);
  PHASE(17)
  int lo, hi;
  share<T8>((int)(p1 - p0), lo, hi);
  const Tri f = reduce_tri<T8>(release_map(a, mv, p0, lo, hi), wt);
  if (threadIdx.x == 0 && k < a.nb - 1) {  // the last chunk's map is not needed
    double* o = a.tri + ((int64_t)b * a.nb + k) * 3;
    o[0] = f.A;
    o[1] = f.E;
    o[2] = f.C;
  }
  PHASE(18)
}

// Each thread takes K consecutive chunks' maps (K = ceil(nb / T8C), at most
// 6): their composition, one ordered scan of those, then each chunk's start
// value walking the thread's chunks again.  A tile's maps pass through
// shared memory (coalesced copies; thread j's chunk i at (i T8C + j) 3).
__global__ void __launch_bounds__(T8C) k8_carry(const __grid_constant__ K8Args a) {
  extern __shared__ float4 dyn8[];
  double* sm = reinterpret_cast<double*>(dyn8);  // (K, T8C, 3) a tile's maps, then starts
  __shared__ Tri wt[T8C / 32];
  const int b = blockIdx.x, j = threadIdx.x, K = a.carry_k;
  double* __restrict__ st = a.starts + (int64_t)b * a.nb;
  const double* __restrict__ tr = a.tri + (int64_t)b * a.nb * 3;
  const Tri id = tri_identity();
  double c = 0.0;  // y_{-1} = 1, centred
  for (int k0 = 0; k0 < a.nb; k0 += T8C * K) {
    const int nt = min(T8C * K, a.nb - k0);
    for (int d = j; d < T8C * K * 3; d += T8C) {
      const int kk = d / 3, e = d - 3 * kk;
      const double v = k0 + kk < a.nb - 1 ? tr[(int64_t)(k0 + kk) * 3 + e] : e == 0 ? id.A : e == 1 ? id.E : id.C;
      sm[((kk % K) * T8C + kk / K) * 3 + e] = v;
    }
    __syncthreads();
    Tri f = id;
    for (int i = 0; i < K; ++i) {
      const double* v = sm + (i * T8C + j) * 3;
      f = compose({v[0], v[1], v[2]}, f);
    }
    Tri p, tot;
    scan_tri<T8C>(f, wt, p, tot);
    double y = j == 0 ? c : apply(p, c);
    for (int i = 0; i < K; ++i) {
      double* v = sm + (i * T8C + j) * 3;
      const Tri t = {v[0], v[1], v[2]};
      v[0] = y;
      y = apply(t, y);
    }
    __syncthreads();
    for (int kk = j; kk < nt; kk += T8C) st[k0 + kk] = sm[((kk % K) * T8C + kk / K) * 3];
    __syncthreads();  // sm is free again
    c = apply(tot, c);
  }
}

// The centred release values eta = y - 1 of positions q0 + lo .. q0 + hi - 1
// from eta (0 before t = 0, the box stack's pre-history) into out: their
// running sum from lo (the first box's prefix sums) or, with no box, the
// values; returns the sum.
__device__ double release_walk(const K8Args& a, const float* mv, int64_t q0, int lo, int hi, double eta,
                               double* out) {
  const double ra = 1.0 - a.slew;
  float last = CUDART_NAN_F;
  double hm = 0.0, se = 0.0, run = 0.0;
#pragma unroll 4
  for (int i = lo; i < hi; ++i) {
    double v = 0.0;
    if (q0 + i >= 0) {
      const float lvl = mv[i];
      if (!(lvl == last)) {
        hm = gain_of(a, lvl) - 1.0;
        se = a.slew * hm;
        last = lvl;
      }
      eta = fmin(hm, fma(ra, eta, se));
      v = eta;
    }
    run += v;
    out[i] = a.n_box ? run : v;
  }
  return run;
}

__global__ void __launch_bounds__(T8) k8_gain(const __grid_constant__ K8Args a) {
  extern __shared__ float4 dyn8[];
  float* lv = reinterpret_cast<float*>(dyn8);  // levels, then holds (buf floats)
  float* sfx = lv + a.bufp;                      // suffix maxima (bufp + 4 floats)
  double* pb = reinterpret_cast<double*>(dyn8);  // later: prefix sums (m doubles)
  double* pa = reinterpret_cast<double*>(sfx + a.bufp + 4);  // prefix sums (m doubles)
  __shared__ float segmax[T8];
  __shared__ Tri wt[T8 / 32];
  __shared__ double offs[T8], ws[T8 / 32];
  const int k = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const float* x = a.wavs + (int64_t)b * a.C * a.L;
  const int64_t t0 = (int64_t)k * a.ch, t1 = min64(t0 + a.ch, a.L);
  const int64_t q0 = t0 - a.hbox;  // release values of [q0, t1) feed outputs [t0, t1)
  const int m = (int)(t1 - q0);
  const int64_t r0 = q0 - (a.hold - 1);
  PHASE_BEGIN
  load_levels<T8>(a, x, r0, m + a.hold - 1, lv, sfx, a.stage2 ? reinterpret_cast<float*>(pa) : nullptr);
  __syncthreads();
  PHASE(20)
  const float* mv = hold_max<T8>(a, lv, sfx, segmax, m + a.hold - 1) + (a.hold - 1);
  PHASE(21)
  int lo, hi;
  const int q = share<T8>(m, lo, hi);
  Tri p, tot;
  scan_tri<T8>(release_map(a, mv, q0, lo, hi), wt, p, tot);
  const double y0 = a.starts[(int64_t)b * a.nb + k];
  const double run = release_walk(a, mv, q0, lo, hi, j == 0 ? y0 : apply(p, y0), pa);
  offs[j] = scan_sum<T8>(run, ws);  // its barrier: every thread is past the holds
  __syncthreads();
  PHASE(22)
  // the box stack on centred values, on the threads' fixed shares: layer s
  // reads the prefix sums of its input (valid from `from`) in cur with the
  // threads' offsets, and writes its output's prefix sums (from `first`), or
  // the last layer its output, to nxt
  double* cur = pa;
  double* nxt = pb;
  int from = 0;
  for (int s = 0; s < a.n_box; ++s) {
    const int l = a.box[s], first = from + l - 1;
    const double inv = recip((double)l), off = offs[j];
    const bool last = s == a.n_box - 1;
    double acc = 0.0;
    const int u0 = max(lo, first);
    int owner = max(u0 - l, 0) / q;  // the thread whose share holds u - l
#pragma unroll 4
    for (int u = u0; u < hi; ++u) {
      const int v = u - l;  // the prefix sum before the window
      if (v >= (owner + 1) * q) ++owner;
      const double back = v < from ? 0.0 : offs[owner] + cur[v];
      const double o = ((off + cur[u]) - back) * inv;
      acc += o;
      nxt[u] = last ? o : acc;
    }
    if (!last) offs[j] = scan_sum<T8>(acc, ws);
    __syncthreads();
    double* t = cur;
    cur = nxt;
    nxt = t;
    from = first;
  }
  PHASE(23)
  double* o = a.out + (int64_t)b * a.L + q0;
  for (int i = a.hbox + j; i < m; i += T8) o[i] = fmin(cur[i] + 1.0, 1.0);
  PHASE(24)
}

// ---------------------------------------------------------------------------
// K10: the gain and the guard

constexpr int T10 = 256;
enum { K10_GAIN = 0, K10_CLIP = 1, K10_SCALE = 2, K10_SEQ = 3 };

// a float's bits as an unsigned key in the floats' order (NaN aside)
__device__ __forceinline__ unsigned ordered_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// x (rows, n): peak_bits[row] = bits of max |float32(g) x| (NaN skipped, from
// 0), nan[row] = 1 where the row holds a NaN; gained (rows, n) when not null.
// peak_bits and nan start at 0.  Grid (blocks, rows).
__global__ void __launch_bounds__(T10) k10_peak(const float* __restrict__ x, float* __restrict__ gained,
                                                int64_t n, float g, unsigned* peak_bits, unsigned* nan) {
  __shared__ float wm[T10 / 32];
  __shared__ unsigned wn[T10 / 32];
  const int r = blockIdx.y, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const float* xr = x + (int64_t)r * n;
  float* gr = gained ? gained + (int64_t)r * n : nullptr;
  float m = 0.0f;
  unsigned has_nan = 0;
  for (int64_t i = (int64_t)blockIdx.x * T10 + threadIdx.x; i < n; i += (int64_t)gridDim.x * T10) {
    const float v = __fmul_rn(g, xr[i]);
    if (gr) gr[i] = v;
    const float av = fabsf(v);
    if (av > m) m = av;  // false for NaN: skipped
    has_nan |= v != v;
  }
  for (int d = 16; d; d >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, d));  // m is never NaN
  has_nan = __any_sync(FULL, has_nan);
  if (lane == 0) {
    wm[w] = m;
    wn[w] = has_nan;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < T10 / 32; ++k) {
      m = fmaxf(m, wm[k]);
      has_nan |= wn[k];
    }
    if (m > 0.0f) atomicMax(peak_bits + r, __float_as_uint(m));  // non-negative: bits order as floats
    if (has_nan) atomicOr(nan + r, 1u);
  }
}

struct K10Args {
  const float* x;
  float* y;
  const double* seq;  // K10_SEQ: n gains
  float* seq32;       // K10_SEQ: the gains in f32
  unsigned long long* stats;
  int64_t n;
  float g;
  double s;  // K10_SCALE
};

// y (rows, n) = the guard of float32(g) x; stats, from 0: K10_CLIP the rows'
// counts of |gained| > 1; K10_SEQ [count of f32(seq) != 1, ~ordered_key of
// its least value].  Grid (blocks, rows).
template <int MODE>
__global__ void __launch_bounds__(T10) k10_apply(const __grid_constant__ K10Args a) {
  __shared__ unsigned wc[T10 / 32], wk[T10 / 32];
  const int r = blockIdx.y, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const bool gains = MODE == K10_SEQ && r == 0;  // row 0 also rounds and reduces the gains
  const float* xr = a.x + (int64_t)r * a.n;
  float* yr = a.y + (int64_t)r * a.n;
  unsigned cnt = 0, key = 0;
  for (int64_t i = (int64_t)blockIdx.x * T10 + threadIdx.x; i < a.n; i += (int64_t)gridDim.x * T10) {
    const float v = __fmul_rn(a.g, xr[i]);
    float out = v;
    if (MODE == K10_CLIP) {
      out = v < -1.0f ? -1.0f : v > 1.0f ? 1.0f : v;
      cnt += fabsf(v) > 1.0f;
    } else if (MODE == K10_SCALE || MODE == K10_SEQ) {
      const double s = MODE == K10_SEQ ? a.seq[i] : a.s;
      double d = __dmul_rn((double)v, s);
      d = d < -1.0 ? -1.0 : d > 1.0 ? 1.0 : d;
      out = __double2float_rn(d);
      if (gains) {
        const float f = __double2float_rn(s);
        a.seq32[i] = f;
        cnt += f != 1.0f;
        key = max(key, ~ordered_key(f));
      }
    }
    yr[i] = out;
  }
  if (MODE != K10_CLIP && MODE != K10_SEQ) return;
  cnt = __reduce_add_sync(FULL, cnt);
  key = __reduce_max_sync(FULL, key);
  if (lane == 0) {
    wc[w] = cnt;
    wk[w] = key;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned long long total = 0;
  for (int k = 0; k < T10 / 32; ++k) {
    total += wc[k];
    key = max(key, wk[k]);
  }
  if (MODE == K10_CLIP) {
    if (total) atomicAdd(a.stats + r, total);
  } else if (gains) {
    if (total) atomicAdd(a.stats, total);
    if (key) atomicMax(a.stats + 1, (unsigned long long)key);
  }
}

// blocks a row of a K10 pass: about 2048 blocks in all, no more than the row needs
inline unsigned k10_blocks(int64_t rows, int64_t n) {
  const int64_t want = (n + T10 - 1) / T10, cap = 2048 / rows > 0 ? 2048 / rows : 1;
  return (unsigned)(want < cap ? want : cap);
}

}  // namespace

// K9 over n_items items of n_ch rows of width L (f32, each item's rows valid
// for ns[item] samples): lufs, sum_sq, peak (n_items,) f64.  coef (host): the
// 10 coefficients, K9Coef's order, then M^k for k <= run (16 each); table (device, 16-byte aligned,
// kernels/dynamics.py k9_tables): run x 4 weights, then the powers of M^run
// (POW_TABLE doubles), then M^k, k <= run (16 doubles each); carry_table
// (device, 16-byte aligned, k9_carry_table): the powers of M^(ch carry_k),
// then M^ch, ch = G s100.  Workspace: ends, starts (n_items n_ch nb_max 4),
// rstart (n_items n_ch nb_max T 4), part_sq, part_pk (n_items n_ch nb_max), seg
// (n_items n_ch n_seg_max), bins (n_items n_gb_max) int16, gate_part
// (n_items tiles_max 2), nb_max = ceil(L / ch), n_seg_max = L / s100,
// n_gb_max the 400 ms blocks of L samples, tiles_max = ceil(n_gb_max /
// gate_tile).
// Returns a cudaError_t (0: launched).
extern "C" int thesia_lufs_stats(const float* wavs, const int64_t* ns, int64_t n_items, int64_t n_ch,
                                 int64_t L, int64_t s100, int64_t G, int64_t run, int64_t gate_tile,
                                 int64_t carry_k, const double* coef, const double* table,
                                 const double* carry_table, double surround, double rel_gate,
                                 double* ends, double* starts, double* rstart, double* part_sq,
                                 float* part_pk, double* seg, int16_t* bins, double* gate_part,
                                 const double* bounds,
                                 const double* energies, double* lufs, double* sum_sq, double* peak,
                                 void* stream) {
  if (n_items < 1 || n_items > 65535 || n_ch < 1 || n_items * n_ch > 65535 || L < 0 || L >= (1LL << 31) ||
      s100 < 1 || s100 > (1 << 26) || G < 1 || run < 1 || run > s100 || G * s100 > (int64_t)T * run ||
      gate_tile < 1 || carry_k < 1 || carry_k > 8 || (carry_k & (carry_k - 1)) || ((uintptr_t)table & 15) ||
      ((uintptr_t)carry_table & 15))
    return (int)cudaErrorInvalidValue;
  const int64_t smem = 8 * (int64_t)k9_tab((int)run) + 4 * (G * s100 + 4);
  const int64_t gate_smem = 8 * n_ch * (gate_tile + 3);
  const int64_t carry_smem = 8 * 5 * (int64_t)TC * carry_k;
  if (smem > 220 * 1024 || gate_smem > 220 * 1024) return (int)cudaErrorInvalidValue;
  K9Args a;
  a.wavs = wavs;
  a.ns = ns;
  a.L = L;
  a.ch = (int)(G * s100);
  a.run = (int)run;
  a.C = (int)n_ch;
  a.s100 = (int)s100;
  a.G = (int)G;
  a.win = (int)(4 * s100);
  const int64_t nb_max = (L + a.ch - 1) / a.ch;
  a.nb_max = (int)nb_max;
  a.n_seg_max = (int)(L / s100);
  a.gate_tile = (int)gate_tile;
  a.n_gb_max = (int)(L >= a.win ? (L - a.win) / s100 + 1 : 0);
  a.tiles_max = (a.n_gb_max + a.gate_tile - 1) / a.gate_tile;
  a.surround = surround;
  a.rel_gate = rel_gate;
  const double* t = coef;
  a.k = {t[0], t[1], t[2], t[3], t[4], t[5], t[6], t[7], t[8], t[9]};
  a.w = table;
  {
    const int64_t cnt = a.ch - (a.ch - 1) / run * run;  // the last run of a full block
    const double* mk = coef + 10 + 16 * cnt;
    for (int i = 0; i < 16; ++i) a.mfull[i] = mk[i];
  }
  a.pck = carry_table;
  a.carry_k = (int)carry_k;
  a.ends = ends;
  a.starts = starts;
  a.rstart = rstart;
  a.part_sq = part_sq;
  a.part_pk = part_pk;
  a.seg = seg;
  a.bins = bins;
  a.gate_part = gate_part;
  const cudaStream_t st = (cudaStream_t)stream;
  const int rows = (int)(n_items * n_ch);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute((const void*)k9_sums, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute((const void*)k9_energy, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute((const void*)k9_gate, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)gate_smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute((const void*)k9_carry, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)carry_smem)) != cudaSuccess)
    return (int)err;
  if (nb_max > 0) {
    const dim3 grid((unsigned)nb_max, (unsigned)rows);
    k9_sums<<<grid, T, (size_t)smem, st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    k9_carry<<<rows, TC, (size_t)carry_smem, st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    k9_energy<<<grid, T, (size_t)smem, st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (a.tiles_max > 0) {
    k9_gate<<<dim3((unsigned)a.tiles_max, (unsigned)n_items), T, (size_t)gate_smem, st>>>(a, bounds, energies);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  k9_tail<<<(unsigned)n_items, TT, 0, st>>>(a, energies, lufs, sum_sq, peak);
  return (int)cudaGetLastError();
}

// K8 over n_items rows of n_ch channels of width L (f32): out (n_items, L) f64.
// thr >= 0.  box (host): n_box moving-average lengths (at most K8_MAX_BOX),
// hbox the sum of (length - 1) over those above 1; ch output positions a
// chunk; workspace tri (n_items nb 3), starts (n_items nb), nb = ceil(L /
// ch); smem_bytes k8_gain's dynamic shared memory, 8 bufp + 16 + 8 (ch +
// hbox) bytes, bufp = buf rounded up to 4, buf = ch + hbox + hold - 1
// (k8_spans takes 12 bufp + 32).
extern "C" int thesia_limiter_gain(const float* wavs, int64_t n_items, int64_t n_ch, int64_t L,
                                   double thr, double slew, int64_t hold, const int64_t* box,
                                   int64_t n_box, int64_t ch, double* tri, double* starts, double* out,
                                   int64_t smem_bytes, void* stream) {
  if (n_items < 1 || n_items > 65535 || n_ch < 1 || n_ch > 4096 || L < 1 || L >= (1LL << 31) ||
      hold < 1 || hold > (1 << 24) || n_box < 0 || n_box > K8_MAX_BOX || ch < 1 || ch > (1 << 24) ||
      !(thr >= 0.0))
    return (int)cudaErrorInvalidValue;
  K8Args a;
  a.wavs = wavs;
  a.L = L;
  a.ch = ch;
  a.C = (int)n_ch;
  a.hold = (int)hold;
  int64_t hbox = 0;
  int nb_used = 0;
  for (int s = 0; s < K8_MAX_BOX; ++s) a.box[s] = 1;
  for (int s = 0; s < n_box; ++s) {
    if (box[s] < 1 || box[s] > (1 << 24)) return (int)cudaErrorInvalidValue;
    if (box[s] > 1) {
      a.box[nb_used++] = (int)box[s];
      hbox += box[s] - 1;
    }
  }
  a.n_box = nb_used;
  a.hbox = (int)hbox;
  const int64_t buf = ch + hbox + hold - 1, bufp = (buf + 3) & ~3LL;
  if (smem_bytes < 8 * bufp + 16 + 8 * (ch + hbox) || smem_bytes > 220 * 1024)
    return (int)cudaErrorInvalidValue;
  const int64_t nb = (L + ch - 1) / ch;
  if (nb >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  a.nb = (int)nb;
  const int64_t ck = (nb + T8C - 1) / T8C;
  a.carry_k = (int)(ck < 1 ? 1 : ck > 6 ? 6 : ck);
  const int carry_smem = 8 * 3 * T8C * a.carry_k;
  a.buf = (int)buf;
  a.bufp = (int)bufp;
  a.stage2 = 8 * (ch + hbox) >= 4 * (buf + 4);
  a.thr = thr;
  a.slew = slew;
  a.tri = tri;
  a.starts = starts;
  a.out = out;
  const cudaStream_t st = (cudaStream_t)stream;
  const int spans_smem = (int)(12 * bufp + 32);
  cudaError_t err;
  if (spans_smem > 220 * 1024) return (int)cudaErrorInvalidValue;
  if ((err = cudaFuncSetAttribute((const void*)k8_spans, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  spans_smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute((const void*)k8_gain, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_bytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute((const void*)k8_carry, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  carry_smem)) != cudaSuccess)
    return (int)err;
  const dim3 grid((unsigned)nb, (unsigned)n_items);
  k8_spans<<<grid, T8, (size_t)spans_smem, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  k8_carry<<<(unsigned)n_items, T8C, (size_t)carry_smem, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  k8_gain<<<grid, T8, (size_t)smem_bytes, st>>>(a);
  return (int)cudaGetLastError();
}

// K10's first pass over one track's rows x (rows, n) f32: the gain float32(g)
// x, written to gained (rows, n) unless gained is null; peak_bits (rows)
// the bits of each row's NaN-skipping abs max (from 0), nan (rows) 1 where a
// row holds a NaN; both zeroed by the caller.
extern "C" int thesia_guard_peak(const float* x, int64_t rows, int64_t n, float g, float* gained,
                                 unsigned* peak_bits, unsigned* nan, void* stream) {
  if (rows < 1 || rows > 65535 || n < 1 || n >= (1LL << 40)) return (int)cudaErrorInvalidValue;
  const dim3 grid(k10_blocks(rows, n), (unsigned)rows);
  k10_peak<<<grid, T10, 0, (cudaStream_t)stream>>>(x, gained, n, g, peak_bits, nan);
  return (int)cudaGetLastError();
}

// K10's second pass: y (rows, n) f32, the guard of float32(g) x in mode
// (K10_GAIN, K10_CLIP, K10_SCALE with s, K10_SEQ with seq (n) f64, writing
// seq32 (n) f32); stats (int64) as k10_apply's, zeroed by the caller.
extern "C" int thesia_guard_apply(const float* x, int64_t rows, int64_t n, float g, int64_t mode,
                                  double s, const double* seq, float* seq32, float* y,
                                  unsigned long long* stats, void* stream) {
  if (rows < 1 || rows > 65535 || n < 1 || n >= (1LL << 40) || mode < K10_GAIN || mode > K10_SEQ ||
      (mode == K10_SEQ && (seq == nullptr || seq32 == nullptr)) ||
      ((mode == K10_CLIP || mode == K10_SEQ) && stats == nullptr))
    return (int)cudaErrorInvalidValue;
  K10Args a;
  a.x = x;
  a.y = y;
  a.seq = seq;
  a.seq32 = seq32;
  a.stats = stats;
  a.n = n;
  a.g = g;
  a.s = s;
  const dim3 grid(k10_blocks(rows, n), (unsigned)rows);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case K10_GAIN: k10_apply<K10_GAIN><<<grid, T10, 0, st>>>(a); break;
    case K10_CLIP: k10_apply<K10_CLIP><<<grid, T10, 0, st>>>(a); break;
    case K10_SCALE: k10_apply<K10_SCALE><<<grid, T10, 0, st>>>(a); break;
    default: k10_apply<K10_SEQ><<<grid, T10, 0, st>>>(a); break;
  }
  return (int)cudaGetLastError();
}
