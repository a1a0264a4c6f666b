// Batched dynamics for Hopper in float64: K9 (K-weighted LUFS with the sum of
// squares and the peak) and K8 (the limiter's gain sequence), as chunked
// passes with carries instead of doubling scans.
//
// Replaces the JAX package's two device programs of the dynamics path (XLA
// programs, not Pallas kernels):
//   * K9: thesia_tpu/dynamics/stats_device.py:264, _lufs_kernel (with
//     _biquad_scan :237), every add of two or more tracks;
//   * K8: thesia_tpu/dynamics/stats_device.py:161, _limiter_gain_kernel (with
//     _sliding_min :101, _release_scan :127, _box_filter :146), the Limiter
//     over two or more tracks.
// Their plain versions are the torch programs lufs_program and
// limiter_gain_program of thesia_tpu_torch/dynamics/stats_device.py, which
// write the JAX scans out as log2(n) shifted-slice doublings per row: O(n log
// n) work in hundreds of launches.  Here every stage is O(n) in a constant
// number of launches (K9: 4, K8: 3).
//
// What bounds them on the H100: the bytes.  K9 reads each f32 sample once per
// pass (twice in all); K8 reads each f32 sample twice and writes one f64 gain
// per position.  Their f64 arithmetic, a few tens of operations a sample (two
// biquads, a square and two sums; a channel max, a quotient, a sliding min,
// the release step and three moving sums), stays under the bytes at the
// card's 34 TFLOP/s of f64 outside the tensor cores (kernels/dynamics.py:
// lufs_work, limiter_work).  No intermediate signal is written to device
// memory: per-block states, maps and partial sums only.  Nothing is summed
// with atomics: every reduction runs in a fixed order, so two calls on the
// same samples give the same bits.
//
// K9 (one launch each of k9_pass<S,false>, k9_carry, k9_pass<S,true>,
// k9_tail; rows r = item * C + channel, each row's first ns[item] samples):
//   The two K-weighting DF2T biquads form one 4-state affine recurrence
//   S_t = M S_{t-1} + g x_t (M block lower triangular); the sample loop runs
//   the two biquads as written (y stays in registers), and the host gives
//   the powers of M in f64 (kernels/dynamics.py: k9_tables).  A block owns G
//   whole 100 ms segments (ch = G * s100 samples) and walks them in rounds
//   of T * S samples, S a thread:
//   1. pass 1, from a zero state at the block's start: each thread runs its S
//      samples from zero to an end state; a Hillis-Steele scan over the
//      threads with M^(S 2^i) (the round's start state added into thread
//      0's, times M^S) gives every thread its start state; the thread
//      holding the round's last sample re-runs its samples from its start
//      state, which gives the next round's start (exact also when that
//      thread's samples are fewer than S).  The block writes its end state,
//      the sum of squares and the NaN-propagating peak of its raw samples.
//   2. carry, one block a row: block k's true start state by the scan
//      T_{k+1} = M^ch T_k + E_k in tiles of T blocks, M^(ch 2^i).
//   3. pass 2, from the true start state: as pass 1, then every thread
//      re-runs from its start state, squares the output and sums it into
//      the (at most two, S <= s100) segments its samples touch; a warp per
//      segment adds the threads' parts in order into the block's segment
//      sums, which are written once.
//   4. tail, one block an item: 400 ms block energies from four segment
//      sums a channel (surround channels weighted), ebur128's histogram bin
//      (binary search on the boundaries), the -70 LUFS absolute gate, the
//      -10 LU relative gate, the means and log10; the raw stats summed over
//      the blocks' partials.
//
// K8 (k8_chunks, k8_carry, k8_gain; rows = items, channels reduced in the
// loader; every position t < L):
//   Chunks of ch output positions; chunk k's release span is [k ch - hbox,
//   (k+1) ch - hbox) (the last one's runs to L), hbox = sum(box - 1) the box
//   stack's delay.  The release steps y -> min(h, y + slew (h - y)) compose
//   into triples (stats_device.py _release_scan), here centred on 1: y ->
//   min(C, A (y - 1) + E), E the image of 1, so that a stretch the limiter
//   leaves alone maps 1 to exactly 1 (as (A, B), A + B rounds).
//   1. k8_chunks, per chunk in shared memory: the raw gains from the
//      NaN-ignoring channel max, the sliding min over `hold` (doubling
//      windows, +inf before t = 0) with a halo of hold - 1 samples, the
//      span's composed triple.  The hold values go to the output row (the
//      span's first hbox also to the chunk's halo buffer, since the chunk
//      before overwrites them there).
//   2. k8_carry scans the triples into every chunk's start value (y_{-1} = 1).
//   3. k8_gain, per chunk: its hold values (halo, then its own positions of
//      the output row), the release steps re-applied from the start value,
//      the box stack as running sums (pre-history 1.0), min(., 1), written
//      over its own positions.
//   Device memory holds the output row (the hold values, then the gains)
//   and hbox values a chunk besides the per-chunk triples.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int T = 256;  // threads of every block
constexpr int LOG2_T = 8;
constexpr int WARPS = T / 32;
constexpr int K9_MAX_G = 4 * T;  // segments a K9 block may own
constexpr int K8_MAX_BOX = 4;
constexpr double F64_EPS = 0x1p-52;

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

// The sum of v over the block, the same value in every thread and the same
// bits in every run (a fixed butterfly, then the warps in order).
__device__ double block_sum(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double s = 0.0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w];
  __syncthreads();
  return s;
}

__device__ float block_nan_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s = nan_max(s, red[w]);
  __syncthreads();
  return s;
}

// ---------------------------------------------------------------------------
// K9

struct K9Coef {
  // stage 1: y = b0 x + s0; s0' = na1 s0 + s1 + c0 x; s1' = na2 s0 + c1 x
  double na1, na2, c0, c1, b0;
  // stage 2 on y, likewise: z = e0 y + u0; u0' = nb1 u0 + u1 + d0 y; u1' = nb2 u0 + d1 y
  double nb1, nb2, d0, d1, e0;
};

struct K9Args {
  const float* wavs;  // (R, L) rows, R = n_items * C
  const int64_t* ns;  // (n_items,) valid samples of each item's rows
  int64_t L, ch;      // row width; samples a block owns (G segments)
  int C, s100, G, win, nb_max, n_seg_max;
  double surround, rel_gate;
  K9Coef k;
  double tpow[LOG2_T][16];  // M^(S 2^i), row-major 4x4
  double bpow[LOG2_T][16];  // M^(ch 2^i)
  double* ends;             // (R, nb_max, 4) pass 1: each block's end state from zero
  double* starts;           // (R, nb_max, 4) carry: each block's true start state
  double* part_sq;          // (R, nb_max) sum of x^2 of each block's samples
  float* part_pk;           // (R, nb_max) max |x| of each block's samples
  double* seg;              // (R, n_seg_max) K-weighted sum of squares per 100 ms segment
};

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

// y += P x, P row-major 4x4.
__device__ __forceinline__ void mat_acc(const double* P, const double (&x)[4], double (&y)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    y[i] = fma(P[4 * i], x[0], fma(P[4 * i + 1], x[1], fma(P[4 * i + 2], x[2], fma(P[4 * i + 3], x[3], y[i]))));
}

// Inclusive scan of e_j = end state of element j run from zero, over the
// block's threads: after it e (and sc[j]) is x_j = sum_{i<=j} P^(j-i) e_i,
// where pw[l] = P^(2^l).
__device__ void scan4(double (&e)[4], double (*sc)[4], const double (*pw)[16]) {
  const int j = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) sc[j][i] = e[i];
  __syncthreads();
#pragma unroll
  for (int l = 0; l < LOG2_T; ++l) {
    const int d = 1 << l;
    const bool act = j >= d;
    double o[4];
    if (act) {
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] = sc[j - d][i];
    }
    __syncthreads();
    if (act) {
      mat_acc(pw[l], o, e);
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[j][i] = e[i];
    }
    __syncthreads();
  }
}

template <int S, bool P2>
__global__ void __launch_bounds__(T) k9_pass(const __grid_constant__ K9Args a) {
  __shared__ float xs[T * (S + 1)];  // the round's samples, thread j's at j (S + 1)
  __shared__ double sc[T][4];
  __shared__ double rend[4];
  __shared__ double lo_s[P2 ? T : 1], hi_s[P2 ? T : 1];
  __shared__ double acc[P2 ? K9_MAX_G : 1];
  __shared__ double red[WARPS];
  __shared__ float redp[WARPS];
  const int j = threadIdx.x, lane = j & 31, warp = j >> 5;
  const int r = blockIdx.y, blk = blockIdx.x;
  const int64_t n = valid_n(a.ns, r / a.C, a.L);
  const int64_t b0 = (int64_t)blk * a.ch;
  if (b0 >= n) return;  // the whole block: past this row's samples
  const int64_t b1 = min64(b0 + a.ch, n);
  const float* x = a.wavs + (int64_t)r * a.L;
  const int64_t slot = (int64_t)r * a.nb_max + blk;
  double R[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) R[i] = P2 ? a.starts[slot * 4 + i] : 0.0;
  if (P2)
    for (int k = j; k < a.G; k += T) acc[k] = 0.0;
  double sq = 0.0;
  float pk = 0.0f;
  for (int64_t q0 = b0; q0 < b1; q0 += T * S) {
    const int len = (int)min64((int64_t)T * S, b1 - q0);
    __syncthreads();  // the last round's readers of xs, lo_s, hi_s, rend are done
    for (int p = j; p < len; p += T) xs[p + p / S] = x[q0 + p];
    __syncthreads();
    const int cnt = max(0, min(S, len - j * S));
    float v[S];
#pragma unroll
    for (int i = 0; i < S; ++i) v[i] = i < cnt ? xs[j * (S + 1) + i] : 0.0f;
    double e[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int i = 0; i < S; ++i) {
      if (i < cnt) {
        if (!P2) {
          const double d = v[i];
          sq = fma(d, d, sq);
          pk = nan_max(pk, fabsf(v[i]));
        }
        k_step(a.k, v[i], e);
      }
    }
    if (j == 0) mat_acc(a.tpow[0], R, e);  // the round's start state enters at thread 0
    scan4(e, sc, a.tpow);
    // every thread before `last` holds S samples, so sc[j - 1] is thread j's
    // true start state; `last` may hold fewer, and its re-run gives the
    // round's end
    const int last = (len - 1) / S;
    if (j <= last && (P2 || j == last)) {
      double s[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] = j == 0 ? R[i] : sc[j - 1][i];
      const int64_t p0 = q0 - b0 + (int64_t)j * S;  // within the block
      const int64_t first = (p0 / a.s100 + 1) * a.s100 - p0;  // samples left in p0's segment
      double lo = 0.0, hi = 0.0;
#pragma unroll
      for (int i = 0; i < S; ++i) {
        if (i < cnt) {
          const double z = k_step(a.k, v[i], s);
          if (P2) {
            if (i < first)
              lo = fma(z, z, lo);
            else
              hi = fma(z, z, hi);
          }
        }
      }
      if (j == last) {
#pragma unroll
        for (int i = 0; i < 4; ++i) rend[i] = s[i];
      }
      if (P2) {
        lo_s[j] = lo;
        hi_s[j] = hi;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) R[i] = rend[i];
    if (P2) {
      // a warp per segment the round touches adds its threads' parts in order
      const int64_t off = q0 - b0;
      const int k0 = (int)(off / a.s100), k1 = (int)((off + len - 1) / a.s100);
      for (int k = k0 + warp; k <= k1; k += WARPS) {
        const int64_t lp0 = max64((int64_t)k * a.s100, off) - off;
        const int64_t lp1 = min64((int64_t)(k + 1) * a.s100, off + len) - off;
        const int j0 = (int)(lp0 / S), j1 = (int)((lp1 - 1) / S);
        double t = 0.0;
        for (int jj = j0 + lane; jj <= j1; jj += 32)
          t += (off + (int64_t)jj * S) / a.s100 == k ? lo_s[jj] : hi_s[jj];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
        if (lane == 0) acc[k] += t;
      }
    }
  }
  __syncthreads();
  if (P2) {
    const int64_t seg0 = (int64_t)blk * a.G, n_seg = n / a.s100;
    for (int k = j; k < a.G; k += T)
      if (seg0 + k < n_seg) a.seg[(int64_t)r * a.n_seg_max + seg0 + k] = acc[k];
  } else {
    const double s = block_sum(sq, red);
    const float p = block_nan_max(pk, redp);
    if (j == 0) {
      a.part_sq[slot] = s;
      a.part_pk[slot] = p;
#pragma unroll
      for (int i = 0; i < 4; ++i) a.ends[slot * 4 + i] = R[i];
    }
  }
}

__global__ void __launch_bounds__(T) k9_carry(const __grid_constant__ K9Args a) {
  __shared__ double sc[T][4];
  __shared__ double cs[4];
  const int j = threadIdx.x, r = blockIdx.x;
  const int64_t n = valid_n(a.ns, r / a.C, a.L);
  const int64_t nb = (n + a.ch - 1) / a.ch;
  if (nb == 0) return;
  double* st = a.starts + (int64_t)r * a.nb_max * 4;
  const double* en = a.ends + (int64_t)r * a.nb_max * 4;
  if (j < 4) st[j] = 0.0;
  double c[4] = {0.0, 0.0, 0.0, 0.0};
  for (int64_t k0 = 0; k0 < nb - 1; k0 += T) {
    const int64_t k = k0 + j;
    double e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = k < nb - 1 ? en[k * 4 + i] : 0.0;
    if (j == 0) mat_acc(a.bpow[0], c, e);  // the tile's carry enters at its first block
    scan4(e, sc, a.bpow);
    if (k < nb - 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) st[(k + 1) * 4 + i] = e[i];
    }
    if (j == T - 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) cs[i] = e[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = cs[i];
  }
}

// Energy of 400 ms block t of item b: the weighted channel sums of segments
// t .. t + 3 over the block's length.
__device__ __forceinline__ double block_energy(const K9Args& a, int b, int64_t t) {
  double z = 0.0;
  for (int c = 0; c < a.C; ++c) {
    const double* sg = a.seg + ((int64_t)b * a.C + c) * a.n_seg_max + t;
    const double bs = sg[0] + sg[1] + sg[2] + sg[3];
    z += (c >= 3 ? a.surround : 1.0) * bs;
  }
  return z / a.win;
}

// searchsorted(bounds, z, right=True) - 1, clamped to [0, 999]
__device__ __forceinline__ int hist_bin(const double* bounds, double z) {
  int lo = 0, hi = 1001;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (bounds[mid] <= z)
      lo = mid + 1;
    else
      hi = mid;
  }
  return min(max(lo - 1, 0), 999);
}

__global__ void __launch_bounds__(T) k9_tail(const __grid_constant__ K9Args a, const double* bounds,
                                             const double* energies, double* lufs, double* sum_sq,
                                             double* peak) {
  __shared__ double red[WARPS];
  __shared__ float redp[WARPS];
  const int b = blockIdx.x, j = threadIdx.x;
  const int64_t n = valid_n(a.ns, b, a.L);
  const int64_t nb = (n + a.ch - 1) / a.ch;
  double s = 0.0;
  float p = 0.0f;
  for (int c = 0; c < a.C; ++c) {
    const int64_t row = ((int64_t)b * a.C + c) * a.nb_max;
    for (int64_t k = j; k < nb; k += T) {
      s += a.part_sq[row + k];
      p = nan_max(p, a.part_pk[row + k]);
    }
  }
  s = block_sum(s, red);
  p = block_nan_max(p, redp);
  const int64_t n_blocks = n >= a.win ? (n - a.win) / a.s100 + 1 : 0;
  const double floor0 = bounds[0];
  double cnt = 0.0, tot = 0.0;
  for (int64_t t = j; t < n_blocks; t += T) {
    const double z = block_energy(a, b, t);
    if (z >= floor0) {
      cnt += 1.0;
      tot += energies[hist_bin(bounds, z)];
    }
  }
  cnt = block_sum(cnt, red);
  tot = block_sum(tot, red);
  const double gate = tot / fmax(cnt, 1.0) * a.rel_gate;
  double cnt2 = 0.0, tot2 = 0.0;
  for (int64_t t = j; t < n_blocks; t += T) {
    const double z = block_energy(a, b, t);
    if (z >= floor0) {
      const double q = energies[hist_bin(bounds, z)];
      if (q > gate) {
        cnt2 += 1.0;
        tot2 += q;
      }
    }
  }
  cnt2 = block_sum(cnt2, red);
  tot2 = block_sum(tot2, red);
  if (j == 0) {
    lufs[b] = cnt2 > 0.0 ? -0.691 + 10.0 * log10(fmax(tot2 / cnt2, 1e-300)) : -CUDART_INF;
    sum_sq[b] = s;
    peak[b] = (double)p;
  }
}

// ---------------------------------------------------------------------------
// K8

struct K8Args {
  const float* wavs;  // (B, C, L)
  int64_t L, ch;      // row width; output positions a chunk owns
  int C, hold, n_box, hbox, nb, span;  // span: doubles of each shared buffer
  int box[K8_MAX_BOX];
  double thr, slew;
  double* tri;     // (B, nb, 3) each chunk's release map (A, E, C)
  double* starts;  // (B, nb) release value entering each chunk's span
  double* halo;    // (B, nb, hbox) hold values of each span's first hbox positions
  double* out;     // (B, L) the hold values, then the gains
};

struct Tri {
  double A, E, C;  // y -> min(C, A (y - 1) + E)
};

__device__ __forceinline__ Tri tri_identity() { return {1.0, 1.0, CUDART_INF}; }

// later o earlier
__device__ __forceinline__ Tri compose(const Tri& l, const Tri& e) {
  return {l.A * e.A, fma(l.A, e.E - 1.0, l.E),
          fmin(l.C, e.C == CUDART_INF ? CUDART_INF : fma(l.A, e.C - 1.0, l.E))};
}

__device__ __forceinline__ double apply(const Tri& f, double y) { return fmin(f.C, fma(f.A, y - 1.0, f.E)); }

__device__ Tri scan_tri(Tri v, Tri* sc) {
  const int j = threadIdx.x;
  sc[j] = v;
  __syncthreads();
#pragma unroll
  for (int l = 0; l < LOG2_T; ++l) {
    const int d = 1 << l;
    const bool act = j >= d;
    Tri o;
    if (act) o = sc[j - d];
    __syncthreads();
    if (act) {
      v = compose(v, o);
      sc[j] = v;
    }
    __syncthreads();
  }
  return v;
}

// threshold / (v + eps) where the NaN-ignoring channel max v of |x| at t
// exceeds the threshold, else 1; +inf before t = 0 (the hold's pre-history).
__device__ __forceinline__ double raw_gain(const K8Args& a, const float* x, int64_t t) {
  if (t < 0) return CUDART_INF;
  float v = -CUDART_INF_F;
  for (int c = 0; c < a.C; ++c) {
    const float m = fabsf(x[(int64_t)c * a.L + t]);
    if (m > v) v = m;  // false for NaN
  }
  const double d = v;
  return d > a.thr ? a.thr / (d + F64_EPS) : 1.0;
}

// The raw gains of positions [r0, r0 + n) into b0, min-filtered over a.hold by
// doubling windows; returns where the hold of positions r0 + hold - 1 .. lies
// (in b0 or b1).
__device__ double* hold_min(const K8Args& a, const float* x, int64_t r0, int n, double* b0, double* b1) {
  for (int i = threadIdx.x; i < n; i += T) b0[i] = raw_gain(a, x, r0 + i);
  __syncthreads();
  double* src = b0;
  double* dst = b1;
  int w = 1;
  while (2 * w <= a.hold) {  // src[i] = min of the w values ending at i
    for (int i = 2 * w - 1 + threadIdx.x; i < n; i += T) dst[i] = fmin(src[i], src[i - w]);
    __syncthreads();
    double* t = src;
    src = dst;
    dst = t;
    w *= 2;
  }
  if (a.hold > w) {
    const int rest = a.hold - w;
    for (int i = a.hold - 1 + threadIdx.x; i < n; i += T) dst[i] = fmin(src[i], src[i - rest]);
    __syncthreads();
    src = dst;
  }
  return src + (a.hold - 1);
}

// This thread's share [lo, hi) of m positions.
__device__ __forceinline__ void share(int m, int& lo, int& hi) {
  const int q = (m + T - 1) / T;
  lo = min((int)threadIdx.x * q, m);
  hi = min(lo + q, m);
}

// The release steps y -> min(h, y + slew (h - y)) of hold values hv[lo, hi)
// at positions q0 + i, composed; positions before t = 0 are the identity.
__device__ __forceinline__ Tri release_map(const K8Args& a, const double* hv, int64_t q0, int lo, int hi) {
  const double ra = 1.0 - a.slew;
  Tri f = tri_identity();
  for (int i = lo; i < hi; ++i) {
    if (q0 + i < 0) continue;
    const double h = hv[i];
    f = compose({ra, fma(a.slew, h - 1.0, 1.0), h}, f);
  }
  return f;
}

__global__ void __launch_bounds__(T) k8_chunks(const __grid_constant__ K8Args a) {
  extern __shared__ double sm[];
  __shared__ Tri sc[T];
  const int k = blockIdx.x, b = blockIdx.y;
  const float* x = a.wavs + (int64_t)b * a.C * a.L;
  const int64_t p0 = (int64_t)k * a.ch - a.hbox;  // this chunk's span [p0, p1)
  const int64_t p1 = k == a.nb - 1 ? a.L : p0 + a.ch;
  const int64_t r0 = p0 - (a.hold - 1);
  const int m = (int)(p1 - p0);
  double* hv = hold_min(a, x, r0, (int)(p1 - r0), sm, sm + a.span);
  int lo, hi;
  share(m, lo, hi);
  const Tri f = scan_tri(release_map(a, hv, p0, lo, hi), sc);
  if (threadIdx.x == T - 1 && k < a.nb - 1) {  // the last chunk's map is not needed
    double* o = a.tri + ((int64_t)b * a.nb + k) * 3;
    o[0] = f.A;
    o[1] = f.E;
    o[2] = f.C;
  }
  double* halo = a.halo + ((int64_t)b * a.nb + k) * a.hbox;
  double* o = a.out + (int64_t)b * a.L + p0;
  for (int i = threadIdx.x; i < m; i += T) {
    if (p0 + i < 0) continue;
    if (i < a.hbox) halo[i] = hv[i];
    o[i] = hv[i];
  }
}

__global__ void __launch_bounds__(T) k8_carry(const __grid_constant__ K8Args a) {
  __shared__ Tri sc[T];
  __shared__ double cy;
  const int b = blockIdx.x, j = threadIdx.x;
  double* st = a.starts + (int64_t)b * a.nb;
  const double* tr = a.tri + (int64_t)b * a.nb * 3;
  if (j == 0) st[0] = 1.0;  // y_{-1}
  double c = 1.0;
  for (int k0 = 0; k0 < a.nb - 1; k0 += T) {
    const int k = k0 + j;
    Tri f = tri_identity();
    if (k < a.nb - 1) f = {tr[3 * k], tr[3 * k + 1], tr[3 * k + 2]};
    f = scan_tri(f, sc);
    const double y = apply(f, c);
    if (k < a.nb - 1) st[k + 1] = y;
    if (j == T - 1) cy = y;
    __syncthreads();
    c = cy;
  }
}

__global__ void __launch_bounds__(T) k8_gain(const __grid_constant__ K8Args a) {
  extern __shared__ double sm[];
  __shared__ Tri sc[T];
  const int k = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const int64_t t0 = (int64_t)k * a.ch, t1 = min64(t0 + a.ch, a.L);
  const int64_t q0 = t0 - a.hbox;
  const int m = (int)(t1 - q0);
  double* hv = sm;
  double* other = sm + a.ch + a.hbox;
  const double* halo = a.halo + ((int64_t)b * a.nb + k) * a.hbox;
  double* o = a.out + (int64_t)b * a.L + q0;
  for (int i = j; i < m; i += T) hv[i] = q0 + i < 0 ? 1.0 : i < a.hbox ? halo[i] : o[i];
  __syncthreads();
  int lo, hi;
  share(m, lo, hi);
  const Tri f = release_map(a, hv, q0, lo, hi);
  scan_tri(f, sc);
  const double y0 = a.starts[(int64_t)b * a.nb + k];
  double y = j == 0 ? y0 : apply(sc[j - 1], y0);
  for (int i = lo; i < hi; ++i) {
    if (q0 + i < 0) {
      hv[i] = 1.0;  // pre-history of the box stack
    } else {
      const double h = hv[i];
      y = fmin(h, fma(a.slew, h - y, y));
      hv[i] = y;
    }
  }
  __syncthreads();
  double* src = hv;
  double* dst = other;
  int first = 0;  // positions q0 + first .. are valid in src
  for (int s = 0; s < a.n_box; ++s) {
    const int l = a.box[s];
    if (l <= 1) continue;
    first += l - 1;
    int i0, i1;
    share(m - first, i0, i1);
    i0 += first;
    i1 += first;
    if (i0 < i1) {
      double sum = 0.0;
      for (int u = i0 - l + 1; u <= i0; ++u) sum += src[u];
      dst[i0] = sum / l;
      for (int i = i0 + 1; i < i1; ++i) {
        sum += src[i] - src[i - l];
        dst[i] = sum / l;
      }
    }
    __syncthreads();
    double* t = src;
    src = dst;
    dst = t;
  }
  for (int i = a.hbox + j; i < m; i += T) o[i] = fmin(src[i], 1.0);
}

}  // namespace

// K9 over n_items items of n_ch rows of width L (f32, each item's rows valid
// for ns[item] samples): lufs, sum_sq, peak (n_items,) f64.  tables (host):
// 10 coefficients (K9Coef's order), then LOG2_T matrices M^(S 2^i) and
// LOG2_T matrices M^(ch 2^i), ch = G s100, each 16 doubles row-major.
// Workspace: ends, starts (n_items n_ch nb_max 4), part_sq, part_pk
// (n_items n_ch nb_max), seg (n_items n_ch n_seg_max), nb_max = ceil(L / ch),
// n_seg_max = L / s100.  Returns a cudaError_t (0: launched).
extern "C" int thesia_lufs_stats(const float* wavs, const int64_t* ns, int64_t n_items, int64_t n_ch,
                                 int64_t L, int64_t s100, int64_t G, int64_t S, const double* tables,
                                 double surround, double rel_gate, double* ends, double* starts,
                                 double* part_sq, float* part_pk, double* seg, const double* bounds,
                                 const double* energies, double* lufs, double* sum_sq, double* peak,
                                 void* stream) {
  if (n_items < 1 || n_items > 65535 || n_ch < 1 || n_items * n_ch > 65535 || L < 0 || L >= (1LL << 31) ||
      s100 < 1 || s100 > (1 << 26) || G < 1 || G > K9_MAX_G || S < 1 || S > s100 || (S & (S - 1)) || S > 16)
    return (int)cudaErrorInvalidValue;
  K9Args a;
  a.wavs = wavs;
  a.ns = ns;
  a.L = L;
  a.ch = G * s100;
  a.C = (int)n_ch;
  a.s100 = (int)s100;
  a.G = (int)G;
  a.win = (int)(4 * s100);
  const int64_t nb_max = (L + a.ch - 1) / a.ch;
  if (nb_max >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  a.nb_max = (int)nb_max;
  a.n_seg_max = (int)(L / s100);
  a.surround = surround;
  a.rel_gate = rel_gate;
  const double* t = tables;
  a.k = {t[0], t[1], t[2], t[3], t[4], t[5], t[6], t[7], t[8], t[9]};
  for (int l = 0; l < LOG2_T; ++l)
    for (int i = 0; i < 16; ++i) {
      a.tpow[l][i] = t[10 + 16 * l + i];
      a.bpow[l][i] = t[10 + 16 * (LOG2_T + l) + i];
    }
  a.ends = ends;
  a.starts = starts;
  a.part_sq = part_sq;
  a.part_pk = part_pk;
  a.seg = seg;
  const cudaStream_t st = (cudaStream_t)stream;
  const int rows = (int)(n_items * n_ch);
  cudaError_t err;
  if (nb_max > 0) {
    const dim3 grid((unsigned)nb_max, (unsigned)rows);
    switch (S) {
      case 16: k9_pass<16, false><<<grid, T, 0, st>>>(a); break;
      case 8: k9_pass<8, false><<<grid, T, 0, st>>>(a); break;
      case 4: k9_pass<4, false><<<grid, T, 0, st>>>(a); break;
      case 2: k9_pass<2, false><<<grid, T, 0, st>>>(a); break;
      default: k9_pass<1, false><<<grid, T, 0, st>>>(a); break;
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    k9_carry<<<rows, T, 0, st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    switch (S) {
      case 16: k9_pass<16, true><<<grid, T, 0, st>>>(a); break;
      case 8: k9_pass<8, true><<<grid, T, 0, st>>>(a); break;
      case 4: k9_pass<4, true><<<grid, T, 0, st>>>(a); break;
      case 2: k9_pass<2, true><<<grid, T, 0, st>>>(a); break;
      default: k9_pass<1, true><<<grid, T, 0, st>>>(a); break;
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  k9_tail<<<(unsigned)n_items, T, 0, st>>>(a, bounds, energies, lufs, sum_sq, peak);
  return (int)cudaGetLastError();
}

// K8 over n_items rows of n_ch channels of width L (f32): out (n_items, L) f64.
// box (host): n_box moving-average lengths (at most K8_MAX_BOX), hbox the sum
// of (length - 1) over those above 1; ch output positions a chunk; workspace
// tri (n_items nb 3), starts (n_items nb), halo (n_items nb hbox), nb =
// ceil(L / ch); smem_bytes k8_chunks' dynamic shared memory, 2 (ch + hbox +
// hold - 1) doubles (k8_gain takes 2 (ch + hbox)).
extern "C" int thesia_limiter_gain(const float* wavs, int64_t n_items, int64_t n_ch, int64_t L,
                                   double thr, double slew, int64_t hold, const int64_t* box,
                                   int64_t n_box, int64_t ch, double* tri, double* starts,
                                   double* halo, double* out, int64_t smem_bytes, void* stream) {
  if (n_items < 1 || n_items > 65535 || n_ch < 1 || n_ch > 4096 || L < 1 || L >= (1LL << 31) ||
      hold < 1 || hold > (1 << 24) || n_box < 0 || n_box > K8_MAX_BOX || ch < 1 || ch > (1 << 24))
    return (int)cudaErrorInvalidValue;
  K8Args a;
  a.wavs = wavs;
  a.L = L;
  a.ch = ch;
  a.C = (int)n_ch;
  a.hold = (int)hold;
  a.n_box = (int)n_box;
  int64_t hbox = 0;
  for (int s = 0; s < K8_MAX_BOX; ++s) {
    a.box[s] = s < n_box ? (int)box[s] : 1;
    if (s < n_box && (box[s] < 1 || box[s] > (1 << 24))) return (int)cudaErrorInvalidValue;
    if (a.box[s] > 1) hbox += a.box[s] - 1;
  }
  a.hbox = (int)hbox;
  const int64_t span = ch + hbox + hold - 1;
  if (smem_bytes < 2 * span * 8 || smem_bytes > 227 * 1024 - (int64_t)sizeof(Tri) * T - 64)
    return (int)cudaErrorInvalidValue;
  const int64_t nb = (L + ch - 1) / ch;
  if (nb >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  a.nb = (int)nb;
  a.span = (int)span;
  a.thr = thr;
  a.slew = slew;
  a.tri = tri;
  a.starts = starts;
  a.halo = halo;
  a.out = out;
  const cudaStream_t st = (cudaStream_t)stream;
  const int gain_smem = (int)(16 * (ch + hbox));
  cudaError_t err;
  if ((err = cudaFuncSetAttribute((const void*)k8_chunks, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_bytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute((const void*)k8_gain, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  gain_smem)) != cudaSuccess)
    return (int)err;
  const dim3 grid((unsigned)nb, (unsigned)n_items);
  k8_chunks<<<grid, T, (size_t)smem_bytes, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  k8_carry<<<(unsigned)n_items, T, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  k8_gain<<<grid, T, (size_t)gain_smem, st>>>(a);
  return (int)cudaGetLastError();
}
