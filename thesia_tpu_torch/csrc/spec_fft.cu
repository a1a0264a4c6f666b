// Fused spectrogram for Hopper: raw rows -> reflect-padded, gained, windowed
// frames -> real FFT -> |.| -> (mel) -> dB, and each row's dB bounds.
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   * mel variant (K1):    tests/pallas_spec.py:131, spec_db_pallas / _kernel
//   * linear variant (K2): tests/pallas_spec.py:98,  spec_db_pallas_linear / _kernel_linear
// and computes what the production XLA program computes in
// thesia_tpu/dsp/spectrogram.py (_spec_full, _spec_full_multi,
// _spec_multi_impl), the reflect padding (K3) and the masked row bounds
// included: frame t of row c starts at sample (t0 + t) * hop - pad of the raw
// row, whose n_c samples are extended by the cyclic reflection of
// dsp/stft.py reflect_indices_torch (period 2 (n_c - 1), index 0 when n_c =
// 1); each sample is scaled by the row's gain (the normalize gain, applied as
// (x * g) * w, the JAX order; a null gains pointer means g = 1, and x * 1 is
// x bitwise); the output is dB(|DFT_n_fft(frame * window)|) over bins
// 0..n_fft/2, for the mel variant then multiplied by the filterbank (F, M);
// (C, n_frames, F|M) f32 with exactly -inf where the amplitude is 0.  On
// request the kernel also lowers row_min[c] / raises row_max[c] to the min
// and max of row c's dB over its valid frames (t0 + t < the frame count of
// n_c) and the launch's columns.  pad = 0 with n_c = the row width is the
// contract on rows padded beforehand.
//
// What bounds it on the H100: the bytes.  A 5-min 48 kHz stereo track moves
// 115 MB of raw samples in and 83 MB (mel) or 246 MB (linear) of dB out --
// 0.059 / 0.108 ms at 3.35 TB/s -- against 3.8 / 3.6 GFLOP of FFT, split,
// mel and dB, 0.057 / 0.054 ms at 67 TFLOP/s in f32 (kernels/spec_db.py:
// kernel_work).  f32 throughout, no tensor cores (TF32 keeps three digits).
// The parent design (one CTA of 128 threads per 2 frames, a block-wide
// barrier per FFT stage, synchronous loads, twiddles from global memory,
// spills under a launch bound sized for 256 threads) ran at 9% of its FP32
// issue rate and 12x its bound: latency, not bandwidth or arithmetic, held it
// back, plus a reflect-padded copy and two reductions around it.
//
// Design, n_fft 64..2048 (h = n_fft / 2 = 32 L complex points, L = 1..32;
// the main path's 1024 and 2048): a frame's h points live in the registers
// of L lanes, 32 a lane, so a warp holds G = 32 / L frames.
//   1. Loads: lane b of a frame holds z[L a + b] = x[2n] + i x[2n+1], n = L a
//      + b, a < 32 -- 32 independent 8-byte loads a lane, issued together
//      without a branch, coalesced across the lanes, then windowed (the
//      window pair one 8-byte shared read).  That is every frame of a row
//      but its first and last few: a frame that reaches past either end, or
//      starts off 8-byte alignment, reads scalars, through the reflect map
//      where it leaves the row.
//   2. 32-point DIF in registers (radix-4 levels, then radix-2; bit-reversed
//      out), then the twiddle W_h^{b k1}.
//   3. One exchange through the warp's shared buffer under __syncwarp:
//      X[k1][b] in rows of L + 1, each group's region starting L banks on,
//      so the write (fixed k1, b across lanes) and the transposed read
//      (fixed b, k1 = j + L i across lanes) hit distinct banks in every
//      half-warp, and every offset is affine in the lane: the compiler keeps
//      a base register, not the 32 offsets that an XOR swizzle needed
//      (they were live across the loop and spilled).  A numpy model of the
//      schedule checks the banks and the arithmetic
//      (tests/test_torch_kernels.py).
//   4. 32 / L DIFs of L points along b in registers: lane j now holds
//      Z[j + L i + 32 k2].  No block-wide barrier anywhere in the FFT.
//   5. Epilogue: Z back to the warp's buffer, the real split one bin pair
//      (k, h - k) at a time, k = j + L q, shared reads gathered in chunks
//      ahead of the arithmetic and stores.  The linear variant stores dB
//      coalesced along F.  The mel variant parks |X| in the same buffer
//      (sqrt.approx) and walks the filterbank flattened per lane on the
//      host (kernels/spec_db.py: mel_schedule): each lane's columns, widest
//      first to the least loaded lane, as (bin, weight) entries in one loop
//      of uniform length, read from shared memory; each column's sum lands
//      past the magnitudes, then dB is stored coalesced along M.  The
//      magnitude never reaches device memory -- the property the Pallas
//      kernel kept in VMEM.  The bounds reduce per lane, then per warp
//      (shuffles), then one atomic min and max per warp per row on the
//      float's order-preserving integer image (exact: the dB is never NaN,
//      since x > 0 sends NaN to -inf).
// The CTAs are persistent: 4 warps each, 3 to an SM (the registers are sized
// for it, at most 168 a thread, 0 bytes of spills at the main path's sizes),
// as many as spread the frame groups evenly over the rounds the resident
// warps need, each warp walking frame groups in a grid stride.  Twiddles (a
// float64-built table rounded once to f32: W_32^e, W_h^{b k1} in [k1][b]
// order, W_n_fft^k of the split), the window and the mel variant's flattened
// filterbank are loaded into shared memory once per CTA.  A frame's
// arithmetic does not depend on the CTA, warp or group slot that computes
// it, so a shard of the device mesh ("time" rows views, "freq" column
// ranges) is bitwise the whole launch's.  What is left (PERF.md, section 6): the
// epilogues take about half the time, the loads a fifth, the FFT the rest.
//
// Other sizes (n_fft 1..32 and 4096..32768, and a mel launch whose columns
// or filterbank do not fit the register schedule's buffers): a
// shared-memory schedule, one CTA of 128 threads per G frames of one row (G h = 2048 complex values for
// n_fft <= 4096, one frame above), an in-place radix-2/4/16 DIF FFT with a
// barrier per stage, XOR-swizzled, twiddles in stage order from global
// memory; the same loader and epilogues.  n_fft 32768 needs 128 KB of shared
// memory for the FFT and 64 KB for the mel magnitudes.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int MAX_LOG2_NFFT = 15;
// the register schedule covers n_fft = 2^6 .. 2^11
constexpr int REG_LOG2_NFFT_MIN = 6, REG_LOG2_NFFT_MAX = 11;
constexpr int REG_WARPS = 4;        // warps per CTA
constexpr int REG_MIN_BLOCKS = 3;   // CTAs per SM the registers are sized for: 168 a thread
// the shared-memory schedule
constexpr int SMEM_THREADS = 128;
constexpr int SMEM_MIN_BLOCKS = 4;  // 128 registers a thread

struct Args {
  const float* rows;
  int64_t row_stride;
  const int* row_n;  // (n_rows,) samples of each row, or null: n_default each
  int n_default, pad, t0;
  int hop, win, n_frames, n_rows;
  const float* window;
  const float* gains;  // (n_rows,) or null
  int n_fft, log2h;  // n_fft = 1 << (log2h + 1), or 1 with log2h = 0
  const float2* tw;  // twiddles, see twiddle_exponents in kernels/spec_db.py
  const int* mel_lo;  // shared-memory schedule: the packed filterbank
  const int* mel_off;
  const float* mel_w;
  const int2* sched;  // register schedule: the flattened filterbank, (n_sched, L)
  int n_sched;
  int col0, n_cols;  // output columns [col0, col0 + n_cols), out row width n_cols
  int pair0, n_range_pairs;  // linear: the bin pairs (k, h-k) that touch them
  int frames_per_cta;  // shared-memory schedule
  float* out;
  float* row_min;  // (n_rows,) or null: no bounds
  float* row_max;
};

// 20 log10(x) of an amplitude, 10 log10(p) of a power, exactly -inf at 0
// (lg2.approx: relative error about 2^-22, subnormal inputs supported)
constexpr float DB_PER_LOG2_AMPLITUDE = 6.020599913279624f;  // 20 log10(2)
__device__ __forceinline__ float amplitude_db(float x) {
  return x > 0.f ? DB_PER_LOG2_AMPLITUDE * __log2f(x) : -CUDART_INF_F;
}
__device__ __forceinline__ float power_db(float p) {
  return p > 0.f ? 0.5f * DB_PER_LOG2_AMPLITUDE * __log2f(p) : -CUDART_INF_F;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// sqrt.approx.f32 (without .ftz: subnormals kept): one instruction where
// sqrtf's correct rounding takes a sequence; the magnitudes stay inside the
// contract against the float64 plain version (chip_smoke.py [kernels.*])
__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__host__ __device__ constexpr int rev_bits(int k, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r |= ((k >> i) & 1) << (bits - 1 - i);
  return r;
}

// -- the loader (K3): the cyclic reflect map of dsp/stft.py
__device__ __forceinline__ int reflect_index(int p, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  int j = p % period;
  if (j < 0) j += period;
  return j >= n ? period - j : j;
}

__device__ __forceinline__ int frames_of(int n, const Args& a) {
  const int len = n + 2 * a.pad;
  return len < a.win ? 0 : (len - a.win) / a.hop + 1;
}

struct Frame {
  const float* row;
  int n, p0;  // the row's samples; the frame's first sample (may be < 0)
  float gain;
  bool inside, aligned;
};

__device__ __forceinline__ Frame frame_at(const Args& a, int c, int t_abs, int n, float gain) {
  Frame f;
  f.row = a.rows + (int64_t)c * a.row_stride;
  f.n = n;
  f.p0 = t_abs * a.hop - a.pad;
  f.gain = gain;
  f.inside = f.p0 >= 0 && f.p0 + a.win <= n;
  f.aligned = f.inside && ((uintptr_t)(f.row + f.p0) & 7) == 0;
  return f;
}

// (x[s] g w0, x[s+1] g w1) of the frame, s < win; zero imaginary part when
// s + 1 = win.  The same arithmetic on every path, so a frame's values do
// not depend on whether it was read as float2, as scalars or reflected.
__device__ __forceinline__ float2 load_pair(const Frame& f, int s, int win, float w0, float w1) {
  const bool both = s + 1 < win;
  float x0, x1 = 0.f;
  if (f.aligned && both) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(f.row + f.p0 + s));
    x0 = x.x;
    x1 = x.y;
  } else if (f.inside) {
    x0 = __ldg(f.row + f.p0 + s);
    if (both) x1 = __ldg(f.row + f.p0 + s + 1);
  } else {
    x0 = __ldg(f.row + reflect_index(f.p0 + s, f.n));
    if (both) x1 = __ldg(f.row + reflect_index(f.p0 + s + 1, f.n));
  }
  return make_float2((x0 * f.gain) * w0, both ? (x1 * f.gain) * w1 : 0.f);
}

// -- the split: powers |X[k]|^2 and |X[h-k]|^2 of the real input from its
// h-point FFT Z, for 0 < k < h: with E = (Z[k] + conj Z[h-k]) / 2 and O =
// (Z[k] - conj Z[h-k]) / 2i, X[k] = E + W^k O and X[h-k] = conj(E - W^k O).
// At k = 0, X[0] = Re Z0 + Im Z0 and X[h] = Re Z0 - Im Z0.
__device__ __forceinline__ float2 split_power(float2 a, float2 b, float2 w) {
  const float2 e = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
  const float2 o = make_float2(0.5f * (a.y + b.y), 0.5f * (b.x - a.x));
  const float2 wo = cmul(o, w);
  const float pr = e.x + wo.x, pi = e.y + wo.y, mr = e.x - wo.x, mi = e.y - wo.y;
  return make_float2(pr * pr + pi * pi, mr * mr + mi * mi);
}

__device__ __forceinline__ float2 dc_power(float2 z0) {
  const float x0 = z0.x + z0.y, xh = z0.x - z0.y;
  return make_float2(x0 * x0, xh * xh);
}

// -- the bounds: per lane, then per warp, then one atomic per warp and row
__device__ __forceinline__ void atomic_min_float(float* p, float v) {
  if (!signbit(v))
    atomicMin(reinterpret_cast<int*>(p), __float_as_int(v));
  else
    atomicMax(reinterpret_cast<unsigned*>(p), __float_as_uint(v));
}

__device__ __forceinline__ void atomic_max_float(float* p, float v) {
  if (!signbit(v))
    atomicMax(reinterpret_cast<int*>(p), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(p), __float_as_uint(v));
}

struct Bounds {
  float mn, mx;
  __device__ __forceinline__ void reset() {
    mn = CUDART_INF_F;
    mx = -CUDART_INF_F;
  }
  __device__ __forceinline__ void add(float d) {
    mn = fminf(mn, d);
    mx = fmaxf(mx, d);
  }
  // every lane of the warp calls it; row < 0: nothing to flush
  __device__ __forceinline__ void flush(const Args& a, int row) {
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    if ((threadIdx.x & 31) == 0 && row >= 0 && a.row_min != nullptr) {
      if (mn != CUDART_INF_F) atomic_min_float(a.row_min + row, mn);
      if (mx != -CUDART_INF_F) atomic_max_float(a.row_max + row, mx);
    }
    reset();
  }
};

// ---------------------------------------------------------------------------
// The register schedule

// d W_32^E for a compile-time exponent E < 32: exact at E = 0, 8, 16, 24,
// else the table's once-rounded W_32^E
template <int E>
__device__ __forceinline__ float2 mul_w32(float2 d, const float2* w32) {
  if constexpr (E == 0) return d;
  else if constexpr (E == 8) return make_float2(d.y, -d.x);
  else if constexpr (E == 16) return make_float2(-d.x, -d.y);
  else if constexpr (E == 24) return make_float2(-d.y, d.x);
  else return cmul(d, w32[E]);
}

// one radix-4 DIF butterfly of span S (two radix-2 levels, S and S/2): the
// values at q, q + S/4, q + S/2, q + 3S/4 become (y0, y2 W_S^2q, y1 W_S^q,
// y3 W_S^3q), so the output order stays bit-reversed
template <int S, int Q>
__device__ __forceinline__ void radix4_at(float2& v0, float2& v1, float2& v2, float2& v3,
                                          const float2* w32) {
  const float2 s02 = make_float2(v0.x + v2.x, v0.y + v2.y);
  const float2 d02 = make_float2(v0.x - v2.x, v0.y - v2.y);
  const float2 s13 = make_float2(v1.x + v3.x, v1.y + v3.y);
  const float2 d13 = make_float2(v1.x - v3.x, v1.y - v3.y);
  constexpr int E = Q * (32 / S);  // W_S^q = W_32^E
  v0 = make_float2(s02.x + s13.x, s02.y + s13.y);
  v1 = mul_w32<2 * E>(make_float2(s02.x - s13.x, s02.y - s13.y), w32);
  v2 = mul_w32<E>(make_float2(d02.x + d13.y, d02.y - d13.x), w32);
  v3 = mul_w32<3 * E>(make_float2(d02.x - d13.y, d02.y + d13.x), w32);
}

template <int N, int S, int Q>
__device__ __forceinline__ void radix4_level(float2* v, const float2* w32) {
  if constexpr (Q < S / 4) {
#pragma unroll
    for (int base = 0; base < N; base += S)
      radix4_at<S, Q>(v[base + Q], v[base + Q + S / 4], v[base + Q + S / 2], v[base + Q + 3 * S / 4],
                      w32);
    radix4_level<N, S, Q + 1>(v, w32);
  }
}

// v[0..N) in place: DIF in radix-4 levels (a radix-2 level last when log2 N
// is odd), natural order in, bit-reversed out (v[rev(k)] = V[k]); W_S^q =
// W_32^(q 32 / S) from the table w32.  One level per instantiation, so every
// loop has a constant trip count and v stays in registers.
template <int N, int S>
__device__ __forceinline__ void dif_levels(float2* v, const float2* w32) {
  if constexpr (S >= 4) {
    radix4_level<N, S, 0>(v, w32);
    dif_levels<N, S / 4>(v, w32);
  } else if constexpr (S == 2) {
#pragma unroll
    for (int base = 0; base < N; base += 2) {
      const float2 x0 = v[base], x1 = v[base + 1];
      v[base] = make_float2(x0.x + x1.x, x0.y + x1.y);
      v[base + 1] = make_float2(x0.x - x1.x, x0.y - x1.y);
    }
  }
}

template <int LOG2N>
__device__ __forceinline__ void dif(float2* v, const float2* w32) {
  dif_levels<1 << LOG2N, 1 << LOG2N>(v, w32);
}

template <int LOG2L>
struct Layout {
  static constexpr int L = 1 << LOG2L, G = 32 / L, H = 32 * L;
  // a group's region of the warp's buffer: complex values, S = L (mod 16),
  // so the groups of a half-warp start on different banks
  static constexpr int S = 32 * L + 32 + (L & 15);
  static constexpr int WARP_BUF = G * S;
  // X[k1][b]: rows of L + 1 (a lane's row and a lane's column both hit
  // distinct banks); every offset is affine in the lane, so the compiler
  // keeps one base register, not one per value
  __device__ static __forceinline__ int x_at(int g, int k1, int b) { return g * S + k1 * (L + 1) + b; }
  // Z[k] (complex values)
  __device__ static __forceinline__ int z_at(int g, int k) { return g * S + k; }
  // |X[k]| (floats), from a start = g L (mod 32) in the group's region
  __device__ static __forceinline__ int m_at(int g, int k) {
    return 2 * g * S + ((g * L - 2 * g * S) & 31) + k;
  }
  // twiddles: W_32^e (32), W_h^{b k1} at 32 + k1 L + b (h), W_n_fft^k at 32 + h + k (h/2 + 1)
  static constexpr int N_TW = 32 + H + H / 2 + 1;
};

template <int LOG2L, bool MEL>
__global__ void __launch_bounds__(REG_WARPS * 32, REG_MIN_BLOCKS) spec_fft_kernel_regs(const Args a) {
  using R = Layout<LOG2L>;
  constexpr int L = R::L, G = R::G, H = R::H;
  extern __shared__ float4 smem4[];
  float2* bufs = reinterpret_cast<float2*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float2* xb = bufs + warp * R::WARP_BUF;
  float2* tws = bufs + REG_WARPS * R::WARP_BUF;
  float* wins = reinterpret_cast<float*>(tws + R::N_TW);
  int2* sched = reinterpret_cast<int2*>(wins + 4 * (a.win / 4 + 1));
  for (int i = threadIdx.x; i < R::N_TW; i += blockDim.x) tws[i] = __ldg(a.tw + i);
  for (int i = threadIdx.x; i < a.win + 1; i += blockDim.x) wins[i] = i < a.win ? __ldg(a.window + i) : 0.f;
  if (MEL)
    for (int i = threadIdx.x; i < a.n_sched * L; i += blockDim.x) sched[i] = __ldg(a.sched + i);
  __syncthreads();
  const float2* w32 = tws;
  const float2* st = tws + 32;
  const float2* sp = tws + 32 + H;
  const int g = lane >> LOG2L, j = lane & (L - 1);
  const int n_groups = (a.n_frames + G - 1) / G;
  const int64_t items = (int64_t)a.n_rows * n_groups;
  const int col1 = a.col0 + a.n_cols;
  int row = -1, n = 0, nf = 0;
  float gain = 1.f;
  Bounds bounds;
  bounds.reset();
  for (int64_t item = (int64_t)blockIdx.x * REG_WARPS + warp; item < items;
       item += (int64_t)gridDim.x * REG_WARPS) {
    const int c = (int)(item / n_groups);
    const int t = (int)(item - (int64_t)c * n_groups) * G + g;
    if (c != row) {  // uniform across the warp
      bounds.flush(a, row);
      row = c;
      n = a.row_n != nullptr ? __ldg(a.row_n + c) : a.n_default;
      nf = frames_of(n, a);
      gain = a.gains != nullptr ? __ldg(a.gains + c) : 1.f;
    }
    const bool valid = t < a.n_frames;
    const bool counted = valid && a.t0 + t < nf;

    // 1. lane j: z[L q + j], q < 32.  An interior, 8-byte aligned frame
    // of an even window (every frame but a row's first and last few on the
    // main path) issues its 32 loads at once, without a branch; the others
    // go through load_pair.  Both compute (x * g) * w.
    float2 v[32];
    {
      const Frame f = frame_at(a, c, a.t0 + t, n, gain);
      const float2* w2 = reinterpret_cast<const float2*>(wins);
      if (valid && f.aligned && !(a.win & 1)) {
        const float2* src = reinterpret_cast<const float2*>(f.row + f.p0);
#pragma unroll
        for (int q = 0; q < 32; ++q) {
          const int i = L * q + j;
          v[q] = __ldg(src + (2 * i < a.win ? i : 0));
        }
#pragma unroll
        for (int q = 0; q < 32; ++q) {
          const int i = L * q + j;
          const bool in = 2 * i < a.win;
          const float2 w = w2[in ? i : 0];
          v[q] = in ? make_float2((v[q].x * gain) * w.x, (v[q].y * gain) * w.y) : make_float2(0.f, 0.f);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 32; ++q) {
          const int s = 2 * (L * q + j);
          v[q] = make_float2(0.f, 0.f);
          if (valid && s < a.win) {  // the window pair in one 8-byte read (zero past win)
            const float2 w = w2[s >> 1];
            v[q] = load_pair(f, s, a.win, w.x, w.y);
          }
        }
      }
    }
    // 2. 32 points along q, then W_h^{j k1}; register r holds k1 = rev(r)
    dif<5>(v, w32);
#pragma unroll
    for (int r = 1; r < 32; ++r) v[r] = cmul(v[r], st[rev_bits(r, 5) * L + j]);
    // 3. exchange: lane j takes X[j + L i][b], i < G, b < L
#pragma unroll
    for (int r = 0; r < 32; ++r) xb[R::x_at(g, rev_bits(r, 5), j)] = v[r];
    __syncwarp();
#pragma unroll
    for (int i = 0; i < G; ++i) {
#pragma unroll
      for (int b = 0; b < L; ++b) v[i * L + b] = xb[R::x_at(g, j + L * i, b)];
    }
    __syncwarp();
    // 4. L points along b; register i L + r holds Z[j + L i + 32 rev(r)]
#pragma unroll
    for (int i = 0; i < G; ++i) dif<LOG2L>(v + i * L, w32);
#pragma unroll
    for (int i = 0; i < G; ++i) {
#pragma unroll
      for (int r = 0; r < L; ++r) xb[R::z_at(g, j + L * i + 32 * rev_bits(r, LOG2L))] = v[i * L + r];
    }
    __syncwarp();

    // 5. epilogue: the bin pairs k = pair0 + j + L q, at most h/2 + 1 =
    // 16 L + 1 a frame.  Shared reads are gathered ahead of the stores in
    // chunks (a store through a generic pointer may alias shared memory, so
    // the compiler keeps reads after it): first a chunk's reads, then its
    // arithmetic and stores.  A pair past the range reads pair 0.
    float* orow = a.out + ((int64_t)c * a.n_frames + t) * a.n_cols;
    if (!MEL) {
#pragma unroll
      for (int q0 = 0; q0 < 17; q0 += 6) {
        float2 z0[6], z1[6], w[6];
#pragma unroll
        for (int u = 0; u < 6 && q0 + u < 17; ++u) {
          const int p = j + L * (q0 + u);
          const int k = a.pair0 + (p < a.n_range_pairs ? p : 0);
          z0[u] = xb[R::z_at(g, k)];
          z1[u] = xb[R::z_at(g, k == 0 ? 0 : H - k)];
          w[u] = sp[k];
        }
#pragma unroll
        for (int u = 0; u < 6 && q0 + u < 17; ++u) {
          const int p = j + L * (q0 + u);
          const bool in = p < a.n_range_pairs;
          const int k = a.pair0 + (in ? p : 0);
          const float2 pw = k == 0 ? dc_power(z0[u]) : split_power(z0[u], z1[u], w[u]);
          if (in && valid && k >= a.col0 && k < col1) {
            const float d = power_db(pw.x);
            orow[k - a.col0] = d;
            if (counted) bounds.add(d);
          }
          if (in && valid && H - k != k && H - k >= a.col0 && H - k < col1) {
            const float d = power_db(pw.y);
            orow[H - k - a.col0] = d;
            if (counted) bounds.add(d);
          }
        }
      }
    } else {
      float2 pw[17];  // pairs k = j + L q <= h/2 = 16 L
#pragma unroll
      for (int q = 0; q < 17; ++q) {
        const int k = min(j + L * q, H / 2);
        const float2 z0 = xb[R::z_at(g, k)], z1 = xb[R::z_at(g, k == 0 ? 0 : H - k)];
        pw[q] = k == 0 ? dc_power(z0) : split_power(z0, z1, sp[k]);
      }
      __syncwarp();
      float* mag = reinterpret_cast<float*>(xb);
#pragma unroll
      for (int q = 0; q < 17; ++q) {
        const int k = j + L * q;
        if (k <= H / 2) {
          mag[R::m_at(g, k)] = sqrt_approx(pw[q].x);
          if (H - k != k) mag[R::m_at(g, H - k)] = sqrt_approx(pw[q].y);
        }
      }
      __syncwarp();
      float* sums = mag + R::m_at(g, H + 1);  // the column sums past |X[h]|
      float acc = 0.f;
      for (int e0 = 0; e0 < a.n_sched; e0 += 8) {  // n_sched: a multiple of 8
        int2 ent[8];
        float mg[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) ent[u] = sched[(e0 + u) * L + j];
#pragma unroll
        for (int u = 0; u < 8; ++u) mg[u] = mag[R::m_at(g, ent[u].x & 0xfff)];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          acc = fmaf(mg[u], __int_as_float(ent[u].y), acc);
          if (ent[u].x >> 12) {
            sums[(ent[u].x >> 12) - 1] = acc;
            acc = 0.f;
          }
        }
      }
      __syncwarp();
      for (int p0 = j; p0 < a.n_cols; p0 += 4 * L) {  // dB, coalesced along M
        float sm[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) sm[u] = sums[min(p0 + u * L, a.n_cols - 1)];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float d = amplitude_db(sm[u]);
          if (valid && p0 + u * L < a.n_cols) {
            orow[p0 + u * L] = d;
            if (counted) bounds.add(d);
          }
        }
      }
    }
    __syncwarp();
  }
  bounds.flush(a, row);
}

// ---------------------------------------------------------------------------
// The shared-memory schedule (n_fft 1..32 and 4096..32768)

// bank swizzle: a bijection inside each 16-element block (it XORs the low
// four bits with a function of the higher ones); sh = max(log2h - 4, 4)
__device__ __forceinline__ int swz(int p, int sh) {
  return p ^ ((((p >> 4) & 3) * 5) ^ ((p >> sh) & 15));
}

__device__ __forceinline__ int bitrev(int k, int bits) {
  return bits == 0 ? 0 : (int)(__brev((unsigned)k) >> (32 - bits));
}

__device__ __forceinline__ float2 twiddle(const float2* __restrict__ tw, int m) {
  return __ldg(tw + m);
}

// The twiddle table of this schedule holds, as (cos, -sin)(2 pi m / n_fft):
// W^k for the real split (k < h), then W_h^b for the radix-2 stage (b <
// h/2), then for every span S = 4, 8, .., h three planes of S/4 entries,
// W_S^j, W_S^2j, W_S^3j; so a stage's threads read consecutive entries.  The
// planes of span S start here:
__device__ __forceinline__ const float2* span_planes(const float2* tw, int h, int span) {
  return tw + h + (h >> 1) + 3 * (span >> 2) - 3;
}

// one radix-4 DIF butterfly in place: (v0, v1, v2, v3) at (p, p+q, p+2q,
// p+3q) become (y0, y2 W^2j, y1 W^j, y3 W^3j) -- two radix-2 stages, so the
// output order stays bit-reversed
__device__ __forceinline__ void radix4(float2& v0, float2& v1, float2& v2, float2& v3,
                                       float2 w1, float2 w2, float2 w3) {
  const float2 s02 = make_float2(v0.x + v2.x, v0.y + v2.y);
  const float2 d02 = make_float2(v0.x - v2.x, v0.y - v2.y);
  const float2 s13 = make_float2(v1.x + v3.x, v1.y + v3.y);
  const float2 d13 = make_float2(v1.x - v3.x, v1.y - v3.y);
  v0 = make_float2(s02.x + s13.x, s02.y + s13.y);
  v1 = cmul(make_float2(s02.x - s13.x, s02.y - s13.y), w2);
  v2 = cmul(make_float2(d02.x + d13.y, d02.y - d13.x), w1);
  v3 = cmul(make_float2(d02.x - d13.y, d02.y + d13.x), w3);
}

__device__ __forceinline__ float2 pair_power(const float2* zf, int k, int h, int log2h, int sh,
                                             const float2* __restrict__ tw) {
  if (k == 0) return dc_power(zf[0]);  // swz(0) == 0
  return split_power(zf[swz(bitrev(k, log2h), sh)], zf[swz(bitrev(h - k, log2h), sh)],
                     twiddle(tw, k));
}

// next (g, k) of a walk over n_valid rows of n entries in steps of nt
__device__ __forceinline__ void advance(int& g, int& k, int n, int n_valid) {
  while (k >= n && g < n_valid) {
    k -= n;
    ++g;
  }
}

template <bool MEL>
__global__ void __launch_bounds__(SMEM_THREADS, SMEM_MIN_BLOCKS) spec_fft_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float2* z = reinterpret_cast<float2*>(smem4);
  const int L = a.log2h, h = 1 << L, sh = max(L - 4, 4);
  const int G = a.frames_per_cta;
  const int c = blockIdx.y;
  const int t0 = blockIdx.x * G;
  const int n_valid = min(G, a.n_frames - t0);
  const int tid = threadIdx.x, nt = blockDim.x;
  const float2* __restrict__ tw = a.tw;
  const int n = a.row_n != nullptr ? __ldg(a.row_n + c) : a.n_default;
  const int nf = frames_of(n, a);
  const float gain = a.gains != nullptr ? __ldg(a.gains + c) : 1.f;

  // 1. gained, windowed frames -> z[g][n] = x[2n] + i x[2n+1], zero past win
  for (int q = tid; q < h; q += nt) {
    const int s = 2 * q, p = swz(q, sh);
    const float w0 = s < a.win ? __ldg(a.window + s) : 0.f;
    const float w1 = s + 1 < a.win ? __ldg(a.window + s + 1) : 0.f;
    for (int g = 0; g < G; ++g) {
      float2 x = make_float2(0.f, 0.f);
      if (g < n_valid && s < a.win) x = load_pair(frame_at(a, c, a.t0 + t0 + g, n, gain), s, a.win, w0, w1);
      z[(g << L) + p] = x;
    }
  }
  __syncthreads();

  // 2. in-place DIF FFT of h points per frame: a radix-2 stage when log2h is
  // odd, a radix-4 stage when the levels left are 2 mod 4, then radix-16
  // stages (two radix-4 stages in registers between two barriers)
  int span = h;
  if (L & 1) {  // pairs (b, b + h/2) over the whole span
    for (int i = tid; i < (G << (L - 1)); i += nt) {
      const int g = i >> (L - 1), b = i & ((h >> 1) - 1);
      float2* zf = z + (g << L);
      const int i0 = swz(b, sh), i1 = swz(b + (h >> 1), sh);
      const float2 x0 = zf[i0], x1 = zf[i1];
      zf[i0] = make_float2(x0.x + x1.x, x0.y + x1.y);
      zf[i1] = cmul(make_float2(x0.x - x1.x, x0.y - x1.y), twiddle(tw, h + b));
    }
    span >>= 1;
    __syncthreads();
  }
  if (((L >> 1) & 1)) {  // (p, p+q, p+2q, p+3q), q = span / 4
    const int lq = __ffs(span) - 3;
    const int q = 1 << lq;
    const float2* pl = span_planes(tw, h, span);
    for (int i = tid; i < (G << (L - 2)); i += nt) {
      const int g = i >> (L - 2), b = i & ((h >> 2) - 1);
      const int j = b & (q - 1), p = ((b >> lq) << (lq + 2)) + j;
      float2* zf = z + (g << L);
      const int i0 = swz(p, sh), i1 = swz(p + q, sh);
      const int i2 = swz(p + 2 * q, sh), i3 = swz(p + 3 * q, sh);
      float2 v0 = zf[i0], v1 = zf[i1], v2 = zf[i2], v3 = zf[i3];
      radix4(v0, v1, v2, v3, twiddle(pl, j), twiddle(pl, q + j), twiddle(pl, 2 * q + j));
      zf[i0] = v0;
      zf[i1] = v1;
      zf[i2] = v2;
      zf[i3] = v3;
    }
    span >>= 2;
    __syncthreads();
  }
  for (; span >= 16; span >>= 4) {  // base + t r, t < 16, r = span / 16
    const int lr = __ffs(span) - 5;
    const int r = 1 << lr;
    const float2* pl1 = span_planes(tw, h, span);       // planes of 4r entries
    const float2* pl2 = span_planes(tw, h, span >> 2);  // planes of r entries
    for (int i = tid; i < (G << (L - 4)); i += nt) {
      const int g = i >> (L - 4), b = i & ((h >> 4) - 1);
      const int j0 = b & (r - 1), base = ((b >> lr) << (lr + 4)) + j0;
      float2* zf = z + (g << L);
      float2 v[16];
#pragma unroll
      for (int t = 0; t < 16; ++t) v[t] = zf[swz(base + t * r, sh)];
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // span: butterflies (q, q+4, q+8, q+12)
        const int j = j0 + q * r;
        radix4(v[q], v[q + 4], v[q + 8], v[q + 12], twiddle(pl1, j), twiddle(pl1, 4 * r + j),
               twiddle(pl1, 8 * r + j));
      }
      // span / 4: butterflies (4m .. 4m+3)
      const float2 w1 = twiddle(pl2, j0), w2 = twiddle(pl2, r + j0), w3 = twiddle(pl2, 2 * r + j0);
#pragma unroll
      for (int m = 0; m < 4; ++m) radix4(v[4 * m], v[4 * m + 1], v[4 * m + 2], v[4 * m + 3], w1, w2, w3);
#pragma unroll
      for (int t = 0; t < 16; ++t) zf[swz(base + t * r, sh)] = v[t];
    }
    __syncthreads();
  }

  // 3. epilogue, one thread per bin pair (k, h-k), k <= h/2: dB of |X|
  // (linear) or |X| -> shared -> mel band sums -> dB; bin h exists for
  // n_fft >= 2, and k = h/2 pairs with itself
  const int n_freq = a.n_fft / 2 + 1, n_pairs = (h >> 1) + 1;
  const int64_t out0 = (int64_t)c * a.n_frames + t0;
  const int col1 = a.col0 + a.n_cols;
  Bounds bounds;
  bounds.reset();
  if (!MEL) {
    for (int g = 0, p = tid;; p += nt) {
      advance(g, p, a.n_range_pairs, n_valid);
      if (g >= n_valid) break;
      const int k = a.pair0 + p;
      const bool counted = a.t0 + t0 + g < nf;
      const float2 pw = pair_power(z + (g << L), k, h, L, sh, tw);
      float* orow = a.out + (out0 + g) * a.n_cols;
      if (k >= a.col0 && k < col1) {
        const float d = power_db(pw.x);
        orow[k - a.col0] = d;
        if (counted) bounds.add(d);
      }
      if (h - k != k && h < n_freq && h - k >= a.col0 && h - k < col1) {
        const float d = power_db(pw.y);
        orow[h - k - a.col0] = d;
        if (counted) bounds.add(d);
      }
    }
  } else {
    float* mag = reinterpret_cast<float*>(z + (G << L));  // [G][n_freq]
    for (int g = 0, k = tid;; k += nt) {
      advance(g, k, n_pairs, n_valid);
      if (g >= n_valid) break;
      const float2 pw = pair_power(z + (g << L), k, h, L, sh, tw);
      float* mrow = mag + g * n_freq;
      mrow[k] = sqrtf(pw.x);
      if (h - k != k && h < n_freq) mrow[h - k] = sqrtf(pw.y);
    }
    __syncthreads();
    for (int g = 0, j = tid;; j += nt) {
      advance(g, j, a.n_cols, n_valid);
      if (g >= n_valid) break;
      const int m = a.col0 + j;
      const int o0 = __ldg(a.mel_off + m), o1 = __ldg(a.mel_off + m + 1);
      const float* band = mag + g * n_freq + __ldg(a.mel_lo + m);
      float sum = 0.f;
      for (int o = o0; o < o1; ++o) sum = fmaf(band[o - o0], __ldg(a.mel_w + o), sum);
      const float d = amplitude_db(sum);
      a.out[(out0 + g) * a.n_cols + j] = d;
      if (a.t0 + t0 + g < nf) bounds.add(d);
    }
  }
  bounds.flush(a, c);
}

// ---------------------------------------------------------------------------
// Launch plans: the dynamic shared-memory attribute is raised once per
// kernel and device, and the persistent grid's CTAs per SM are computed once
// per kernel, device and shared size.

std::mutex plan_mutex;
std::map<std::tuple<int, const void*>, int> smem_set;
std::map<std::tuple<int, const void*, int>, int> resident;

// CTAs of fn that the device holds at once with `smem` dynamic bytes
// (0 in *ctas when only the attribute is wanted)
cudaError_t prepare(const void* fn, int threads, int smem, int* ctas) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(plan_mutex);
  int& set = smem_set[std::make_tuple(dev, fn)];
  if (smem > set) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    set = smem;
  }
  if (ctas == nullptr) return cudaSuccess;
  const auto key = std::make_tuple(dev, fn, smem);
  const auto hit = resident.find(key);
  if (hit != resident.end()) {
    *ctas = hit->second;
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *ctas = resident[key] = per_sm * sms;
  return cudaSuccess;
}

template <int LOG2L>
cudaError_t launch_regs(const Args& a, bool mel, int smem, cudaStream_t stream) {
  using R = Layout<LOG2L>;
  const void* fn = mel ? (const void*)spec_fft_kernel_regs<LOG2L, true>
                       : (const void*)spec_fft_kernel_regs<LOG2L, false>;
  int ctas = 0;
  cudaError_t err = prepare(fn, REG_WARPS * 32, smem, &ctas);
  if (err != cudaSuccess) return err;
  // as many warps as spread the frame groups evenly over the rounds the
  // resident warps need
  const int64_t items = (int64_t)a.n_rows * ((a.n_frames + R::G - 1) / R::G);
  const int64_t rounds = (items + (int64_t)ctas * REG_WARPS - 1) / ((int64_t)ctas * REG_WARPS);
  const int64_t warps = (items + rounds - 1) / rounds;
  const int grid = (int)((warps + REG_WARPS - 1) / REG_WARPS);
  if (mel)
    spec_fft_kernel_regs<LOG2L, true><<<grid, REG_WARPS * 32, smem, stream>>>(a);
  else
    spec_fft_kernel_regs<LOG2L, false><<<grid, REG_WARPS * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// Dynamic shared bytes the register schedule needs for n_fft (a power of
// two in 64..2048) and win, or 0 for an n_fft it does not cover
// (kernels/spec_db.py: launch_plan computes the same)
int64_t regs_smem(int64_t n_fft, int64_t win) {
  if (n_fft < (1 << REG_LOG2_NFFT_MIN) || n_fft > (1 << REG_LOG2_NFFT_MAX)) return 0;
  const int64_t h = n_fft / 2, lanes = h / 32, s = 32 * lanes + 32 + (lanes & 15);
  return (int64_t)REG_WARPS * (32 / lanes) * s * 8 + (32 + h + h / 2 + 1) * 8 + (win / 4 + 1) * 16;
}

}  // namespace

// Launches the mel variant when n_mel > 0, else the linear one, on `stream`.
// Rows start row_stride floats apart; row c has row_n[c] samples (row_n
// null: n_default each, the rows' width).  Frame t reads samples (t0 + t) *
// hop - pad .. + win - 1 of its row through the reflect map.  gains: one f32
// per row, or null for none.  The filterbank: for the shared-memory
// schedule mel_lo (n_mel,), mel_off (n_mel + 1,) and mel_w, per column m the
// weights of bins mel_lo[m] .. mel_lo[m] + mel_off[m+1] - mel_off[m] - 1 at
// mel_w[mel_off[m] ..]; for the register schedule mel_sched (n_sched, L)
// int2, the launch's columns flattened per lane (kernels/spec_db.py:
// mel_schedule), copied into shared memory (smem_bytes counts it).  out is (n_rows,
// n_frames, n_cols): columns [col0, col0 + n_cols) of the n_mel (mel) or
// n_fft/2 + 1 (linear) output columns.  row_min / row_max: (n_rows,) f32
// that the caller set to +inf / -inf (or to earlier bounds), lowered and
// raised to each row's bounds; null for none.  frames_per_cta and smem_bytes
// are the wrapper's plan (kernels/spec_db.py: launch_plan).  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int thesia_spec_fft(const float* rows, int64_t n_rows, int64_t row_stride,
                               const int* row_n, int64_t n_default, int64_t pad, int64_t t0,
                               int64_t hop, int64_t win, int64_t n_frames,
                               const float* window, const float* gains, int64_t n_fft,
                               const void* twiddles,
                               const int* mel_lo, const int* mel_off, const float* mel_w,
                               const void* mel_sched, int64_t n_sched,
                               int64_t n_mel, int64_t col0, int64_t n_cols,
                               int64_t frames_per_cta, int64_t smem_bytes, float* out,
                               float* row_min, float* row_max, void* stream) {
  const int64_t all_cols = n_mel > 0 ? n_mel : n_fft / 2 + 1;
  if (n_fft < 1 || n_fft > (1 << MAX_LOG2_NFFT) || (n_fft & (n_fft - 1)) || win > n_fft ||
      win < 1 || hop < 1 || n_frames < 1 || n_rows < 1 || n_rows > 65535 ||
      n_default < 1 || n_default >= (1 << 30) || pad < 0 || pad > (1 << 20) || t0 < 0 ||
      (t0 + n_frames - 1) * hop + win > n_default + 2 * pad || row_stride < 0 ||
      col0 < 0 || n_cols < 1 || col0 + n_cols > all_cols || (row_min == nullptr) != (row_max == nullptr))
    return (int)cudaErrorInvalidValue;
  int log2h = 0;  // h = max(n_fft / 2, 1) complex points
  while ((2LL << log2h) < n_fft) ++log2h;
  // linear: pairs (k, h-k), k <= h/2, with k or h-k in [col0, col1): k in
  // [col0, col1) or k in (h - col1, h - col0], hulled into one run of k
  const int h = 1 << log2h, n_pairs = (h >> 1) + 1;
  const int c0 = (int)col0, c1 = (int)(col0 + n_cols);
  const int a0 = c0, a1 = std::min(c1, n_pairs);
  const int b0 = std::max(h - c1 + 1, 0), b1 = std::min(h - c0, h >> 1) + 1;
  int p0 = n_pairs, p1 = 0;
  if (a0 < a1) {
    p0 = std::min(p0, a0);
    p1 = std::max(p1, a1);
  }
  if (b0 < b1) {
    p0 = std::min(p0, b0);
    p1 = std::max(p1, b1);
  }
  if (p0 >= p1) p0 = p1 = 0;
  Args a{rows, row_stride, row_n, (int)n_default, (int)pad, (int)t0, (int)hop, (int)win,
         (int)n_frames, (int)n_rows, window, gains, (int)n_fft, log2h,
         reinterpret_cast<const float2*>(twiddles), mel_lo, mel_off, mel_w,
         reinterpret_cast<const int2*>(mel_sched), (int)n_sched,
         c0, (int)n_cols, p0, p1 - p0, (int)frames_per_cta, out, row_min, row_max};
  const bool mel = n_mel > 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t need = regs_smem(n_fft, win);
  // the register schedule, unless the mel variant's column sums or its
  // flattened filterbank do not fit (the wrapper then passes no schedule)
  if (need > 0 && !(mel && (n_cols > h || mel_sched == nullptr))) {
    if (smem_bytes < need + (mel ? n_sched * (n_fft / 64) * 8 : 0) || (mel && n_sched < 1))
      return (int)cudaErrorInvalidValue;
    const int smem = (int)smem_bytes;
    switch (log2h - 5) {
      case 0: return (int)launch_regs<0>(a, mel, smem, s);
      case 1: return (int)launch_regs<1>(a, mel, smem, s);
      case 2: return (int)launch_regs<2>(a, mel, smem, s);
      case 3: return (int)launch_regs<3>(a, mel, smem, s);
      case 4: return (int)launch_regs<4>(a, mel, smem, s);
      default: return (int)launch_regs<5>(a, mel, smem, s);
    }
  }
  const int64_t g = frames_per_cta;
  if (g < 1 || smem_bytes < g * h * 8 + (mel ? g * (n_fft / 2 + 1) * 4 : 0))
    return (int)cudaErrorInvalidValue;
  const void* fn = mel ? (const void*)spec_fft_kernel<true> : (const void*)spec_fft_kernel<false>;
  cudaError_t err = prepare(fn, SMEM_THREADS, (int)smem_bytes, nullptr);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((n_frames + g - 1) / g), (unsigned)n_rows);
  if (mel)
    spec_fft_kernel<true><<<grid, SMEM_THREADS, (size_t)smem_bytes, s>>>(a);
  else
    spec_fft_kernel<false><<<grid, SMEM_THREADS, (size_t)smem_bytes, s>>>(a);
  return (int)cudaGetLastError();
}
