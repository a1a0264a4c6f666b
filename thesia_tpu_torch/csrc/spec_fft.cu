// Fused spectrogram for Hopper: windowed frames -> real FFT -> |.| -> (mel) -> dB.
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   * mel variant (K1):    tests/pallas_spec.py:131, spec_db_pallas / _kernel
//   * linear variant (K2): tests/pallas_spec.py:98,  spec_db_pallas_linear / _kernel_linear
// and computes what the production XLA path computes in
// thesia_tpu/dsp/spectrogram.py (_spec_full, _spec_multi_impl) after padding:
// frame t of row c is padded[c, t*hop : t*hop + win], each sample scaled by
// the row's gain (the normalize gain, thesia_tpu/dsp/spectrogram.py:247 and
// :322, applied as (x * g) * w, the JAX order; a null gains pointer means
// g = 1, and x * 1 is x bitwise); the output is
// dB(|DFT_n_fft(frame * window)|) over bins 0..n_fft/2, for the mel variant
// then multiplied by the filterbank (F, M); (C, n_frames, F|M) f32 with
// exactly -inf where the amplitude is 0.
//
// Why an FFT and not the TPU's window-folded DFT GEMM: the GEMM costs
// 4*win*F FLOP a frame (7.9 MFLOP at win 1920, F 1025), so in f32 on the CUDA
// cores (67 TFLOP/s) its bound is 7.05 ms for a 5-min 48 kHz stereo track.
// A real FFT of n_fft = 2048 points is about 64 kFLOP with the window, the
// split and the mel sums (kernels/spec_db.py: kernel_work), and a kernel that
// reads the wav and writes only dB moves 115 MB in and 83 MB (mel) or 246 MB
// (linear) out: bounds of 0.059 ms (mel) and 0.108 ms (linear), both set by
// the bytes at 3.35 TB/s (the 3.8 and 3.6 GFLOP take 0.057 and 0.054 ms at
// 67 TFLOP/s).  f32 throughout, no tensor cores: the
// FFT's rounding error (about eps*log2(N) of the row's amplitude) is below
// the f32 GEMM's.
//
// Design: a CTA of 128 threads owns G consecutive frames of one row (the
// wrapper's plan: G*n_fft/2 = 2048 complex values for n_fft <= 4096, G = 1
// above).  Loads are coalesced 8-byte reads of the frames straight from the
// padded rows (the 4x overlap of neighbouring frames hits L1/L2; each window
// pair is read once per CTA), windowed on the way into shared memory:
// the real frame of N = n_fft points (zero past win: the magnitude does not
// depend on where the window sits in the N points) becomes N/2 complex values
// z[n] = x[2n] + i x[2n+1].  An in-place decimation-in-frequency FFT of N/2
// points runs in shared memory: a radix-2 stage when log2(N/2) is odd, a
// radix-4 stage when the levels left are 2 mod 4, then radix-16 stages (two
// radix-4 stages on 16 values in registers), one barrier each -- three at
// n_fft 2048; the output is in bit-reversed order, read back through __brev.
// Addresses are XOR-swizzled inside 16-element blocks with bits 4-5 and the
// top four bits of the index, so at n_fft 1024 and 2048 every stage's
// half-warp hits distinct banks and the bit-reversed epilogue reads at most
// two-way (checked by a Python model of this schedule in
// tests/test_torch_kernels.py).
// Twiddles come from a table of e^{-2 pi i m / N} in the order the stages
// read them (coalesced), built on the host in float64 and rounded to f32 once
// per N (no __sincosf: its error grows with N).  The epilogue splits the
// N/2-point result into the real input's bins, one thread per bin pair
// (k, N/2 - k); the linear variant writes dB from the power, coalesced along
// F, the mel variant parks |X| in shared memory and sums each
// filterbank column over its nonzero band (packed by the wrapper), so the
// magnitude never reaches device memory -- the property the Pallas kernel kept
// in VMEM.  n_fft is any power of two from 1 to 32768 (the largest needs
// 128 KB of shared memory for the FFT and 64 KB for the mel magnitudes).
// Folding the reflect padding (K3) and the row min/max into the kernel is
// later work.
//
// Ranges, for a shard of the device mesh (parallel/sharding.py): frames come
// from rows at any row stride (row_len), so a shard of the "time" axis passes
// a view of the padded rows that starts at its first frame; a shard of the
// "freq" axis writes only output columns [col0, col0 + n_cols) (mel
// filterbank columns, or linear bins), each computed exactly as unsharded,
// after the whole FFT of its frames.  col0 = 0 with every column is the
// unsharded launch.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int MAX_LOG2_NFFT = 15;
constexpr int MAX_THREADS = 256;
// CTAs per SM the register budget is sized for: the mel variant at 3 (80
// registers, 16 bytes of spills), the linear one at 4 (64 registers, 88
// bytes of spills, faster all the same: PERF.md)
constexpr int MIN_BLOCKS_MEL = 3;
constexpr int MIN_BLOCKS_LINEAR = 4;

struct Args {
  const float* padded;
  int64_t row_len;
  int hop, win, n_frames;
  const float* window;
  const float* gains;  // (n_rows,) or null
  int n_fft, log2h;  // n_fft = 1 << (log2h + 1), or 1 with log2h = 0
  const float2* tw;  // twiddles in stage order, see span_planes
  const int* mel_lo;
  const int* mel_off;
  const float* mel_w;
  int col0, n_cols;  // output columns [col0, col0 + n_cols), out row width n_cols
  int pair0, n_range_pairs;  // linear: the bin pairs (k, h-k) that touch them
  int frames_per_cta;
  float* out;
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

// bank swizzle: a bijection inside each 16-element block (it XORs the low
// four bits with a function of the higher ones); sh = max(log2h - 4, 4)
__device__ __forceinline__ int swz(int p, int sh) {
  return p ^ ((((p >> 4) & 3) * 5) ^ ((p >> sh) & 15));
}

__device__ __forceinline__ int bitrev(int k, int bits) {
  return bits == 0 ? 0 : (int)(__brev((unsigned)k) >> (32 - bits));
}

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

__device__ __forceinline__ float2 twiddle(const float2* __restrict__ tw, int m) {
  return __ldg(tw + m);
}

// The twiddle table (kernels/spec_db.py: twiddle_exponents) holds, as
// (cos, -sin)(2 pi m / n_fft): W^k for the real split (k < h), then W_h^b
// for the radix-2 stage (b < h/2), then for every span S = 4, 8, .., h three
// planes of S/4 entries, W_S^j, W_S^2j, W_S^3j; so a stage's threads read
// consecutive entries.  The planes of span S start here:
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

// Powers |X[k]|^2 and |X[h-k]|^2 of the real input whose h-point FFT Z sits
// bit-reversed and swizzled in zf, for 0 < k < h: with E = (Z[k] + conj
// Z[h-k]) / 2 and O = (Z[k] - conj Z[h-k]) / 2i, X[k] = E + W^k O and
// X[h-k] = conj(E - W^k O).  At k = 0, X[0] = Re Z0 + Im Z0 and
// X[h] = Re Z0 - Im Z0.
__device__ __forceinline__ float2 pair_power(const float2* zf, int k, int h, int log2h, int sh,
                                             const float2* __restrict__ tw) {
  if (k == 0) {
    const float2 z0 = zf[0];  // swz(0) == 0
    const float x0 = z0.x + z0.y, xh = z0.x - z0.y;
    return make_float2(x0 * x0, xh * xh);
  }
  const float2 a = zf[swz(bitrev(k, log2h), sh)];
  const float2 b = zf[swz(bitrev(h - k, log2h), sh)];
  const float2 e = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
  const float2 o = make_float2(0.5f * (a.y + b.y), 0.5f * (b.x - a.x));
  const float2 wo = cmul(o, twiddle(tw, k));
  const float pr = e.x + wo.x, pi = e.y + wo.y, mr = e.x - wo.x, mi = e.y - wo.y;
  return make_float2(pr * pr + pi * pi, mr * mr + mi * mi);
}

// next (g, k) of a walk over n_valid rows of n entries in steps of nt
__device__ __forceinline__ void advance(int& g, int& k, int n, int n_valid) {
  while (k >= n && g < n_valid) {
    k -= n;
    ++g;
  }
}

template <bool MEL>
__global__ void __launch_bounds__(MAX_THREADS, MEL ? MIN_BLOCKS_MEL : MIN_BLOCKS_LINEAR) spec_fft_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float2* z = reinterpret_cast<float2*>(smem4);
  const int L = a.log2h, h = 1 << L, sh = max(L - 4, 4);
  const int G = a.frames_per_cta;
  const int c = blockIdx.y;
  const int t0 = blockIdx.x * G;
  const int n_valid = min(G, a.n_frames - t0);
  const float* row = a.padded + (int64_t)c * a.row_len;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float2* __restrict__ tw = a.tw;

  // 1. gained, windowed frames -> z[g][n] = x[2n] + i x[2n+1], zero past
  // win; each window pair is read once for the CTA's frames, samples in
  // 8-byte loads where the frame is 8-byte aligned
  const float gain = a.gains != nullptr ? __ldg(a.gains + c) : 1.f;
  for (int n = tid; n < h; n += nt) {
    const int s = 2 * n, p = swz(n, sh);
    const bool both = s + 1 < a.win;
    const float w0 = s < a.win ? __ldg(a.window + s) : 0.f;
    const float w1 = both ? __ldg(a.window + s + 1) : 0.f;
    for (int g = 0; g < G; ++g) {
      float re = 0.f, im = 0.f;
      if (g < n_valid) {
        const float* f = row + (int64_t)(t0 + g) * a.hop + s;
        if (both && ((uintptr_t)f & 7) == 0) {
          const float2 x = __ldg(reinterpret_cast<const float2*>(f));
          re = (x.x * gain) * w0;
          im = (x.y * gain) * w1;
        } else {
          if (s < a.win) re = (__ldg(f) * gain) * w0;
          if (both) im = (__ldg(f + 1) * gain) * w1;
        }
      }
      z[(g << L) + p] = make_float2(re, im);
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
      int at[16];
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        at[t] = swz(base + t * r, sh);
        v[t] = zf[at[t]];
      }
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
      for (int t = 0; t < 16; ++t) zf[at[t]] = v[t];
    }
    __syncthreads();
  }

  // 3. epilogue, one thread per bin pair (k, h-k), k <= h/2: dB of |X|
  // (linear) or |X| -> shared -> mel band sums -> dB; bin h exists for
  // n_fft >= 2, and k = h/2 pairs with itself
  const int n_freq = a.n_fft / 2 + 1, n_pairs = (h >> 1) + 1;
  const int64_t out0 = (int64_t)c * a.n_frames + t0;
  const int col1 = a.col0 + a.n_cols;
  if (!MEL) {
    for (int g = 0, p = tid;; p += nt) {
      advance(g, p, a.n_range_pairs, n_valid);
      if (g >= n_valid) break;
      const int k = a.pair0 + p;
      const float2 pw = pair_power(z + (g << L), k, h, L, sh, tw);
      float* orow = a.out + (out0 + g) * a.n_cols;
      if (k >= a.col0 && k < col1) orow[k - a.col0] = power_db(pw.x);
      if (h - k != k && h < n_freq && h - k >= a.col0 && h - k < col1)
        orow[h - k - a.col0] = power_db(pw.y);
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
      a.out[(out0 + g) * a.n_cols + j] = amplitude_db(sum);
    }
  }
}

}  // namespace

// Launches the mel variant when n_mel > 0, else the linear one, on `stream`.
// Rows start row_len floats apart (at least (n_frames - 1) * hop + win).
// gains: one f32 per row, or null for none.  mel_lo (n_mel,), mel_off
// (n_mel + 1,) and mel_w: per filterbank column m the weights of bins
// mel_lo[m] .. mel_lo[m] + mel_off[m+1] - mel_off[m] - 1 at
// mel_w[mel_off[m] ..].  out is (n_rows, n_frames, n_cols): columns [col0,
// col0 + n_cols) of the n_mel (mel) or n_fft/2 + 1 (linear) output columns.
// The launch plan (frames per CTA, threads, shared bytes) comes from the
// wrapper.  Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int thesia_spec_fft(const float* padded, int64_t n_rows, int64_t row_len,
                               int64_t hop, int64_t win, int64_t n_frames,
                               const float* window, const float* gains, int64_t n_fft,
                               const void* twiddles,
                               const int* mel_lo, const int* mel_off, const float* mel_w,
                               int64_t n_mel, int64_t col0, int64_t n_cols,
                               int64_t frames_per_cta, int64_t threads,
                               int64_t smem_bytes, float* out, void* stream) {
  const int64_t all_cols = n_mel > 0 ? n_mel : n_fft / 2 + 1;
  if (n_fft < 1 || n_fft > (1 << MAX_LOG2_NFFT) || (n_fft & (n_fft - 1)) || win > n_fft ||
      win < 1 || hop < 1 || n_frames < 1 || n_rows < 1 || n_rows > 65535 ||
      row_len < (n_frames - 1) * hop + win || col0 < 0 || n_cols < 1 ||
      col0 + n_cols > all_cols ||
      frames_per_cta < 1 || threads < 32 || threads > MAX_THREADS || threads % 32 != 0)
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
  Args a{padded, row_len, (int)hop, (int)win, (int)n_frames, window, gains, (int)n_fft, log2h,
         reinterpret_cast<const float2*>(twiddles), mel_lo, mel_off, mel_w,
         c0, (int)n_cols, p0, p1 - p0, (int)frames_per_cta, out};
  const void* fn = n_mel > 0 ? (const void*)spec_fft_kernel<true> : (const void*)spec_fft_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((n_frames + frames_per_cta - 1) / frames_per_cta), (unsigned)n_rows);
  if (n_mel > 0)
    spec_fft_kernel<true><<<grid, (unsigned)threads, (size_t)smem_bytes, (cudaStream_t)stream>>>(a);
  else
    spec_fft_kernel<false><<<grid, (unsigned)threads, (size_t)smem_bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
