// Host copy of thesia_tpu/native/src/thesia_native.cpp (verbatim apart from this line).
// thesia_tpu native runtime: render-tile encoders, exact lookahead limiter,
// FLAC decoder.  C ABI, loaded via ctypes.
//
// These are the host-side hot paths that the reference implements in Rust
// (reference: src-tauri/src/core/render_tiles.rs, dynamics/limiter.rs,
// dynamics/envelope.rs; decode via the symphonia crate).  The TPU handles the
// batched DSP; this library handles latency-critical per-request encoding and
// bit-exact sequential recurrences.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Lanczos3 fractional-crop resize, u16, two passes with u16 rounding between
// (matches thesia_tpu/render/resize.py; reference: render_tiles.rs:354-393)

static inline double lanczos3(double x) {
  if (x <= -3.0 || x >= 3.0) return 0.0;
  if (x == 0.0) return 1.0;
  const double pix = M_PI * x;
  return 3.0 * std::sin(pix) * std::sin(pix / 3.0) / (pix * pix);
}

struct AxisWeights {
  int k;                    // taps per dst pixel
  std::vector<int32_t> idx; // (dst, k) clamped source indices
  std::vector<double> w;    // (dst, k) normalized weights
};

static void axis_weights(int src_size, double crop_start, double crop_size,
                         int dst_size, AxisWeights &out) {
  const double scale = crop_size / dst_size;
  const double filter_scale = std::max(scale, 1.0);
  const double support = 3.0 * filter_scale;
  // max taps over all dst pixels
  int k = 0;
  std::vector<double> centers(dst_size);
  std::vector<int64_t> lefts(dst_size), rights(dst_size);
  for (int d = 0; d < dst_size; ++d) {
    const double c = crop_start + (d + 0.5) * scale;
    centers[d] = c;
    lefts[d] = (int64_t)std::floor(c - support);
    rights[d] = (int64_t)std::ceil(c + support);
    k = std::max<int>(k, (int)(rights[d] - lefts[d]));
  }
  out.k = k;
  out.idx.assign((size_t)dst_size * k, 0);
  out.w.assign((size_t)dst_size * k, 0.0);
  for (int d = 0; d < dst_size; ++d) {
    double norm = 0.0;
    for (int j = 0; j < k; ++j) {
      const int64_t i = lefts[d] + j;
      const bool valid = i >= 0 && i < src_size && i < rights[d];
      double wj = valid ? lanczos3((i + 0.5 - centers[d]) / filter_scale) : 0.0;
      out.w[(size_t)d * k + j] = wj;
      out.idx[(size_t)d * k + j] =
          (int32_t)std::clamp<int64_t>(i, 0, src_size - 1);
      norm += wj;
    }
    if (norm == 0.0) norm = 1.0;
    for (int j = 0; j < k; ++j) out.w[(size_t)d * k + j] /= norm;
  }
}

static inline uint16_t round_clamp_u16(double x) {
  double r = std::floor(x + 0.5);
  if (r < 0.0) r = 0.0;
  if (r > 65535.0) r = 65535.0;
  return (uint16_t)r;
}

// dst must hold dst_w*dst_h u16
void lanczos3_crop_resize_u16(const uint16_t *src, int src_h, int src_w,
                              double left, double top, double right,
                              double bottom, int dst_w, int dst_h,
                              uint16_t *dst) {
  AxisWeights wx, wy;
  axis_weights(src_w, left, right - left, dst_w, wx);
  axis_weights(src_h, top, bottom - top, dst_h, wy);

  // only source rows referenced by the vertical pass need the horizontal pass
  int y0 = src_h, y1 = 0;
  for (int32_t i : wy.idx) {
    y0 = std::min(y0, (int)i);
    y1 = std::max(y1, (int)i + 1);
  }
  if (y0 >= y1) { y0 = 0; y1 = std::min(src_h, 1); }

  // horizontal pass: rows [y0, y1) -> (y1-y0, dst_w)
  std::vector<uint16_t> horiz((size_t)(y1 - y0) * dst_w);
  for (int y = y0; y < y1; ++y) {
    const uint16_t *row = src + (size_t)y * src_w;
    uint16_t *orow = horiz.data() + (size_t)(y - y0) * dst_w;
    for (int d = 0; d < dst_w; ++d) {
      double acc = 0.0;
      const size_t base = (size_t)d * wx.k;
      const double *w = wx.w.data() + base;
      const int32_t *ix = wx.idx.data() + base;
      for (int j = 0; j < wx.k; ++j) acc += w[j] * row[ix[j]];
      orow[d] = round_clamp_u16(acc);
    }
  }
  // vertical pass: accumulate whole output rows so the inner loop vectorizes
  std::vector<double> acc(dst_w);
  for (int d = 0; d < dst_h; ++d) {
    const size_t base = (size_t)d * wy.k;
    std::fill(acc.begin(), acc.end(), 0.0);
    for (int j = 0; j < wy.k; ++j) {
      const double wj = wy.w[base + j];
      if (wj == 0.0) continue;
      const uint16_t *rowj =
          horiz.data() + (size_t)(wy.idx[base + j] - y0) * dst_w;
      for (int x = 0; x < dst_w; ++x) acc[x] += wj * rowj[x];
    }
    uint16_t *orow = dst + (size_t)d * dst_w;
    for (int x = 0; x < dst_w; ++x) orow[x] = round_clamp_u16(acc[x]);
  }
}

// Full RGBA body of a spectrogram tile: resize + colormap LUT, rows emitted
// bottom-up (high frequencies first).  out_rgba must hold width*height*4.
// (reference: render_tiles.rs:326-351)
void spectrogram_tile_rgba(const uint16_t *spec, int src_h, int src_w,
                           double left, double top, double right,
                           double bottom, int width, int height,
                           const uint8_t *colormap_rgba, int n_colors,
                           uint8_t *out_rgba) {
  std::vector<uint16_t> pixels((size_t)width * height);
  lanczos3_crop_resize_u16(spec, src_h, src_w, left, top, right, bottom, width,
                           height, pixels.data());
  for (int row = 0; row < height; ++row) {
    const uint16_t *prow = pixels.data() + (size_t)(height - 1 - row) * width;
    uint8_t *orow = out_rgba + (size_t)row * width * 4;
    for (int x = 0; x < width; ++x) {
      size_t ci = 0;
      if (n_colors > 1)
        ci = ((size_t)prow[x] * (n_colors - 1) + 32767) / 65535;
      std::memcpy(orow + (size_t)x * 4, colormap_rgba + ci * 4, 4);
    }
  }
}

// X-axis mip halving: (h, w) u16 -> (h, ceil(w/2)) u16, pairwise
// round-half-up average, odd trailing column copied through.  Used by the
// render mip chain (render/mips.py) that replaces the reference's
// per-request full-res LOD resize (render_tiles.rs:281-315).
void halve_x_u16(const uint16_t *src, int64_t h, int64_t w, uint16_t *out) {
  const int64_t half = w / 2;
  const int64_t out_w = (w + 1) / 2;
  for (int64_t y = 0; y < h; ++y) {
    const uint16_t *row = src + y * w;
    uint16_t *orow = out + y * out_w;
    for (int64_t x = 0; x < half; ++x)
      orow[x] =
          (uint16_t)(((uint32_t)row[2 * x] + (uint32_t)row[2 * x + 1] + 1) >> 1);
    if (w & 1) orow[out_w - 1] = row[w - 1];
  }
}

// Colormap a u16 image through a prebuilt 65536-entry RGBA LUT, emitting
// rows bottom-up (high freq first) — the identity-LOD tile fast path.
void u16_rgba_rows_bottom_up(const uint16_t *pixels, int64_t h, int64_t w,
                             const uint8_t *lut_rgba /* 65536*4 */,
                             uint8_t *out_rgba) {
  const uint32_t *lut = (const uint32_t *)lut_rgba;
  for (int64_t row = 0; row < h; ++row) {
    const uint16_t *prow = pixels + (h - 1 - row) * w;
    uint32_t *orow = (uint32_t *)(out_rgba + (size_t)row * w * 4);
    for (int64_t x = 0; x < w; ++x) orow[x] = lut[prow[x]];
  }
}

// Waveform bins: (min, max, mean) per bin.  out: bin_count*3 f32 (min,max,mean)
// (reference: render_tiles.rs:249-279)
void waveform_bin_stats(const float *wav, int64_t start, int64_t end,
                        int64_t samples_per_bin, int64_t bin_count,
                        float *out) {
  for (int64_t b = 0; b < bin_count; ++b) {
    const int64_t s = start + b * samples_per_bin;
    const int64_t e = std::min(end, s + samples_per_bin);
    float mn = INFINITY, mx = -INFINITY;
    double sum = 0.0;
    for (int64_t i = s; i < e; ++i) {
      const float v = wav[i];
      mn = std::min(mn, v);
      mx = std::max(mx, v);
      sum += v;
    }
    out[b * 3 + 0] = mn;
    out[b * 3 + 1] = mx;
    out[b * 3 + 2] = (float)(sum / (double)(e - s));
  }
}

// ---------------------------------------------------------------------------
// Exact lookahead limiter (f64 streaming; reference: limiter.rs:45-172,
// envelope.rs — same published Signalsmith algorithms, implemented from the
// algorithm description)

namespace {

struct SlidingMax {
  // monotonic deque sliding max over a fixed window (history = -inf)
  std::deque<std::pair<int64_t, double>> dq;
  int64_t t = 0;
  int64_t window;
  explicit SlidingMax(int64_t w) : window(std::max<int64_t>(w, 1)) {}
  double step(double v) {
    while (!dq.empty() && dq.back().second <= v) dq.pop_back();
    dq.emplace_back(t, v);
    while (dq.front().first <= t - window) dq.pop_front();
    ++t;
    return dq.front().second;
  }
};

struct BoxFilterN {
  // moving average over len samples with fill history, f64
  std::vector<double> buf;
  size_t idx = 0;
  double sum = 0.0;
  size_t len;
  explicit BoxFilterN(size_t l, double fill) : len(std::max<size_t>(l, 1)) {
    buf.assign(len, fill);
    for (double v : buf) sum += v;
  }
  double step(double v) {
    sum += v - buf[idx];
    buf[idx] = v;
    idx = (idx + 1) % len;
    return sum / (double)len;
  }
};

}  // namespace

// layer lengths for a 3-layer box stack of total size `size`
// (reference: envelope.rs:229-265 + optimal ratios for 3 layers)
static void stack3_lengths(int64_t size, int64_t out_len[3]) {
  static const double ratios[3] = {0.404078562416, 0.334851475794,
                                   0.261069961789};
  const double order = (double)(size - 1);
  double errs[3];
  int64_t total = 0;
  for (int i = 0; i < 3; ++i) {
    const double lf = ratios[i] * order;
    const int64_t lo = (int64_t)lf;
    out_len[i] = lo + 1;
    errs[i] = (double)lo - lf;
    total += lo;
  }
  for (int64_t s = total; s < (int64_t)order; ++s) {
    int mi = 0;
    for (int i = 1; i < 3; ++i)
      if (errs[i] < errs[mi]) mi = i;
    out_len[mi] += 1;
    errs[mi] += 1.0;
  }
}

// gain_seq for interleaved-frame processing with `attack` latency
// compensation.  wavs: planar (n_ch, n) f32.  out_gain: n f64.
void limiter_gain_seq(const float *wavs, int64_t n_ch, int64_t n, uint32_t sr,
                      double threshold, double attack_ms, double hold_ms,
                      double release_ms, double *out_gain) {
  const double ms2smp = (double)sr / 1000.0;
  const int64_t attack = (int64_t)std::floor(attack_ms * ms2smp + 0.5);
  const int64_t hold_len =
      (int64_t)std::floor((attack_ms + hold_ms) * ms2smp + 0.5);
  const double release_samples = release_ms * ms2smp;
  const double slew = 1.0 / (release_samples + 1.0);
  const double eps = 2.2204460492503131e-16;  // f64::EPSILON

  SlidingMax ph(hold_len);
  int64_t len3[3];
  stack3_lengths(std::max<int64_t>(attack, 1), len3);
  BoxFilterN b0((size_t)len3[0], 1.0), b1((size_t)len3[1], 1.0),
      b2((size_t)len3[2], 1.0);
  double y_rel = 1.0;

  const int64_t total = n + attack;
  for (int64_t t = 0; t < total; ++t) {
    double v = 0.0;
    if (t < n) {
      for (int64_t c = 0; c < n_ch; ++c)
        v = std::max(v, (double)std::fabs(wavs[c * n + t]));
    }
    const double raw = v > threshold ? threshold / (v + eps) : 1.0;
    const double held = -ph.step(-raw);
    y_rel = std::min(held, std::fma(held - y_rel, slew, y_rel));
    double sm = y_rel;
    if (attack > 0) sm = b2.step(b1.step(b0.step(sm)));
    const double g = std::min(sm, 1.0);
    if (t >= attack) out_gain[t - attack] = g;
  }
}

// apply gain in-place: wavs planar (n_ch, n) f32, per-sample f64 gain
// (reference: limiter.rs:123-133)
void limiter_apply(float *wavs, int64_t n_ch, int64_t n,
                   const double *gain) {
  for (int64_t c = 0; c < n_ch; ++c) {
    float *ch = wavs + c * n;
    for (int64_t i = 0; i < n; ++i) {
      double y = (double)ch[i] * gain[i];
      y = std::clamp(y, -1.0, 1.0);
      ch[i] = (float)y;
    }
  }
}

// ---------------------------------------------------------------------------
// FLAC decoder (format per the FLAC specification / RFC 9639)

namespace flac {

struct BitReader {
  const uint8_t *data;
  size_t len;
  size_t byte = 0;
  int bit = 0;  // bits consumed in current byte
  bool error = false;

  explicit BitReader(const uint8_t *d, size_t l) : data(d), len(l) {}

  bool at_end() const { return byte >= len; }

  uint64_t bits(int count) {
    uint64_t v = 0;
    for (int i = 0; i < count; ++i) {
      if (byte >= len) {
        error = true;
        return v;
      }
      v = (v << 1) | ((data[byte] >> (7 - bit)) & 1u);
      if (++bit == 8) {
        bit = 0;
        ++byte;
      }
    }
    return v;
  }

  int64_t signed_bits(int count) {
    uint64_t v = bits(count);
    if (count == 0) return 0;
    const uint64_t sign = 1ull << (count - 1);
    return (v & sign) ? (int64_t)(v | ~((sign << 1) - 1)) : (int64_t)v;
  }

  uint64_t unary() {
    uint64_t q = 0;
    while (!error && bits(1) == 0) {
      ++q;
      if (q > 1u << 24) {  // corrupt stream guard
        error = true;
        break;
      }
    }
    return q;
  }

  void align() {
    if (bit != 0) {
      bit = 0;
      ++byte;
    }
  }
};

static const int FIXED_COEFFS[5][4] = {
    {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

static bool decode_residual(BitReader &br, int order, int block_size,
                            int64_t *out /* block_size, warmup prefilled */) {
  const int method = (int)br.bits(2);
  if (method > 1) return false;
  const int param_bits = method == 0 ? 4 : 5;
  const uint32_t escape = method == 0 ? 0xF : 0x1F;
  const int po = (int)br.bits(4);
  const int partitions = 1 << po;
  if (block_size % partitions != 0) return false;
  int idx = order;
  for (int p = 0; p < partitions; ++p) {
    int count = block_size >> po;
    if (p == 0) count -= order;
    if (count < 0) return false;
    const uint32_t param = (uint32_t)br.bits(param_bits);
    if (param == escape) {
      const int raw_bits = (int)br.bits(5);
      for (int i = 0; i < count; ++i)
        out[idx++] = raw_bits ? br.signed_bits(raw_bits) : 0;
    } else {
      for (int i = 0; i < count; ++i) {
        const uint64_t q = br.unary();
        const uint64_t r = br.bits(param);
        const uint64_t zz = (q << param) | r;
        out[idx++] = (int64_t)(zz >> 1) ^ -(int64_t)(zz & 1);
      }
    }
    if (br.error) return false;
  }
  return true;
}

static bool decode_subframe(BitReader &br, int block_size, int bps,
                            std::vector<int64_t> &out) {
  out.assign(block_size, 0);
  if (br.bits(1) != 0) return false;  // zero pad bit
  const int type = (int)br.bits(6);
  int wasted = 0;
  if (br.bits(1) == 1) wasted = 1 + (int)br.unary();
  const int ebps = bps - wasted;
  if (ebps <= 0 || ebps > 33) return false;

  if (type == 0) {  // constant
    const int64_t v = br.signed_bits(ebps);
    for (int i = 0; i < block_size; ++i) out[i] = v;
  } else if (type == 1) {  // verbatim
    for (int i = 0; i < block_size; ++i) out[i] = br.signed_bits(ebps);
  } else if (type >= 8 && type <= 12) {  // fixed
    const int order = type - 8;
    if (order > block_size) return false;  // warmup would overflow `out`
    for (int i = 0; i < order; ++i) out[i] = br.signed_bits(ebps);
    if (!decode_residual(br, order, block_size, out.data())) return false;
    for (int i = order; i < block_size; ++i) {
      // accumulate in uint64: crafted streams can exceed int64 range and
      // signed overflow is UB under -O3 (wrapping matches decoder practice)
      uint64_t pred = 0;
      for (int j = 0; j < order; ++j)
        pred += (uint64_t)FIXED_COEFFS[order][j] * (uint64_t)out[i - 1 - j];
      out[i] = (int64_t)((uint64_t)out[i] + pred);
    }
  } else if (type >= 32) {  // LPC
    const int order = (type & 31) + 1;
    if (order > block_size) return false;  // warmup would overflow `out`
    for (int i = 0; i < order; ++i) out[i] = br.signed_bits(ebps);
    const int precision = (int)br.bits(4) + 1;
    if (precision == 16) return false;  // 0b1111 invalid
    const int shift = (int)br.signed_bits(5);
    if (shift < 0) return false;
    int64_t coefs[32];
    for (int i = 0; i < order; ++i) coefs[i] = br.signed_bits(precision);
    if (!decode_residual(br, order, block_size, out.data())) return false;
    for (int i = order; i < block_size; ++i) {
      uint64_t pred = 0;
      for (int j = 0; j < order; ++j)
        pred += (uint64_t)coefs[j] * (uint64_t)out[i - 1 - j];
      out[i] = (int64_t)((uint64_t)out[i] + ((int64_t)pred >> shift));
    }
  } else {
    return false;
  }
  if (wasted)
    for (int i = 0; i < block_size; ++i)
      out[i] = (int64_t)((uint64_t)out[i] << wasted);  // shift of negatives is UB
  return !br.error;
}

static int64_t read_utf8_number(BitReader &br) {
  const uint64_t b0 = br.bits(8);
  if (br.error) return -1;
  int extra;
  uint64_t v;
  if (b0 < 0x80) return (int64_t)b0;
  else if ((b0 & 0xE0) == 0xC0) { extra = 1; v = b0 & 0x1F; }
  else if ((b0 & 0xF0) == 0xE0) { extra = 2; v = b0 & 0x0F; }
  else if ((b0 & 0xF8) == 0xF0) { extra = 3; v = b0 & 0x07; }
  else if ((b0 & 0xFC) == 0xF8) { extra = 4; v = b0 & 0x03; }
  else if ((b0 & 0xFE) == 0xFC) { extra = 5; v = b0 & 0x01; }
  else if (b0 == 0xFE) { extra = 6; v = 0; }
  else return -1;
  for (int i = 0; i < extra; ++i) {
    const uint64_t b = br.bits(8);
    if ((b & 0xC0) != 0x80) return -1;
    v = (v << 6) | (b & 0x3F);
  }
  return (int64_t)v;
}

}  // namespace flac

// Decodes a whole FLAC stream.  Returns 0 on success.  Caller frees *out with
// thesia_free.  Output: planar f32 (n_ch, n_samples).
int flac_decode(const uint8_t *data, size_t len, float **out, uint32_t *sr_out,
                uint32_t *n_ch_out, uint64_t *n_samples_out,
                uint32_t *bps_out) {
  using namespace flac;
  if (len < 8 || std::memcmp(data, "fLaC", 4) != 0) return 1;
  size_t pos = 4;
  uint32_t sr = 0, n_ch = 0, bps = 0;
  uint64_t total_samples = 0;
  bool last = false, have_streaminfo = false;
  while (!last && pos + 4 <= len) {
    const uint8_t hdr = data[pos];
    last = hdr & 0x80;
    const int type = hdr & 0x7F;
    const uint32_t blen =
        ((uint32_t)data[pos + 1] << 16) | ((uint32_t)data[pos + 2] << 8) |
        data[pos + 3];
    pos += 4;
    if (pos + blen > len) return 2;
    if (type == 0 && blen >= 34) {
      const uint8_t *b = data + pos;
      sr = ((uint32_t)b[10] << 12) | ((uint32_t)b[11] << 4) | (b[12] >> 4);
      n_ch = ((b[12] >> 1) & 0x7) + 1;
      bps = (((b[12] & 1) << 4) | (b[13] >> 4)) + 1;
      total_samples = ((uint64_t)(b[13] & 0x0F) << 32) |
                      ((uint64_t)b[14] << 24) | ((uint64_t)b[15] << 16) |
                      ((uint64_t)b[16] << 8) | b[17];
      have_streaminfo = true;
    }
    pos += blen;
  }
  if (!have_streaminfo || sr == 0 || n_ch == 0) return 3;

  std::vector<std::vector<float>> planes(n_ch);
  // cap the up-front reserve: the 36-bit streaminfo count is attacker
  // controlled (a tiny crafted file could demand ~274 GB/channel and the
  // resulting bad_alloc would escape the extern "C" boundary).  reserve is
  // only an optimization — amortized growth covers genuinely long streams.
  const uint64_t reserve_cap =
      std::min<uint64_t>(total_samples, (uint64_t)1 << 24);
  for (auto &p : planes) p.reserve((size_t)reserve_cap);

  std::vector<std::vector<int64_t>> chans(n_ch);
  while (pos + 2 < len) {
    // find frame sync
    if (!(data[pos] == 0xFF && (data[pos + 1] & 0xFC) == 0xF8)) {
      ++pos;
      continue;
    }
    BitReader br(data + pos, len - pos);
    br.bits(14);                       // sync
    br.bits(1);                        // reserved
    br.bits(1);                        // blocking strategy
    const int bs_code = (int)br.bits(4);
    const int sr_code = (int)br.bits(4);
    const int ch_asgn = (int)br.bits(4);
    const int ss_code = (int)br.bits(3);
    br.bits(1);  // reserved
    if (read_utf8_number(br) < 0) {
      ++pos;
      continue;
    }
    int block_size;
    switch (bs_code) {
      case 0: block_size = -1; break;
      case 1: block_size = 192; break;
      case 6: block_size = (int)br.bits(8) + 1; break;
      case 7: block_size = (int)br.bits(16) + 1; break;
      default:
        block_size = bs_code <= 5 ? 576 << (bs_code - 2) : 256 << (bs_code - 8);
    }
    if (block_size <= 0) {
      ++pos;
      continue;
    }
    if (sr_code == 12) br.bits(8);
    else if (sr_code == 13 || sr_code == 14) br.bits(16);
    br.bits(8);  // CRC-8

    int frame_ch = n_ch;
    if (ch_asgn >= 8 && ch_asgn <= 10) frame_ch = 2;
    else if (ch_asgn <= 7) frame_ch = ch_asgn + 1;
    else {
      ++pos;
      continue;
    }
    if ((uint32_t)frame_ch != n_ch) {
      ++pos;
      continue;
    }
    int frame_bps = (int)bps;
    switch (ss_code) {
      case 0: break;
      case 1: frame_bps = 8; break;
      case 2: frame_bps = 12; break;
      case 4: frame_bps = 16; break;
      case 5: frame_bps = 20; break;
      case 6: frame_bps = 24; break;
      case 7: frame_bps = 32; break;
      default: frame_bps = (int)bps;
    }

    bool ok = true;
    for (int c = 0; c < frame_ch && ok; ++c) {
      int ch_bps = frame_bps;
      if ((ch_asgn == 8 && c == 1) || (ch_asgn == 9 && c == 0) ||
          (ch_asgn == 10 && c == 1))
        ch_bps += 1;  // side channel carries one extra bit
      ok = decode_subframe(br, block_size, ch_bps, chans[c]);
    }
    if (!ok || br.error) {
      ++pos;  // bad frame: resync
      continue;
    }
    br.align();
    br.bits(16);  // CRC-16

    // stereo decorrelation
    if (ch_asgn == 8) {  // left/side
      for (int i = 0; i < block_size; ++i)
        chans[1][i] = chans[0][i] - chans[1][i];
    } else if (ch_asgn == 9) {  // side/right
      for (int i = 0; i < block_size; ++i)
        chans[0][i] = chans[1][i] + chans[0][i];
    } else if (ch_asgn == 10) {  // mid/side
      for (int i = 0; i < block_size; ++i) {
        const int64_t side = chans[1][i];
        // left-shifting a negative value is UB; shift in uint64
        int64_t mid = (int64_t)(((uint64_t)chans[0][i] << 1) | (uint64_t)(side & 1));
        chans[0][i] = (mid + side) >> 1;
        chans[1][i] = (mid - side) >> 1;
      }
    }

    const double scale = 1.0 / (double)(1ull << (frame_bps - 1));
    for (uint32_t c = 0; c < n_ch; ++c)
      for (int i = 0; i < block_size; ++i)
        planes[c].push_back((float)((double)chans[c][i] * scale));

    pos += br.byte + (br.bit ? 1 : 0);
  }

  const uint64_t n = planes[0].size();
  if (n == 0) return 4;
  float *buf = (float *)std::malloc(sizeof(float) * n * n_ch);
  if (!buf) return 5;
  for (uint32_t c = 0; c < n_ch; ++c)
    std::memcpy(buf + (size_t)c * n, planes[c].data(), sizeof(float) * n);
  *out = buf;
  *sr_out = sr;
  *n_ch_out = n_ch;
  *n_samples_out = n;
  *bps_out = bps;
  return 0;
}

// PCM payload -> planar f32 (n_ch, n).  fmt: 0=f32le 1=f64le 2=u8 3=s16le
// 4=s24le 5=s32le.  Replaces numpy's astype+transpose (measured ~30x slower
// than memcpy on the build host for GB-scale tracks).
// Decode one interleaved buffer to f32 (sequential read + sequential write;
// trivially vectorized).
static void pcm_to_f32_seq(const uint8_t *src, int64_t count, int fmt,
                           float *__restrict out) {
  switch (fmt) {
    case 1: {
      const double *s = (const double *)src;
      for (int64_t i = 0; i < count; ++i) out[i] = (float)s[i];
      break;
    }
    case 2:
      for (int64_t i = 0; i < count; ++i)
        out[i] = ((float)src[i] - 128.0f) / 128.0f;
      break;
    case 3: {
      const int16_t *s = (const int16_t *)src;
      for (int64_t i = 0; i < count; ++i) out[i] = (float)s[i] / 32768.0f;
      break;
    }
    case 4:
      for (int64_t i = 0; i < count; ++i) {
        const uint8_t *p = src + 3 * i;
        int32_t v = (int32_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                              ((uint32_t)p[2] << 16));
        // sign-extend 24 -> 32 via unsigned shift (a signed left shift
        // of a value with bit 23 set is UB; same pattern as the FLAC
        // decoder's shifts)
        v = (int32_t)((uint32_t)v << 8) >> 8;
        out[i] = (float)v / 8388608.0f;
      }
      break;
    case 5: {
      // cast to f32 FIRST, then divide by the exact power of two — the
      // numpy fallback (io/wav.py) and the reference both do int32->f32
      // before the divide, and the double-divide rounding differs in the
      // last ulp for >24-significant-bit samples (cross-path byte
      // identity; review finding)
      const int32_t *s = (const int32_t *)src;
      for (int64_t i = 0; i < count; ++i)
        out[i] = (float)s[i] / 2147483648.0f;
      break;
    }
  }
}

int pcm_to_f32_planar(const uint8_t *src, int64_t n, int64_t n_ch, int fmt,
                      float *out /* n_ch * n */) {
  // two memory-speed passes: fmt -> interleaved f32, then deinterleave with
  // alias-free local cursors (an earlier pointer-array formulation defeated
  // the optimizer: 73 ns/elem vs ~3 ns here)
  const float *inter;
  float *tmp = nullptr;
  if (fmt == 0) {
    inter = (const float *)src;
  } else {
    tmp = (float *)std::malloc((size_t)n * n_ch * 4);
    if (!tmp) return -1;  // GB-scale payloads under memory pressure: the
                          // caller raises MemoryError — silently returning
                          // zeros decoded as a valid silent track (review
                          // finding)
    pcm_to_f32_seq(src, n * n_ch, fmt, tmp);
    inter = tmp;
  }
  if (n_ch == 1) {
    std::memcpy(out, inter, (size_t)n * 4);
  } else if (n_ch == 2) {
    float *__restrict o0 = out;
    float *__restrict o1 = out + n;
    for (int64_t i = 0; i < n; ++i) {
      o0[i] = inter[2 * i];
      o1[i] = inter[2 * i + 1];
    }
  } else {
    for (int64_t ch = 0; ch < n_ch; ++ch) {
      float *__restrict o = out + ch * n;
      const float *s = inter + ch;
      for (int64_t i = 0; i < n; ++i) o[i] = s[i * n_ch];
    }
  }
  std::free(tmp);
  return 0;
}

// Streaming per-track statistics in one pass (reference:
// src-tauri/src/core/dynamics/stats.rs:44-109 via the ebur128 crate):
// K-weighting biquad cascade (f64, direct form II transposed) ->
// per-100ms-segment energies (the caller assembles 400 ms gating blocks and
// applies BS.1770 gating), plus sum of squares and abs peak of the RAW
// samples.  seg_energies must hold n / s100 doubles where
// s100 = (sr + 5) / 10.  All channels accumulate HERE with BS.1770
// weights: ch 0-2 weight 1.0, ch >= 3 weight 1.41 (matches loudness.py).
void audio_stats(const float *wavs, int64_t n_ch, int64_t n, uint32_t sr,
                 const double *b1, const double *a1, const double *b2,
                 const double *a2, double *seg_energies, int64_t n_segs,
                 double *sum_sq_out, double *abs_max_out) {
  // sr < 5 would make s100 zero and `i / s100` a SIGFPE; such rates are
  // nonsense audio but reachable from a well-formed WAV header
  const int64_t s100 = sr >= 5 ? (sr + 5) / 10 : 1;
  for (int64_t k = 0; k < n_segs; ++k) seg_energies[k] = 0.0;
  double sum_sq = 0.0;
  double abs_max = 0.0;
  for (int64_t ch = 0; ch < n_ch; ++ch) {
    const float *x = wavs + ch * n;
    const double w = ch >= 3 ? 1.41 : 1.0;
    double z11 = 0.0, z12 = 0.0, z21 = 0.0, z22 = 0.0;  // DF2T states
    double sq_acc = 0.0;
    for (int64_t i = 0; i < n; ++i) {
      const double v = (double)x[i];
      const double av = v < 0 ? -v : v;
      if (av > abs_max) abs_max = av;
      sq_acc += v * v;
      // stage 1 (shelf): y = b0*v + z1; z1 = b1*v - a1*y + z2; z2 = b2*v - a2*y
      const double y1 = b1[0] * v + z11;
      z11 = b1[1] * v - a1[1] * y1 + z12;
      z12 = b1[2] * v - a1[2] * y1;
      // stage 2 (high-pass)
      const double y2 = b2[0] * y1 + z21;
      z21 = b2[1] * y1 - a2[1] * y2 + z22;
      z22 = b2[2] * y1 - a2[2] * y2;
      const int64_t seg = i / s100;
      if (seg < n_segs) seg_energies[seg] += w * y2 * y2;
    }
    sum_sq += sq_acc;
  }
  *sum_sq_out = sum_sq;
  *abs_max_out = abs_max;
}

// Polyphase windowed-sinc resampler hot loop (player/resampler.py): for
// each output frame, linear-interpolate between two adjacent phase filters
// and convolve a sinc_len window around the (fractional) input position.
// Matches the numpy fallback's math incl. edge clamping.  The playback
// callback budget makes this native (numpy measured ~30 s per second of
// stereo audio on the build host).
void resample_block(const float *buf /* n_ch * n_total */, int64_t n_ch,
                    int64_t n_total, const double *bank /* (n_phases+1)*L */,
                    int64_t n_phases, int64_t sinc_len, double pos0,
                    double ratio, int64_t n_out, float *out /* n_ch*n_out */) {
  const int64_t half = sinc_len / 2;
  for (int64_t o = 0; o < n_out; ++o) {
    const double pos = pos0 + (double)o * ratio;
    const int64_t ip = (int64_t)std::floor(pos);
    const double frac = pos - (double)ip;
    const double ph = frac * (double)n_phases;
    int64_t ph_i = (int64_t)std::floor(ph);
    if (ph_i > n_phases - 1) ph_i = n_phases - 1;
    const double ph_f = ph - (double)ph_i;
    const double *f0 = bank + ph_i * sinc_len;
    const double *f1 = f0 + sinc_len;
    const int64_t start = ip - half + 1;
    for (int64_t ch = 0; ch < n_ch; ++ch) {
      const float *x = buf + ch * n_total;
      double acc = 0.0;
      if (start >= 0 && start + sinc_len <= n_total) {
        const float *xw = x + start;
        for (int64_t k = 0; k < sinc_len; ++k)
          acc += (double)xw[k] * (f0[k] + (f1[k] - f0[k]) * ph_f);
      } else {
        for (int64_t k = 0; k < sinc_len; ++k) {
          int64_t idx = start + k;
          if (idx < 0) idx = 0;
          if (idx > n_total - 1) idx = n_total - 1;
          acc += (double)x[idx] * (f0[k] + (f1[k] - f0[k]) * ph_f);
        }
      }
      out[ch * n_out + o] = (float)acc;
    }
  }
}

// f32 -> s16 when EVERY sample lies exactly on the s16 grid (k / 32768,
// k in [-32768, 32767]) — true for 16-bit sources at unit gain.  Returns 1
// and fills dst on success, 0 at the first off-grid sample (dst then holds
// garbage).  One -O3 pass; the numpy equivalent needed several full-array
// temporaries (~20 s for a 1-hour stereo track on the build host).
int f32_to_s16_grid(const float *src, int64_t count, int16_t *dst) {
  for (int64_t i = 0; i < count; ++i) {
    const float y = src[i] * 32768.0f;  // exact: exponent shift
    // range-check BEFORE the cast: float->int of out-of-range/NaN is UB
    // (the !(...) form also rejects NaN)
    if (!(y >= -32768.0f && y <= 32767.0f)) return 0;
    const int32_t k = (int32_t)y;
    if ((float)k != y) return 0;
    dst[i] = (int16_t)k;
  }
  return 1;
}

void thesia_free(void *p) { std::free(p); }

}  // extern "C"
