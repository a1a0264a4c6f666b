// Host copy of thesia_tpu/native/src/ffmpeg_decode.cpp (verbatim apart from this line).
// Audio decode via the system ffmpeg libraries (libavformat/libavcodec).
//
// This is the codec substrate for formats beyond WAV/FLAC (mp3, aac, alac,
// ogg/vorbis, opus, ...) — the same role the symphonia crate plays for the
// reference (reference: src-tauri/src/core/audio.rs:262-439).  Mirrors the
// reference's decode-loop behaviors: skip undecodable packets, tolerate
// parameter changes mid-stream, fail only when nothing decodable exists.
//
// C ABI, loaded via ctypes.  Built separately from libthesia_native.so so the
// core library has no ffmpeg dependency.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
}

namespace {

void append_frame(std::vector<std::vector<float>> &planes, const AVFrame *fr) {
  const int n_ch = fr->ch_layout.nb_channels;
  const int n = fr->nb_samples;
  if ((int)planes.size() < n_ch) planes.resize(n_ch);
  const AVSampleFormat fmt = (AVSampleFormat)fr->format;
  const bool planar = av_sample_fmt_is_planar(fmt);
  const AVSampleFormat base = av_get_packed_sample_fmt(fmt);

  auto sample = [&](int ch, int i) -> float {
    // extended_data, NOT data: AVFrame::data holds only 8 pointers, and
    // planar audio with more channels (e.g. multichannel Opus) stores the
    // rest exclusively in extended_data — fr->data[ch] would read past the
    // array into unrelated fields
    const uint8_t *data = planar ? fr->extended_data[ch] : fr->extended_data[0];
    const int idx = planar ? i : i * n_ch + ch;
    switch (base) {
      case AV_SAMPLE_FMT_U8:
        return ((int)((const uint8_t *)data)[idx] - 128) / 128.0f;
      case AV_SAMPLE_FMT_S16:
        return ((const int16_t *)data)[idx] / 32768.0f;
      case AV_SAMPLE_FMT_S32:
        return (float)(((const int32_t *)data)[idx] / 2147483648.0);
      case AV_SAMPLE_FMT_S64:
        return (float)(((const int64_t *)data)[idx] / 9223372036854775808.0);
      case AV_SAMPLE_FMT_FLT:
        return ((const float *)data)[idx];
      case AV_SAMPLE_FMT_DBL:
        return (float)((const double *)data)[idx];
      default:
        return 0.0f;
    }
  };
  for (int c = 0; c < n_ch; ++c) {
    auto &p = planes[c];
    const size_t off = p.size();
    p.resize(off + n);
    for (int i = 0; i < n; ++i) p[off + i] = sample(c, i);
  }
}

}  // namespace

extern "C" {

// Returns 0 on success.  out: planar f32 (n_ch, n) via malloc (free with
// thesia_ffmpeg_free).  codec/format names copied into fixed buffers.
int ffmpeg_decode(const char *path, float **out, uint32_t *sr_out,
                  uint32_t *n_ch_out, uint64_t *n_out, char *codec_name,
                  int codec_name_cap, char *format_name, int format_name_cap,
                  int32_t *bits_per_sample, int64_t *bit_rate,
                  uint64_t *total_packet_bytes) {
  AVFormatContext *fmt_ctx = nullptr;
  if (avformat_open_input(&fmt_ctx, path, nullptr, nullptr) < 0) return 1;
  if (avformat_find_stream_info(fmt_ctx, nullptr) < 0) {
    avformat_close_input(&fmt_ctx);
    return 2;
  }
  const AVCodec *codec = nullptr;
  const int stream_idx =
      av_find_best_stream(fmt_ctx, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
  if (stream_idx < 0 || !codec) {
    avformat_close_input(&fmt_ctx);
    return 3;
  }
  AVStream *stream = fmt_ctx->streams[stream_idx];
  AVCodecContext *cctx = avcodec_alloc_context3(codec);
  if (!cctx || avcodec_parameters_to_context(cctx, stream->codecpar) < 0 ||
      avcodec_open2(cctx, codec, nullptr) < 0) {
    if (cctx) avcodec_free_context(&cctx);
    avformat_close_input(&fmt_ctx);
    return 4;
  }

  std::vector<std::vector<float>> planes;
  uint32_t sr = cctx->sample_rate;
  uint64_t pkt_bytes = 0;
  AVPacket *pkt = av_packet_alloc();
  AVFrame *frame = av_frame_alloc();
  if (!pkt || !frame) {
    if (pkt) av_packet_free(&pkt);
    if (frame) av_frame_free(&frame);
    avcodec_free_context(&cctx);
    avformat_close_input(&fmt_ctx);
    return 4;
  }
  while (av_read_frame(fmt_ctx, pkt) >= 0) {
    if (pkt->stream_index == stream_idx) {
      pkt_bytes += pkt->size;
      if (avcodec_send_packet(cctx, pkt) >= 0) {
        while (avcodec_receive_frame(cctx, frame) >= 0) {
          if (frame->sample_rate) sr = frame->sample_rate;
          append_frame(planes, frame);
        }
      }
      // decode errors on individual packets are skipped (reference:
      // audio.rs:393-404)
    }
    av_packet_unref(pkt);
  }
  // flush
  avcodec_send_packet(cctx, nullptr);
  while (avcodec_receive_frame(cctx, frame) >= 0) append_frame(planes, frame);

  int rc = 0;
  const uint32_t n_ch = (uint32_t)planes.size();
  if (n_ch == 0 || planes[0].empty()) {
    rc = 5;
  } else {
    const uint64_t n = planes[0].size();
    float *buf = (float *)std::malloc(sizeof(float) * n * n_ch);
    if (!buf) {
      rc = 6;
    } else {
      for (uint32_t c = 0; c < n_ch; ++c) {
        const uint64_t len = std::min<uint64_t>(planes[c].size(), n);
        std::memcpy(buf + (size_t)c * n, planes[c].data(), sizeof(float) * len);
        if (len < n)
          std::memset(buf + (size_t)c * n + len, 0, sizeof(float) * (n - len));
      }
      *out = buf;
      *sr_out = sr;
      *n_ch_out = n_ch;
      *n_out = n;
      std::snprintf(codec_name, codec_name_cap, "%s", codec->name);
      std::snprintf(format_name, format_name_cap, "%s",
                    fmt_ctx->iformat && fmt_ctx->iformat->name
                        ? fmt_ctx->iformat->name
                        : "");
      *bits_per_sample = stream->codecpar->bits_per_raw_sample
                             ? stream->codecpar->bits_per_raw_sample
                             : stream->codecpar->bits_per_coded_sample;
      *bit_rate = stream->codecpar->bit_rate;
      *total_packet_bytes = pkt_bytes;
    }
  }
  av_frame_free(&frame);
  av_packet_free(&pkt);
  avcodec_free_context(&cctx);
  avformat_close_input(&fmt_ctx);
  return rc;
}

void thesia_ffmpeg_free(void *p) { std::free(p); }

}  // extern "C"
