// Native video decoder: libavformat/libavcodec demux+decode, libswscale
// conversion to RGB24. The decord-equivalent for this framework — probes
// container metadata and decodes exactly the requested (sorted or unsorted)
// frame indices. Sparse targets use av_seek_frame keyframe seeks to skip
// unneeded GOPs (an hour-long video sampled at 64 frames decodes ~64 GOPs,
// not ~90k frames); any timestamp uncertainty (missing pts, VFR rounding,
// failed seek) falls back to an exact sequential decode from frame 0.
//
// Exposed as a C ABI consumed by ctypes (open_o3_video_tpu/native/video_decoder.py).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct OpenedVideo {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  int stream_index = -1;

  ~OpenedVideo() {
    if (codec) avcodec_free_context(&codec);
    if (fmt) avformat_close_input(&fmt);
  }

  int open(const char* path) {
    if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return -1;
    if (avformat_find_stream_info(fmt, nullptr) < 0) return -2;
    stream_index =
        av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
    if (stream_index < 0) return -3;
    AVStream* stream = fmt->streams[stream_index];
    const AVCodec* dec = avcodec_find_decoder(stream->codecpar->codec_id);
    if (!dec) return -4;
    codec = avcodec_alloc_context3(dec);
    if (!codec) return -5;
    if (avcodec_parameters_to_context(codec, stream->codecpar) < 0) return -6;
    codec->thread_count = 0;  // auto
    if (avcodec_open2(codec, dec, nullptr) < 0) return -7;
    return 0;
  }

  AVStream* stream() const { return fmt->streams[stream_index]; }
};

// Count frames: prefer container metadata, estimate from duration otherwise.
int64_t count_frames(const OpenedVideo& v) {
  AVStream* s = v.stream();
  if (s->nb_frames > 0) return s->nb_frames;
  double fps = av_q2d(s->avg_frame_rate);
  if (fps <= 0) fps = av_q2d(s->r_frame_rate);
  double dur_sec = 0;
  if (s->duration != AV_NOPTS_VALUE)
    dur_sec = s->duration * av_q2d(s->time_base);
  else if (v.fmt->duration != AV_NOPTS_VALUE)
    dur_sec = static_cast<double>(v.fmt->duration) / AV_TIME_BASE;
  return static_cast<int64_t>(dur_sec * fps + 0.5);
}

double stream_fps(const OpenedVideo& v) {
  AVStream* s = v.stream();
  double fps = av_q2d(s->avg_frame_rate);
  if (fps <= 0) fps = av_q2d(s->r_frame_rate);
  return fps;
}

struct Converter {
  SwsContext* sws = nullptr;
  int width, height, flags;
  Converter(int w, int h, int interp)
      : width(w), height(h), flags(interp == 1 ? SWS_BICUBIC : SWS_BILINEAR) {}
  ~Converter() {
    if (sws) sws_freeContext(sws);
  }
  void operator()(AVFrame* f, uint8_t* dst) {
    sws = sws_getCachedContext(sws, f->width, f->height,
                               static_cast<AVPixelFormat>(f->format), width,
                               height, AV_PIX_FMT_RGB24, flags, nullptr,
                               nullptr, nullptr);
    uint8_t* dst_data[4] = {dst, nullptr, nullptr, nullptr};
    int dst_linesize[4] = {width * 3, 0, 0, 0};
    sws_scale(sws, f->data, f->linesize, 0, f->height, dst_data, dst_linesize);
  }
};

// Pump the demuxer until the decoder yields a frame.
// Returns 0 (frame filled), 1 (EOF), <0 (error).
int next_frame(OpenedVideo& v, AVPacket* pkt, AVFrame* frame) {
  while (true) {
    int ret = avcodec_receive_frame(v.codec, frame);
    if (ret == 0) return 0;
    if (ret == AVERROR_EOF) return 1;
    if (ret != AVERROR(EAGAIN)) return ret;
    ret = av_read_frame(v.fmt, pkt);
    if (ret < 0) {
      avcodec_send_packet(v.codec, nullptr);  // flush
      continue;
    }
    if (pkt->stream_index != v.stream_index) {
      av_packet_unref(pkt);
      continue;
    }
    avcodec_send_packet(v.codec, pkt);
    av_packet_unref(pkt);
  }
}

// Only seek when skipping more than this many frames — short hops decode
// faster than a seek + GOP re-decode.
constexpr int64_t kSeekGap = 128;

// Decode `sorted` (unique ascending) frame indices using keyframe seeks.
// Missing tail frames (truncated container) are left empty for the caller
// to pad. Returns 0 on success; nonzero requests the sequential fallback.
int decode_with_seeks(OpenedVideo& v, const std::vector<int64_t>& sorted,
                      std::vector<std::vector<uint8_t>>& decoded,
                      Converter& convert, size_t frame_bytes) {
  AVStream* s = v.stream();
  double fps = stream_fps(v);
  if (fps <= 0) return -1;
  double tb = av_q2d(s->time_base);
  if (tb <= 0) return -2;
  int64_t start_ts = s->start_time != AV_NOPTS_VALUE ? s->start_time : 0;

  AVFrame* frame = av_frame_alloc();
  AVPacket* pkt = av_packet_alloc();
  int rc = 0;
  // Index of the last decoded frame; -1 = at stream head, -2 = just sought
  // (unknown until a pts re-syncs it).
  int64_t cur_idx = -1;

  for (size_t ti = 0; ti < sorted.size() && rc == 0; ++ti) {
    const int64_t t = sorted[ti];
    if (cur_idx != -2 && t - cur_idx > kSeekGap) {
      int64_t ts = start_ts + static_cast<int64_t>(llround(t / fps / tb));
      if (av_seek_frame(v.fmt, v.stream_index, ts, AVSEEK_FLAG_BACKWARD) < 0) {
        rc = -3;
        break;
      }
      avcodec_flush_buffers(v.codec);
      cur_idx = -2;
    }
    while (rc == 0) {
      int r = next_frame(v, pkt, frame);
      if (r == 1) { rc = 1; break; }  // EOF: pad tail at the caller
      if (r < 0) { rc = -4; break; }
      int64_t idx;
      if (cur_idx == -2) {
        int64_t bts = frame->best_effort_timestamp;
        if (bts == AV_NOPTS_VALUE) {
          av_frame_unref(frame);
          rc = -5;  // cannot re-sync without timestamps
          break;
        }
        idx = static_cast<int64_t>(llround((bts - start_ts) * tb * fps));
      } else {
        idx = cur_idx + 1;
      }
      cur_idx = idx;
      if (idx == t) {
        decoded[ti].resize(frame_bytes);
        convert(frame, decoded[ti].data());
        av_frame_unref(frame);
        break;
      }
      if (idx > t) {
        av_frame_unref(frame);
        rc = -6;  // overshot (VFR / rounding): sequential is exact
        break;
      }
      av_frame_unref(frame);
    }
    if (rc == 1) { rc = 0; break; }  // EOF is success with a padded tail
  }

  av_packet_free(&pkt);
  av_frame_free(&frame);
  return rc;
}

// Exact sequential decode from frame 0, counting frames in decode order.
int decode_sequential(OpenedVideo& v, const std::vector<int64_t>& sorted,
                      std::vector<std::vector<uint8_t>>& decoded,
                      Converter& convert, size_t frame_bytes) {
  AVFrame* frame = av_frame_alloc();
  AVPacket* pkt = av_packet_alloc();
  int64_t frame_counter = 0;
  size_t next_target = 0;

  while (next_target < sorted.size()) {
    int r = next_frame(v, pkt, frame);
    if (r != 0) break;  // EOF or error: pad tail at the caller
    if (frame_counter == sorted[next_target]) {
      decoded[next_target].resize(frame_bytes);
      convert(frame, decoded[next_target].data());
      ++next_target;
    }
    ++frame_counter;
    av_frame_unref(frame);
  }

  av_packet_free(&pkt);
  av_frame_free(&frame);
  return 0;
}

}  // namespace

extern "C" {

// Probe container metadata. Returns 0 on success.
int o3v_probe(const char* path, int64_t* num_frames, double* fps, int* width,
              int* height) {
  OpenedVideo v;
  int rc = v.open(path);
  if (rc != 0) return rc;
  *num_frames = count_frames(v);
  *fps = stream_fps(v);
  *width = v.codec->width;
  *height = v.codec->height;
  return 0;
}

// Decode the given frame indices to RGB24 into `out` with shape
// (n_indices, height, width, 3), scaling to (width, height) with the given
// swscale interpolation (0 = bilinear, 1 = bicubic — used to fuse the model
// resize into decode). Indices may repeat and arrive unsorted. Returns 0 on
// success; pads with the last decoded frame when the stream ends early
// (tolerating truncated containers).
int o3v_decode_frames_scaled(const char* path, const int64_t* indices,
                             int64_t n_indices, uint8_t* out, int width,
                             int height, int interp) {
  std::vector<int64_t> sorted(indices, indices + n_indices);
  std::sort(sorted.begin(), sorted.end());
  sorted.erase(std::unique(sorted.begin(), sorted.end()), sorted.end());

  const size_t frame_bytes = static_cast<size_t>(width) * height * 3;
  std::vector<std::vector<uint8_t>> decoded(sorted.size());

  {
    OpenedVideo v;
    int rc = v.open(path);
    if (rc != 0) return rc;
    Converter convert(width, height, interp);
    if (decode_with_seeks(v, sorted, decoded, convert, frame_bytes) != 0) {
      // Seeking unusable for this file: reopen and decode sequentially.
      for (auto& d : decoded) d.clear();
      OpenedVideo v2;
      rc = v2.open(path);
      if (rc != 0) return rc;
      Converter convert2(width, height, interp);
      decode_sequential(v2, sorted, decoded, convert2, frame_bytes);
    }
  }

  // Pad any undecoded targets with the nearest decoded frame.
  int last_ok = -1;
  for (size_t i = 0; i < decoded.size(); ++i) {
    if (!decoded[i].empty()) last_ok = static_cast<int>(i);
  }
  if (last_ok < 0) return -100;  // nothing decoded
  for (size_t i = 0; i < decoded.size(); ++i) {
    if (decoded[i].empty()) decoded[i] = decoded[last_ok];
  }

  // Scatter to output rows in the caller's order.
  for (int64_t row = 0; row < n_indices; ++row) {
    auto it = std::lower_bound(sorted.begin(), sorted.end(), indices[row]);
    size_t pos = static_cast<size_t>(it - sorted.begin());
    std::memcpy(out + row * frame_bytes, decoded[pos].data(), frame_bytes);
  }
  return 0;
}

// Back-compat entry: decode at native size, bilinear conversion.
int o3v_decode_frames(const char* path, const int64_t* indices,
                      int64_t n_indices, uint8_t* out, int width, int height) {
  return o3v_decode_frames_scaled(path, indices, n_indices, out, width,
                                  height, 0);
}

}  // extern "C"
