// mv_encoder: minimal libx264 encoder (C ABI) at the reference's operating
// point — keyint=1000, multi-ref, p8x8/p4x4 partitions
// (the C++ reference's README.md:47-69: `-preset fast -tune film
// -x264-params partitions=p8x8,p4x4,i8x8:keyint=1000:me=umh:merange=64:
// subme=6:bframes=0:ref=N`). The reference encodes on a separate host with
// the ffmpeg CLI; this helper exists so the decoder's MV-chain semantics can
// be differential-tested against REAL H.264 streams (not just synthetic
// records) without an ffmpeg binary in the image.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
}

extern "C" {

// Encode n gray frames (h*w each, concatenated) to an H.264 file at the
// reference operating point. refs: number of reference frames (1..4).
// bframes: consecutive B-frames (0 = the published operating point;
// nonzero exercises the decoder's B-frame branch). cavlc != 0 encodes with
// CAVLC entropy coding (cabac=0) — required for the h264_refidx sidecar
// parser to recover per-block reference indices with stock libavcodec.
// Returns 0 on success.
int mvenc_encode_gray2(const char* path, const uint8_t* frames, int w, int h,
                       int n, double fps, int keyint, int refs, int bframes,
                       int cavlc) {
  const AVCodec* codec = avcodec_find_encoder_by_name("libx264");
  if (!codec) return -1;

  AVFormatContext* fmt = nullptr;
  if (avformat_alloc_output_context2(&fmt, nullptr, nullptr, path) < 0 || !fmt)
    return -2;
  AVStream* st = avformat_new_stream(fmt, nullptr);
  if (!st) return -3;

  AVCodecContext* c = avcodec_alloc_context3(codec);
  c->width = w;
  c->height = h;
  c->pix_fmt = AV_PIX_FMT_YUV420P;
  c->time_base = AVRational{1, (int)fps};
  st->time_base = c->time_base;
  c->gop_size = keyint;
  c->max_b_frames = bframes;
  c->refs = refs;
  av_opt_set(c->priv_data, "preset", "fast", 0);
  av_opt_set(c->priv_data, "tune", "film", 0);
  char params[256];
  snprintf(params, sizeof(params),
           "partitions=p8x8,p4x4,i8x8:keyint=%d:me=umh:merange=64:subme=6:"
           "bframes=%d:ref=%d:scenecut=0%s",
           keyint, bframes, refs, cavlc ? ":cabac=0:weightp=0" : "");
  av_opt_set(c->priv_data, "x264-params", params, 0);
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
    c->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;

  if (avcodec_open2(c, codec, nullptr) < 0) return -4;
  avcodec_parameters_from_context(st->codecpar, c);
  if (!(fmt->oformat->flags & AVFMT_NOFILE)) {
    if (avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0) return -5;
  }
  if (avformat_write_header(fmt, nullptr) < 0) return -6;

  AVFrame* fr = av_frame_alloc();
  fr->format = c->pix_fmt;
  fr->width = w;
  fr->height = h;
  av_frame_get_buffer(fr, 0);
  AVPacket* pkt = av_packet_alloc();

  auto flush = [&](AVPacket* p) {
    while (avcodec_receive_packet(c, p) >= 0) {
      av_packet_rescale_ts(p, c->time_base, st->time_base);
      p->stream_index = st->index;
      av_interleaved_write_frame(fmt, p);
      av_packet_unref(p);
    }
  };

  for (int i = 0; i < n; ++i) {
    av_frame_make_writable(fr);
    const uint8_t* src = frames + (size_t)i * w * h;
    for (int y = 0; y < h; ++y)
      memcpy(fr->data[0] + y * fr->linesize[0], src + y * w, w);
    for (int y = 0; y < h / 2; ++y) {
      memset(fr->data[1] + y * fr->linesize[1], 128, w / 2);
      memset(fr->data[2] + y * fr->linesize[2], 128, w / 2);
    }
    fr->pts = i;
    if (avcodec_send_frame(c, fr) < 0) return -7;
    flush(pkt);
  }
  avcodec_send_frame(c, nullptr);
  flush(pkt);
  av_write_trailer(fmt);

  av_packet_free(&pkt);
  av_frame_free(&fr);
  avcodec_free_context(&c);
  if (!(fmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&fmt->pb);
  avformat_free_context(fmt);
  return 0;
}

int mvenc_encode_gray(const char* path, const uint8_t* frames, int w, int h,
                      int n, double fps, int keyint, int refs, int bframes) {
  return mvenc_encode_gray2(path, frames, w, h, n, fps, keyint, refs, bframes,
                            0);
}

}  // extern "C"
