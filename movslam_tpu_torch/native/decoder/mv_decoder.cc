// mv_decoder: H.264 motion-vector harvesting decoder (C ABI for ctypes).
//
// Native equivalent of the reference's VideoDecoder
// (the C++ reference's src/VideoDecoder.cc): opens a file / MPEG-TS / tcp://
// stream with motion-vector export enabled, maintains a lookahead queue, and
// converts per-macroblock motion vectors into
//   - per-hop deltas (dst - src) / (ref + 1),
//   - clamped inclusive source rectangles (what the reference stamped into
//     its per-pixel `mvi` index image — the TPU side replaces that with a
//     batched point-in-rect join),
//   - destination keypoint blocks with back-pointers (dIndx),
//   - frame MV coverage.
//
// Multi-ref decomposition (VideoDecoder.cc:220-348): an MV with reference
// index ref = k spans k+1 frames; its per-hop delta is (dst - src)/(k+1).
// Hop j (j = k+1..1) produces a source rectangle at dst - j*delta, assigned
// to the frame j-1 slots back in the lookahead queue; the new-track keypoint
// block is placed at the SOURCE position in the frame the chain starts at
// (k+1 back). Stock FFmpeg's AVMotionVector carries no reference-frame index
// (the reference patches FFmpeg to add `int32_t ref`,
// the C++ reference's ffmpeg-ref-patch.patch:122-129); build with -DMV_REF_FIELD
// against a patched libavcodec to enable the field. Unpatched builds treat
// every MV as ref=0 (exact for streams encoded with ref=1, e.g. the
// TartanAir mono operating point). The decomposition itself is exercised
// either way through the mvdec_test_decompose test ABI below.
//
// B-frames (mv.source > 0): the reference collects forward-prediction
// records into `bmap` (VideoDecoder.cc:255-286). bmap is write-only there
// (nothing ever reads it; grep: single reference at VideoDecoder.cc:284) and
// the published encoder settings use bframes=0 (the C++ reference's README.md:47)
// — but the branch exists, so this decoder keeps structural parity: forward
// -prediction records are collected per frame into `bmv_*` arrays and
// exposed through the view (consumers may ignore them, exactly as the
// reference does), and B pictures are classified ft=2.
//
// Build: see build.sh (g++ -shared, links libavformat/avcodec/avutil/swscale).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <string>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/motion_vector.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

#include "h264_refidx.h"

namespace {

// Capacities sized for the published encoder operating point: partitions
// p8x8+p4x4 on 640x480 can emit 80*60 = 4800 8x8 blocks (more with 4x4
// sub-partitions); multi-ref chains multiply records. Drops are COUNTED and
// surfaced to Python (no silent caps).
constexpr int kMaxMvs = 16384;
constexpr int kMaxKps = 8192;

struct QueuedFrame {
  int32_t frame_no = 0;
  int32_t ft = 1;  // 0=I, 1=P, 2=B
  double timestamp = 0.0;
  float coverage = 0.f;
  std::vector<uint8_t> gray;
  std::vector<float> mv_delta;   // n_mvs * 2
  std::vector<float> mv_rect;    // n_mvs * 4 (x0, y0, x1, y1 inclusive)
  std::vector<int32_t> mv_dindx; // n_mvs
  std::vector<float> kps_rect;   // n_kps * 4 (x, y, w, h)
  std::vector<uint8_t> rgb;      // optional H*W*3 surface (VideoBase.h:60-68)
  std::vector<float> bmv_delta;  // n_bmvs * 2 — B-frame forward records
  std::vector<float> bmv_rect;   // n_bmvs * 4   (the reference's bmap,
  int32_t n_bmvs = 0;            //  VideoDecoder.cc:255-286)
  int32_t n_mvs = 0;
  int32_t n_kps = 0;
  int32_t mv_dropped = 0;
  int32_t kp_dropped = 0;

  void add_kp(float x, float y, float w, float h, int32_t* out_idx) {
    *out_idx = -1;
    if (n_kps >= kMaxKps) {
      ++kp_dropped;
      return;
    }
    kps_rect.insert(kps_rect.end(), {x, y, w, h});
    *out_idx = n_kps++;
  }
  void add_mv(float dx, float dy, float x0, float y0, float x1, float y1,
              int32_t dindx) {
    if (n_mvs >= kMaxMvs) {
      ++mv_dropped;
      return;
    }
    mv_delta.insert(mv_delta.end(), {dx, dy});
    mv_rect.insert(mv_rect.end(), {x0, y0, x1, y1});
    mv_dindx.push_back(dindx);
    ++n_mvs;
  }
};

// One motion vector's fields, decoupled from AVMotionVector so the
// decomposition is testable without a patched FFmpeg.
struct MvIn {
  int32_t source;
  float w, h;
  float src_x, src_y;
  float dst_x, dst_y;
  int32_t ref;
};

// The exact reference decomposition (VideoDecoder.cc:211-348). `queue` holds
// the lookahead frames OLDEST FIRST (the current frame is NOT in it yet);
// `cur` is the frame being decoded. Returns the dst-block area added to
// coverage (0 when the MV was dropped or is a forward/B ref).
float decompose_mv(const MvIn& mv, std::deque<std::unique_ptr<QueuedFrame>>& queue,
                   QueuedFrame* cur, float W, float H) {
  if (mv.source > 0) {
    // B-frame forward prediction (VideoDecoder.cc:255-286): record the
    // destination block + forward delta into the frame's bmap-equivalent.
    // Nothing downstream consumes these (the reference's bmap is write-only
    // too); they ride the view for parity/inspection.
    if (cur->n_bmvs < kMaxMvs) {
      const float hw = mv.w / 2, hh = mv.h / 2;
      float x0 = mv.dst_x - hw, y0 = mv.dst_y - hh;
      if (x0 < 0) x0 = 0;
      if (y0 < 0) y0 = 0;
      float x1 = mv.dst_x + hw, y1 = mv.dst_y + hh;
      if (x1 >= W) x1 = W - 1;
      if (y1 >= H) y1 = H - 1;
      cur->bmv_delta.insert(cur->bmv_delta.end(),
                            {mv.dst_x - mv.src_x, mv.dst_y - mv.src_y});
      cur->bmv_rect.insert(cur->bmv_rect.end(), {x0, y0, x1, y1});
      ++cur->n_bmvs;
    }
    return 0.f;
  }

  const float mb_w = mv.w, mb_h = mv.h;
  const float half_w = mb_w / 2, half_h = mb_h / 2;
  const int ref = mv.ref;
  float dx = (mv.dst_x - mv.src_x) / (float)(ref + 1);
  float dy = (mv.dst_y - mv.src_y) / (float)(ref + 1);

  // Keypoint block: at the CHAIN START — the source position for multi-ref
  // MVs (placed on the frame the chain begins at), the destination for
  // single-hop (VideoDecoder.cc:227-253).
  const bool multi = ref > 0;
  float kp_x = multi ? mv.src_x : mv.dst_x;
  float kp_y = multi ? mv.src_y : mv.dst_y;
  float d_x0 = kp_x - half_w, d_y0 = kp_y - half_h;
  if (d_x0 < 0) d_x0 = 0;
  if (d_y0 < 0) d_y0 = 0;
  if (kp_x + half_w >= W || kp_y + half_h >= H) return 0.f;

  int32_t dindx = -1;
  if (multi) {
    // vqueue[(size-1) - ref] = the frame ref+1 hops back (the current frame
    // is not queued yet). Skip when the chain starts before the queue.
    if ((size_t)ref < queue.size()) {
      int32_t unused;
      queue[queue.size() - 1 - (size_t)ref]->add_kp(d_x0, d_y0, mb_w, mb_h,
                                                    &unused);
    }
  } else {
    cur->add_kp(d_x0, d_y0, mb_w, mb_h, &dindx);
  }

  // Per-hop source rectangles assigned backwards over the queue
  // (VideoDecoder.cc:287-346): hop j lands on the frame j-1 slots back.
  for (int j = ref + 1; j > 0; --j) {
    float src_x = mv.dst_x - dx * j;
    float src_y = mv.dst_y - dy * j;
    float s_x0 = src_x - half_w, s_y0 = src_y - half_h;
    if (s_x0 < 0) s_x0 = 0;
    if (s_y0 < 0) s_y0 = 0;
    float s_x1 = src_x + half_w, s_y1 = src_y + half_h;
    if (s_x1 >= W) s_x1 = W - 1;
    if (s_y1 >= H) s_y1 = H - 1;

    QueuedFrame* target;
    if (j == 1) {
      target = cur;
    } else {
      if ((size_t)(j - 1) > queue.size()) continue;
      target = queue[queue.size() - (size_t)(j - 1)].get();
    }
    // dIndx = -1 for every hop of a multi-ref MV (reference sets dIndx only
    // in the single-hop branch, VideoDecoder.cc:244-253).
    target->add_mv(dx, dy, s_x0, s_y0, s_x1, s_y1, dindx);
  }
  return mb_w * mb_h;  // coverage counts every P-frame MV's dst area
}

}  // namespace

extern "C" {

// Flat frame view handed to Python; buffers owned by the decoder and valid
// until the next mvdec_next / mvdec_close call.
typedef struct {
  int32_t width, height, frame_no, ft;
  double timestamp;
  float coverage;
  const uint8_t* gray;
  int32_t n_mvs, n_kps;
  const float* mv_delta;
  const float* mv_rect;
  const int32_t* mv_dindx;
  const float* kps_rect;
  int32_t mv_dropped, kp_dropped;
  const uint8_t* rgb;  // H*W*3 or null (enable with mvdec_set_rgb)
  int32_t n_bmvs;      // B-frame forward records (reference bmap parity)
  const float* bmv_delta;
  const float* bmv_rect;
} MvFrameView;

struct MvDecoder {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  AVPacket* packet = nullptr;
  AVFrame* frame = nullptr;
  SwsContext* sws = nullptr;
  SwsContext* sws_rgb = nullptr;
  bool want_rgb = false;
  int stream_index = -1;
  int width = 0, height = 0;
  double fps = 30.0;
  int frames = 0;
  size_t qlen = 12;
  bool eof = false;
  std::deque<std::unique_ptr<QueuedFrame>> queue;
  std::unique_ptr<QueuedFrame> current;  // last popped (buffers alive)
  MvFrameView view{};
  char err[256] = {0};
  // CAVLC ref-index sidecar parser (h264_refidx.cc): recovers the per-block
  // reference index the reference gets from its FFmpeg patch. Null for
  // non-H.264 streams; disables itself on CABAC/interlace/B-frames.
  RefIdxParser* refp = nullptr;
};

static void set_err(MvDecoder* d, const char* msg) {
  snprintf(d->err, sizeof(d->err), "%s", msg);
}

MvDecoder* mvdec_open(const char* url, int qlen) {
  auto d = new MvDecoder();
  d->qlen = qlen > 0 ? (size_t)qlen : 12;
  avformat_network_init();

  if (avformat_open_input(&d->fmt, url, nullptr, nullptr) < 0) {
    set_err(d, "failed to open input");
    return d;
  }
  if (avformat_find_stream_info(d->fmt, nullptr) < 0) {
    set_err(d, "failed to find stream info");
    return d;
  }
  const AVCodec* dec = nullptr;
  d->stream_index =
      av_find_best_stream(d->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &dec, 0);
  if (d->stream_index < 0 || !dec) {
    set_err(d, "no video stream");
    return d;
  }
  AVStream* st = d->fmt->streams[d->stream_index];
  d->codec = avcodec_alloc_context3(dec);
  avcodec_parameters_to_context(d->codec, st->codecpar);
  // Export motion vectors from the decoder (VideoDecoder.cc:52).
  AVDictionary* opts = nullptr;
  av_dict_set(&opts, "flags2", "+export_mvs", 0);
  if (avcodec_open2(d->codec, dec, &opts) < 0) {
    set_err(d, "failed to open codec");
    av_dict_free(&opts);
    return d;
  }
  av_dict_free(&opts);
  if (st->codecpar->codec_id == AV_CODEC_ID_H264) {
    d->refp = refidx_create();
    if (st->codecpar->extradata && st->codecpar->extradata_size > 6 &&
        st->codecpar->extradata[0] == 1)
      refidx_set_avcc(d->refp, st->codecpar->extradata,
                      st->codecpar->extradata_size);
  }
  d->width = d->codec->width;
  d->height = d->codec->height;
  if (st->avg_frame_rate.den > 0)
    d->fps = av_q2d(st->avg_frame_rate);
  d->packet = av_packet_alloc();
  d->frame = av_frame_alloc();
  return d;
}

const char* mvdec_error(MvDecoder* d) { return d->err[0] ? d->err : nullptr; }
// Enable the RGB frame surface (avframeToCvmatRGB, VideoBase.h:60-68);
// call before the first mvdec_next.
void mvdec_set_rgb(MvDecoder* d, int enable) { d->want_rgb = enable != 0; }
int mvdec_width(MvDecoder* d) { return d->width; }
int mvdec_height(MvDecoder* d) { return d->height; }
double mvdec_fps(MvDecoder* d) { return d->fps; }

static void to_gray(MvDecoder* d, AVFrame* f, std::vector<uint8_t>& out) {
  out.resize((size_t)d->width * d->height);
  d->sws = sws_getCachedContext(d->sws, f->width, f->height,
                                (AVPixelFormat)f->format, d->width, d->height,
                                AV_PIX_FMT_GRAY8, SWS_BILINEAR, nullptr,
                                nullptr, nullptr);
  uint8_t* dst[1] = {out.data()};
  int dst_stride[1] = {d->width};
  sws_scale(d->sws, f->data, f->linesize, 0, f->height, dst, dst_stride);
}

static void to_rgb(MvDecoder* d, AVFrame* f, std::vector<uint8_t>& out) {
  out.resize((size_t)d->width * d->height * 3);
  d->sws_rgb = sws_getCachedContext(
      d->sws_rgb, f->width, f->height, (AVPixelFormat)f->format, d->width,
      d->height, AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr, nullptr, nullptr);
  uint8_t* dst[1] = {out.data()};
  int dst_stride[1] = {d->width * 3};
  sws_scale(d->sws_rgb, f->data, f->linesize, 0, f->height, dst, dst_stride);
}

// Convert one decoded AVFrame's MV side data into chain records distributed
// over the lookahead queue (VideoDecoder.cc:194-350 semantics).
static void process_frame(MvDecoder* d, AVFrame* f) {
  auto qf = std::make_unique<QueuedFrame>();
  qf->frame_no = ++d->frames;
  qf->ft = (f->pict_type == AV_PICTURE_TYPE_I)   ? 0
           : (f->pict_type == AV_PICTURE_TYPE_B) ? 2
                                                 : 1;
  qf->timestamp =
      f->pts != AV_NOPTS_VALUE
          ? f->pts * av_q2d(d->fmt->streams[d->stream_index]->time_base)
          : (d->frames - 1) / d->fps;
  to_gray(d, f, qf->gray);
  if (d->want_rgb) to_rgb(d, f, qf->rgb);

  AVFrameSideData* sd =
      av_frame_get_side_data(f, AV_FRAME_DATA_MOTION_VECTORS);
  if (sd) {
    const int n = sd->size / sizeof(AVMotionVector);
    const auto* mvs = (const AVMotionVector*)sd->data;
    float coverage = 0.f;
    const float W = d->width, H = d->height;

    // Per-8x8-block reference indices recovered by the CAVLC sidecar parser
    // (h264_refidx.cc), keyed by the frame's pts. Equivalent to the
    // reference's patched AVMotionVector.ref export
    // (ffmpeg-ref-patch.patch:122-129 reads ref_index[dir][4*mb_xy+i]).
    const int8_t* refmap = nullptr;
    int mb_w = 0, mb_h = 0;
    if (d->refp) {
      int64_t key = f->pts != AV_NOPTS_VALUE ? f->pts : f->pkt_dts;
      refmap = refidx_get(d->refp, key, &mb_w, &mb_h);
      if (refmap) refidx_gc(d->refp, key);  // decode order == pts order here
    }

    for (int i = 0; i < n; ++i) {
      const AVMotionVector& av = mvs[i];
      MvIn mv;
      mv.source = av.source;
      mv.w = av.w;
      mv.h = av.h;
      mv.src_x = av.src_x;
      mv.src_y = av.src_y;
      mv.dst_x = av.dst_x;
      mv.dst_y = av.dst_y;
#ifdef MV_REF_FIELD
      mv.ref = av.ref;  // patched FFmpeg (ffmpeg-ref-patch.patch:122-129)
#else
      mv.ref = 0;  // stock FFmpeg fallback (exact for ref=1 encodes)
      if (refmap && av.source < 0) {
        // The export emits one vector per partition with the block CENTER at
        // (dst_x, dst_y) (mpegutils.c add_mb): recover mb + 8x8 sub-index.
        int mbx = av.dst_x >> 4, mby = av.dst_y >> 4;
        if (mbx >= 0 && mby >= 0 && mbx < mb_w && mby < mb_h) {
          int sub = ((av.dst_x & 15) >= 8 ? 1 : 0) +
                    ((av.dst_y & 15) >= 8 ? 2 : 0);
          int8_t r = refmap[(mby * mb_w + mbx) * 4 + sub];
          if (r > 0) mv.ref = r;
        }
      }
#endif
      coverage += decompose_mv(mv, d->queue, qf.get(), W, H);
    }
    qf->coverage = coverage / (W * H);
  }
  d->queue.push_back(std::move(qf));
}

// Pull decoded frames until the lookahead queue is full or EOF, then pop the
// oldest (VideoDecoder.cc:161-370). Returns nullptr at end of stream.
const MvFrameView* mvdec_next(MvDecoder* d) {
  if (!d->codec) return nullptr;
  while (!d->eof && d->queue.size() < d->qlen) {
    int r = av_read_frame(d->fmt, d->packet);
    if (r < 0) {
      // flush
      avcodec_send_packet(d->codec, nullptr);
      while (avcodec_receive_frame(d->codec, d->frame) >= 0)
        process_frame(d, d->frame);
      d->eof = true;
      break;
    }
    if (d->packet->stream_index == d->stream_index) {
      if (d->refp && refidx_ok(d->refp)) {
        int64_t key = d->packet->pts != AV_NOPTS_VALUE ? d->packet->pts
                                                       : d->packet->dts;
        refidx_feed(d->refp, d->packet->data, d->packet->size, key);
      }
      if (avcodec_send_packet(d->codec, d->packet) >= 0) {
        while (avcodec_receive_frame(d->codec, d->frame) >= 0)
          process_frame(d, d->frame);
      }
    }
    av_packet_unref(d->packet);
  }
  if (d->queue.empty()) return nullptr;
  d->current = std::move(d->queue.front());
  d->queue.pop_front();

  QueuedFrame* q = d->current.get();
  d->view = MvFrameView{
      d->width,
      d->height,
      q->frame_no,
      q->ft,
      q->timestamp,
      q->coverage,
      q->gray.data(),
      q->n_mvs,
      q->n_kps,
      q->mv_delta.data(),
      q->mv_rect.data(),
      q->mv_dindx.data(),
      q->kps_rect.data(),
      q->mv_dropped,
      q->kp_dropped,
      q->rgb.empty() ? nullptr : q->rgb.data(),
      q->n_bmvs,
      q->bmv_delta.data(),
      q->bmv_rect.data(),
  };
  return &d->view;
}

void mvdec_close(MvDecoder* d) {
  if (!d) return;
  if (d->refp) refidx_destroy(d->refp);
  if (d->sws) sws_freeContext(d->sws);
  if (d->sws_rgb) sws_freeContext(d->sws_rgb);
  if (d->frame) av_frame_free(&d->frame);
  if (d->packet) av_packet_free(&d->packet);
  if (d->codec) avcodec_free_context(&d->codec);
  if (d->fmt) avformat_close_input(&d->fmt);
  delete d;
}

// ---------------------------------------------------------------------------
// Test ABI: demux a file and run ONLY the CAVLC ref-index parser over its
// packets (no decode). For each access unit writes 12 int32s into `out`:
//   [parsed, mb_w*mb_h, n_intra_blocks, hist_ref0..hist_ref7, overflow]
// where hist_refK counts 8x8 blocks whose recovered value is hops-1 == K.
// Returns the number of access units scanned (<= cap), or negative on open
// failure. Lets tests assert the parser consumed every P slice exactly and
// that multi-ref encodes really produce ref>0 blocks.
extern "C" int mvdec_refidx_scan(const char* url, int32_t* out, int cap) {
  AVFormatContext* fmt = nullptr;
  if (avformat_open_input(&fmt, url, nullptr, nullptr) < 0) return -1;
  if (avformat_find_stream_info(fmt, nullptr) < 0) {
    avformat_close_input(&fmt);
    return -2;
  }
  int si = av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
  if (si < 0) {
    avformat_close_input(&fmt);
    return -3;
  }
  RefIdxParser* rp = refidx_create();
  AVCodecParameters* par = fmt->streams[si]->codecpar;
  if (par->extradata && par->extradata_size > 6 && par->extradata[0] == 1)
    refidx_set_avcc(rp, par->extradata, par->extradata_size);

  AVPacket* pkt = av_packet_alloc();
  int n = 0;
  while (n < cap && av_read_frame(fmt, pkt) >= 0) {
    if (pkt->stream_index == si) {
      int64_t key = pkt->pts != AV_NOPTS_VALUE ? pkt->pts : pkt->dts;
      int parsed = refidx_feed(rp, pkt->data, pkt->size, key);
      int32_t* row = out + (size_t)n * 12;
      memset(row, 0, 12 * sizeof(int32_t));
      row[0] = parsed;
      if (parsed) {
        int mb_w = 0, mb_h = 0;
        const int8_t* map = refidx_get(rp, key, &mb_w, &mb_h);
        row[1] = mb_w * mb_h;
        if (map) {
          for (int i = 0; i < mb_w * mb_h * 4; ++i) {
            int8_t r = map[i];
            if (r < 0)
              ++row[2];
            else if (r < 8)
              ++row[3 + r];
            else
              ++row[11];
          }
        }
      }
      ++n;
    }
    av_packet_unref(pkt);
  }
  av_packet_free(&pkt);
  refidx_destroy(rp);
  avformat_close_input(&fmt);
  return n;
}

// ---------------------------------------------------------------------------
// Test ABI: run the hop decomposition on synthetic MV lists over a simulated
// lookahead queue, without FFmpeg. Lets Python differential-test the chain
// semantics (multi-ref backward assignment) against an independent model of
// VideoDecoder.cc:211-348.
//
// Inputs: n_queue already-queued frames (oldest first, all empty) + one
// current frame whose n_in MVs are given as flat arrays. Outputs, for each
// of the n_queue+1 frames (queue slots 0..n_queue-1, then the current
// frame): per-frame record arrays, caller-allocated with capacities cap_mv /
// cap_kp rows.
//   out_mv   : (n_queue+1, cap_mv, 7)  f32 — dx dy x0 y0 x1 y1 dindx
//   out_nmv  : (n_queue+1,)            i32
//   out_kp   : (n_queue+1, cap_kp, 4)  f32 — x y w h
//   out_nkp  : (n_queue+1,)            i32
// Returns the coverage area sum of the current frame.
float mvdec_test_decompose(int width, int height, int n_queue,
                           const float* src_xy, const float* dst_xy,
                           const float* wh, const int32_t* ref,
                           const int32_t* source, int n_in, float* out_mv,
                           int32_t* out_nmv, float* out_kp, int32_t* out_nkp,
                           int cap_mv, int cap_kp) {
  std::deque<std::unique_ptr<QueuedFrame>> queue;
  for (int i = 0; i < n_queue; ++i) queue.push_back(std::make_unique<QueuedFrame>());
  QueuedFrame cur;
  float coverage = 0.f;
  for (int i = 0; i < n_in; ++i) {
    MvIn mv;
    mv.source = source[i];
    mv.w = wh[i * 2];
    mv.h = wh[i * 2 + 1];
    mv.src_x = src_xy[i * 2];
    mv.src_y = src_xy[i * 2 + 1];
    mv.dst_x = dst_xy[i * 2];
    mv.dst_y = dst_xy[i * 2 + 1];
    mv.ref = ref[i];
    coverage += decompose_mv(mv, queue, &cur, (float)width, (float)height);
  }
  auto emit = [&](const QueuedFrame& q, int slot) {
    int nm = q.n_mvs < cap_mv ? q.n_mvs : cap_mv;
    out_nmv[slot] = nm;
    for (int k = 0; k < nm; ++k) {
      float* row = out_mv + ((size_t)slot * cap_mv + k) * 7;
      row[0] = q.mv_delta[k * 2];
      row[1] = q.mv_delta[k * 2 + 1];
      row[2] = q.mv_rect[k * 4];
      row[3] = q.mv_rect[k * 4 + 1];
      row[4] = q.mv_rect[k * 4 + 2];
      row[5] = q.mv_rect[k * 4 + 3];
      row[6] = (float)q.mv_dindx[k];
    }
    int nk = q.n_kps < cap_kp ? q.n_kps : cap_kp;
    out_nkp[slot] = nk;
    for (int k = 0; k < nk; ++k) {
      float* row = out_kp + ((size_t)slot * cap_kp + k) * 4;
      row[0] = q.kps_rect[k * 4];
      row[1] = q.kps_rect[k * 4 + 1];
      row[2] = q.kps_rect[k * 4 + 2];
      row[3] = q.kps_rect[k * 4 + 3];
    }
  };
  for (int i = 0; i < n_queue; ++i) emit(*queue[i], i);
  emit(cur, n_queue);
  return coverage;
}

}  // extern "C"
