// h264_refidx: per-8x8-block L0 reference indices recovered from H.264
// CAVLC bitstreams with stock libavcodec (no patched FFmpeg). See
// h264_refidx.cc for scope and semantics. Values in the returned map are
// `frames_back - 1` (the reference's AVMotionVector.ref semantics,
// the C++ reference's ffmpeg-ref-patch.patch:122-129) or -1 for intra blocks.
#pragma once
#include <cstddef>
#include <cstdint>

struct RefIdxParser;

extern "C" {
RefIdxParser* refidx_create();
void refidx_destroy(RefIdxParser*);
// Configure from AVCC extradata (ISO-BMFF avcC). Annex-B needs no setup.
int refidx_set_avcc(RefIdxParser*, const uint8_t* data, size_t size);
// Parse one demuxed access unit, keyed by its pts. Returns 1 when a P-frame
// ref map was stored, 0 otherwise.
int refidx_feed(RefIdxParser*, const uint8_t* data, size_t size, int64_t pts);
// Fetch the map for a decoded frame: mb_w*mb_h*4 int8 values, raster MB
// order, 4 entries per MB in 8x8-block raster order. Null when absent.
const int8_t* refidx_get(RefIdxParser*, int64_t pts, int* mb_w, int* mb_h);
void refidx_gc(RefIdxParser*, int64_t min_pts);
// 0 once the parser hit an unsupported feature (CABAC, interlace, ...) and
// disabled itself; the caller falls back to ref=0.
int refidx_ok(RefIdxParser*);
}
