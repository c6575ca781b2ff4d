#!/usr/bin/env bash
# Build the FFmpeg motion-vector decoder (C ABI for ctypes) into the given
# shared library path:
#
#   bash build.sh /abs/path/libmvdecoder.so
#
# movslam_tpu_torch/io/video.py runs this at first use with a path under
# movslam_tpu_torch/_build/ keyed by a hash of these sources.
#
# If the installed libavutil carries the reference's ref-index patch
# (ffmpeg-ref-patch.patch adds `int32_t ref` to AVMotionVector), define
# MV_REF_FIELD so multi-ref hop decomposition uses the real reference index;
# against stock FFmpeg every MV is treated as ref=0 (exact for ref=1
# encodes), or recovered by the CAVLC sidecar parser (h264_refidx.cc).
set -euo pipefail
OUT="${1:?usage: build.sh <output .so path>}"
cd "$(dirname "$0")"

CFLAGS="$(pkg-config --cflags libavformat libavcodec libavutil libswscale)"
LIBS="$(pkg-config --libs libavformat libavcodec libavutil libswscale)"

REF_FLAG=""
MV_HDR="$(echo "$CFLAGS" | tr ' ' '\n' | grep '^-I' | sed 's/^-I//' | while read -r d; do
  [ -f "$d/libavutil/motion_vector.h" ] && echo "$d/libavutil/motion_vector.h" && break
done || true)"
[ -z "${MV_HDR:-}" ] && for d in /usr/include /usr/include/x86_64-linux-gnu /usr/local/include; do
  [ -f "$d/libavutil/motion_vector.h" ] && MV_HDR="$d/libavutil/motion_vector.h" && break
done
if [ -n "${MV_HDR:-}" ] && grep -q 'int32_t ref' "$MV_HDR"; then
  REF_FLAG="-DMV_REF_FIELD"
  echo "patched FFmpeg detected ($MV_HDR): multi-ref MV export enabled"
fi

g++ -O2 -shared -fPIC -std=c++17 $REF_FLAG \
    mv_decoder.cc mv_encoder.cc h264_refidx.cc \
    -o "$OUT" \
    $CFLAGS $LIBS
echo "built $OUT"
