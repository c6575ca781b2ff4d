"""VideoDecoder: Python wrapper over the native FFmpeg motion-vector decoder.

The port's own copy of movslam_tpu/io/video.py (ctypes + numpy). The codec
boundary stays host-side native C++ (native/decoder/mv_decoder.cc, a copy
of the reference's sources), mirroring the C++ reference's VideoDecoder
API (VideoDecoder.h:31-42): `VideoDecoder(url, qlen)`, `init()`,
`next_image(mv)` -> MotionVectorImage | None. `url` is a file (.mp4, .ts,
...) or a live stream (`tcp://host:port`), opened by libavformat.

The shared library is built at first use from native/decoder/ with its
build.sh (g++, pkg-config and the libavformat, libavcodec, libavutil and
libswscale development files; libx264 through libavcodec for encode_gray)
into movslam_tpu_torch/_build/, under a name keyed by a hash of the
sources. A failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from ..core.verbose import Verbose
from .mvimage import FrameType, MotionVectorImage

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "native" / "decoder"
BUILD_DIR = _PKG / "_build"
SOURCES = ("mv_decoder.cc", "mv_encoder.cc", "h264_refidx.cc", "h264_refidx.h",
           "h264_cavlc_tables.h", "build.sh")
LIBAV = ("libavformat", "libavcodec", "libavutil", "libswscale")

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib = None
_lib_lock = threading.Lock()


class _MvFrameView(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("frame_no", ctypes.c_int32),
        ("ft", ctypes.c_int32),
        ("timestamp", ctypes.c_double),
        ("coverage", ctypes.c_float),
        ("gray", ctypes.POINTER(ctypes.c_uint8)),
        ("n_mvs", ctypes.c_int32),
        ("n_kps", ctypes.c_int32),
        ("mv_delta", ctypes.POINTER(ctypes.c_float)),
        ("mv_rect", ctypes.POINTER(ctypes.c_float)),
        ("mv_dindx", ctypes.POINTER(ctypes.c_int32)),
        ("kps_rect", ctypes.POINTER(ctypes.c_float)),
        ("mv_dropped", ctypes.c_int32),
        ("kp_dropped", ctypes.c_int32),
        ("rgb", ctypes.POINTER(ctypes.c_uint8)),
        ("n_bmvs", ctypes.c_int32),
        ("bmv_delta", ctypes.POINTER(ctypes.c_float)),
        ("bmv_rect", ctypes.POINTER(ctypes.c_float)),
    ]


def libav_found():
    """Whether pkg-config finds the libav development files the build needs."""
    if shutil.which("pkg-config") is None:
        return False
    return subprocess.run(["pkg-config", "--exists", *LIBAV]).returncode == 0


def _bind(lib):
    sigs = {
        "mvdec_open": (_P, [ctypes.c_char_p, _I]),
        "mvdec_error": (ctypes.c_char_p, [_P]),
        "mvdec_next": (ctypes.POINTER(_MvFrameView), [_P]),
        "mvdec_width": (_I, [_P]),
        "mvdec_height": (_I, [_P]),
        "mvdec_fps": (ctypes.c_double, [_P]),
        "mvdec_close": (None, [_P]),
        "mvdec_set_rgb": (None, [_P, _I]),
        "mvdec_refidx_scan": (_I, [ctypes.c_char_p, np.ctypeslib.ndpointer(np.int32), _I]),
        "mvenc_encode_gray2": (_I, [ctypes.c_char_p, np.ctypeslib.ndpointer(np.uint8), _I, _I,
                                    _I, ctypes.c_double, _I, _I, _I, _I]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def build(verbose=False):
    """Build native/decoder/ into _build/ (once per source hash) and load
    it. Raises with the build's output if it fails."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256()
        for name in SOURCES:
            h.update(name.encode() + b"\0" + (SRC_DIR / name).read_bytes())
        so = BUILD_DIR / f"libmvdecoder_{h.hexdigest()[:16]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # Build to a private name, then rename: several processes may
            # build at once, and each sees either no library or a whole one.
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.run(["bash", str(SRC_DIR / "build.sh"), tmp],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"native decoder build failed ({proc.returncode}):\n"
                                   f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
            if verbose:
                print(proc.stdout + proc.stderr, flush=True)
            os.replace(tmp, so)
        _lib = _bind(ctypes.CDLL(str(so)))
        return _lib


def encode_gray(path, frames, fps=30.0, keyint=1000, refs=2, bframes=0, cavlc=False):
    """Encode a (N, H, W) uint8 stack with libx264 at the C++ reference's
    operating point (README.md:47-69: preset fast, tune film, p8x8/p4x4
    partitions, me=umh, merange=64, subme=6, bframes=0). bframes > 0
    exercises the decoder's B-frame branch; cavlc=True encodes with CAVLC,
    so the h264_refidx sidecar parser recovers per-block reference indices
    (the multi-ref ingest path) with stock libavcodec."""
    lib = build()
    frames = np.ascontiguousarray(frames, np.uint8)
    n, h, w = frames.shape
    rc = lib.mvenc_encode_gray2(str(path).encode(), frames.reshape(-1), w, h, n, float(fps),
                                int(keyint), int(refs), int(bframes), int(bool(cavlc)))
    if rc != 0:
        raise RuntimeError(f"mvenc_encode_gray failed rc={rc}")


def refidx_scan(path, cap=512):
    """Run only the CAVLC ref-index sidecar parser over a file's packets.

    Returns an (n, 12) int32 array per access unit: [parsed, n_mbs,
    n_intra_blocks, hist_ref0..hist_ref7, overflow] where hist_refK counts
    8x8 blocks recovered as `hops-1 == K`."""
    lib = build()
    out = np.zeros((cap, 12), np.int32)
    n = lib.mvdec_refidx_scan(str(path).encode(), out.reshape(-1), cap)
    if n < 0:
        raise RuntimeError(f"mvdec_refidx_scan failed rc={n}")
    return out[:n]


class VideoDecoder:
    """Streaming MV decoder. `next_image(mv=True)` pops the oldest lookahead
    frame; `mv=False` skips the MV copies (the right frames of frame-packed
    stereo). Frames past the MV or keypoint capacity are truncated, and the
    first truncation is logged."""

    def __init__(self, url, qlen=12, max_mvs=8192, max_kps=4096, rgb=False):
        self.url = url
        self.qlen = qlen
        self.rgb = rgb  # decode the RGB surface beside the gray one (VideoBase.h:60-68)
        # Array capacities of each MotionVectorImage. The native decoder caps
        # at 16384/8192 and counts its own drops.
        self.max_mvs = max_mvs
        self.max_kps = max_kps
        self._warned_drop = False
        self._lib = None
        self._h = None
        self.width = 0
        self.height = 0
        self.fps = 30.0

    def init(self):
        self._lib = build()
        self._h = self._lib.mvdec_open(str(self.url).encode(), self.qlen)
        err = self._lib.mvdec_error(self._h)
        if err:
            raise RuntimeError(f"VideoDecoder: {err.decode()} ({self.url})")
        self.width = self._lib.mvdec_width(self._h)
        self.height = self._lib.mvdec_height(self._h)
        self.fps = self._lib.mvdec_fps(self._h)
        if self.rgb:
            self._lib.mvdec_set_rgb(self._h, 1)
        return True

    def next_image(self, mv=True):
        vp = self._lib.mvdec_next(self._h)
        if not vp:
            return None
        v = vp.contents
        smv = MotionVectorImage.empty(v.width, v.height, self.max_mvs, self.max_kps)
        smv.frame_no = v.frame_no
        smv.timestamp = v.timestamp
        smv.ft = FrameType(v.ft)
        smv.im_gray = np.ctypeslib.as_array(v.gray, shape=(v.height, v.width)).copy()
        if v.rgb:
            smv.im_rgb = np.ctypeslib.as_array(v.rgb, shape=(v.height, v.width, 3)).copy()
        if not mv:
            return smv
        n_mvs = min(v.n_mvs, self.max_mvs)
        n_kps = min(v.n_kps, self.max_kps)
        dropped = (v.n_mvs - n_mvs) + (v.n_kps - n_kps) + v.mv_dropped + v.kp_dropped
        if dropped and not self._warned_drop:
            Verbose.log(f"VideoDecoder: frame {v.frame_no} dropped {dropped} MV/keypoint records "
                        f"over capacity (n_mvs={v.n_mvs}, n_kps={v.n_kps}); further drops not logged")
            self._warned_drop = True
        if n_mvs:
            smv.mv_delta[:n_mvs] = np.ctypeslib.as_array(v.mv_delta, shape=(v.n_mvs, 2))[:n_mvs]
            smv.mv_rect[:n_mvs] = np.ctypeslib.as_array(v.mv_rect, shape=(v.n_mvs, 4))[:n_mvs]
            smv.mv_dindx[:n_mvs] = np.ctypeslib.as_array(v.mv_dindx, shape=(v.n_mvs,))[:n_mvs]
            smv.n_mvs = n_mvs
        if n_kps:
            smv.kps_rect[:n_kps] = np.ctypeslib.as_array(v.kps_rect, shape=(v.n_kps, 4))[:n_kps]
            smv.n_kps = n_kps
        smv.coverage_area = float(v.coverage)
        if v.n_bmvs:
            smv.n_bmvs = v.n_bmvs
            smv.bmv_delta = np.ctypeslib.as_array(v.bmv_delta, shape=(v.n_bmvs, 2)).copy()
            smv.bmv_rect = np.ctypeslib.as_array(v.bmv_rect, shape=(v.n_bmvs, 4)).copy()
        return smv

    def __iter__(self):
        while True:
            smv = self.next_image(True)
            if smv is None:
                return
            yield smv

    def close(self):
        if self._h:
            self._lib.mvdec_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
