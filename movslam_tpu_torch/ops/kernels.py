"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

`score_blocks` replaces the Pallas TPU kernel
movslam_tpu/ops/pallas_kernels.py::score_blocks (see csrc/score_blocks.cu
for the design). The CUDA source is compiled with nvcc at first use into
movslam_tpu_torch/_build/ (keyed by a hash of the source) as a shared
library with a plain C interface and bound with ctypes. Nothing is built or
imported at module import: the CPU tests import this module without nvcc.

On a CPU tensor the wrapper runs the plain version `score_blocks_ref`; on a
CUDA tensor it launches the kernel or raises. There is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from . import express
from .bitdesc import hamming

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lib = None


def _find_nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        nvcc = str(cand) if cand.exists() else None
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
    return nvcc


def build(verbose=False):
    """Compile csrc/score_blocks.cu (once per source hash) and load it.

    Returns the ctypes library. Raises with nvcc's output if the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    src = CSRC / "score_blocks.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    so = BUILD_DIR / f"libscore_blocks_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        if verbose:
            print(proc.stdout + proc.stderr, flush=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    fn = lib.score_blocks_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # img, H, W
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,  # tl, prev, thr
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,  # B, dist, desc
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def score_blocks_ref(img, tl_xy, prev_desc, threshold):
    """Plain PyTorch score_blocks: clamped gather + descriptor + Hamming.

    img (H, W) u8; tl_xy (B, 2) i32 top-left (x, y); prev_desc (B, 8) i32.
    Returns (dist (B,) i32, desc (B, 8) i32)."""
    blocks = express.gather_blocks(img, tl_xy)
    desc = express.compute_descriptor(blocks, threshold)
    return hamming(desc, prev_desc), desc


def _check(img, tl_xy, prev_desc):
    if img.dtype != torch.uint8 or img.dim() != 2:
        raise TypeError(f"img must be (H, W) uint8, got {tuple(img.shape)} {img.dtype}")
    H, W = img.shape
    if H < express.BLOCK or W < express.BLOCK:
        raise ValueError(f"image {H}x{W} smaller than a {express.BLOCK}x{express.BLOCK} block")
    if tl_xy.dtype != torch.int32 or tl_xy.dim() != 2 or tl_xy.shape[1] != 2:
        raise TypeError(f"tl_xy must be (B, 2) int32, got {tuple(tl_xy.shape)} {tl_xy.dtype}")
    B = tl_xy.shape[0]
    if prev_desc.dtype != torch.int32 or tuple(prev_desc.shape) != (B, 8):
        raise TypeError(
            f"prev_desc must be ({B}, 8) int32, got {tuple(prev_desc.shape)} {prev_desc.dtype}"
        )
    devs = {img.device, tl_xy.device, prev_desc.device}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")
    return devs.pop()


def score_blocks(img, tl_xy, prev_desc, threshold):
    """Fused gather + EXPRESS descriptor + Hamming for B candidate blocks.

    CUDA tensors launch csrc/score_blocks.cu; CPU tensors run
    score_blocks_ref. Any other device, dtype, shape or layout raises.
    Returns (dist (B,) i32, desc (B, 8) i32)."""
    dev = _check(img, tl_xy, prev_desc)
    if dev.type == "cpu":
        return score_blocks_ref(img, tl_xy, prev_desc, threshold)
    if dev.type != "cuda":
        raise ValueError(f"score_blocks runs on cuda or cpu tensors, got {dev}")
    if not (img.is_contiguous() and tl_xy.is_contiguous() and prev_desc.is_contiguous()):
        raise ValueError("score_blocks needs contiguous tensors")
    lib = build()
    H, W = img.shape
    B = tl_xy.shape[0]
    dist = torch.empty(B, dtype=torch.int32, device=dev)
    desc = torch.empty((B, 8), dtype=torch.int32, device=dev)
    if B == 0:
        return dist, desc
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.score_blocks_launch(
            img.data_ptr(), H, W, tl_xy.data_ptr(), prev_desc.data_ptr(),
            float(threshold), B, dist.data_ptr(), desc.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"score_blocks launch failed: cudaError {err}")
    score_blocks.launches += 1
    return dist, desc


score_blocks.launches = 0
