"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Two replace the Pallas TPU kernel
movslam_tpu/ops/pallas_kernels.py::score_blocks (see csrc/score_blocks.cu
for the design):

  score_blocks      the TPU kernel's own contract: B independent blocks;
  score_candidates  the per-track scoring step of the MV propagation
                    (ops/propagate.py): positions, bounds tests, descriptors,
                    distances and the best-of-4 choice in one launch.

One has no TPU counterpart (csrc/segment_sum.cu):

  segment_sum       the ordered f32 segment sum of the BA and the pose
                    graph: the order CPU index_add_ takes, the same on
                    every run, where index_add_ on the card is atomics.

Each CUDA source is compiled with nvcc at first use into
movslam_tpu_torch/_build/ (keyed by a hash of the source; one nvcc per
source, started together) as a shared library with a plain C interface
and bound with ctypes. Nothing is built or imported at module import: the
CPU tests import this module without nvcc.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises. There is no fallback. Each wrapper counts its
launches in `<wrapper>.launches`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple

import torch

from . import express
from .bitdesc import hamming
from .mvselect import N_CAND

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SOURCES = {  # CUDA source -> {C entry point: argtypes}
    "score_blocks.cu": {
        # img, H, W, tl, prev, thr, B, dist, desc, stream
        "score_blocks_launch": [_P, _I, _I, _P, _P, _F, _I, _P, _P, _P],
        # img, H, W, prev_pt, cand, mv_delta, mv_stride, prev_wh, prev_desc, thr, N,
        # n_per_img, mv_per_img, desc, dist, mv, pt, inb, stream
        "score_candidates_launch": [_P, _I, _I, _P, _P, _P, _I, _P, _P, _F, _I, _I, _I,
                                    _P, _P, _P, _P, _P, _P],
    },
    "segment_sum.cu": {
        # x, C, perm, offsets, n, out, stream
        "segment_sum_launch": [_P, _I, _P, _P, _I, _P, _P],
    },
}

_fns = {}  # C entry point name -> bound ctypes function


def _find_nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        nvcc = str(cand) if cand.exists() else None
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
    return nvcc


def _library(src):
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build(verbose=False):
    """Compile every csrc/*.cu of _SOURCES (once per source hash; the nvcc
    runs in parallel) and bind their entry points. Raises with nvcc's output
    if a build fails."""
    if _fns:
        return _fns
    jobs = []
    for name in _SOURCES:
        so = _library(CSRC / name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, str(CSRC / name)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, so, tmp, proc))
    failed = []
    for name, so, tmp, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc {name} failed ({proc.returncode}):\n{log}")
            continue
        if verbose:
            print(f"nvcc {name}:\n{log}", flush=True)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    for name, signatures in _SOURCES.items():
        lib = ctypes.CDLL(str(_library(CSRC / name)))
        for entry, argtypes in signatures.items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[entry] = fn
    return _fns


def _launch(name, dev, *args):
    """Call a C entry point on `dev`'s current stream; raise on a CUDA error."""
    fn = _fns.get(name) or build()[name]
    if dev.index is not None and dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err}")


def _check_img(img, streams=False):
    if img.dtype != torch.uint8 or img.dim() not in ((2, 3) if streams else (2,)):
        want = "(H, W) or (S, H, W)" if streams else "(H, W)"
        raise TypeError(f"img must be {want} uint8, got {tuple(img.shape)} {img.dtype}")
    H, W = img.shape[-2:]
    if H < express.BLOCK or W < express.BLOCK:
        raise ValueError(f"image {H}x{W} smaller than a {express.BLOCK}x{express.BLOCK} block")


def _check_typed(name, x, dtype, shape):
    if x.dtype != dtype or tuple(x.shape) != shape:
        raise TypeError(f"{name} must be {shape} {dtype}, got {tuple(x.shape)} {x.dtype}")


def _common_device(name, *tensors):
    devs = {x.device for x in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {dev}")
    return dev


def _check_card_layout(name, img, *tensors):
    if not all(x.is_contiguous() for x in (img, *tensors)):
        raise ValueError(f"{name} needs contiguous tensors")
    if img.data_ptr() % 4:
        raise ValueError(f"{name} needs an image that starts on a 4-byte boundary")


def score_blocks_ref(img, tl_xy, prev_desc, threshold):
    """Plain PyTorch score_blocks: clamped gather + descriptor + Hamming.

    img (H, W) u8; tl_xy (B, 2) i32 top-left (x, y); prev_desc (B, 8) i32.
    Returns (dist (B,) i32, desc (B, 8) i32)."""
    blocks = express.gather_blocks(img, tl_xy)
    desc = express.compute_descriptor(blocks, threshold)
    return hamming(desc, prev_desc), desc


def score_blocks(img, tl_xy, prev_desc, threshold):
    """Fused gather + EXPRESS descriptor + Hamming for B candidate blocks.

    img (H, W) u8; tl_xy (B, 2) i32 top-left (x, y); prev_desc (B, 8) i32.
    CUDA tensors launch csrc/score_blocks.cu; CPU tensors run
    score_blocks_ref. Any other device, dtype, shape or layout raises.
    Returns (dist (B,) i32, desc (B, 8) i32)."""
    _check_img(img)
    if tl_xy.dtype != torch.int32 or tl_xy.dim() != 2 or tl_xy.shape[1] != 2:
        raise TypeError(f"tl_xy must be (B, 2) int32, got {tuple(tl_xy.shape)} {tl_xy.dtype}")
    B = tl_xy.shape[0]
    _check_typed("prev_desc", prev_desc, torch.int32, (B, 8))
    dev = _common_device("score_blocks", img, tl_xy, prev_desc)
    if dev.type == "cpu":
        return score_blocks_ref(img, tl_xy, prev_desc, threshold)
    _check_card_layout("score_blocks", img, tl_xy, prev_desc)
    H, W = img.shape
    out = torch.empty(9 * B, dtype=torch.int32, device=dev)  # one allocation, two planes
    dist, desc = out[:B], out[B:].view(B, 8)
    if B:
        _launch("score_blocks_launch", dev, img.data_ptr(), H, W, tl_xy.data_ptr(),
                prev_desc.data_ptr(), float(threshold), B, dist.data_ptr(), desc.data_ptr())
        score_blocks.launches += 1
    return dist, desc


score_blocks.launches = 0


def _block_inbounds(pt, wh, width, height):
    """The reference's bounds check: tl >= 0 and tl + wh < dim (strict)."""
    whi = wh.to(torch.int32)
    tlx = torch.floor(pt[..., 0]).to(torch.int32) - (wh[..., 0] / 2).to(torch.int32)
    tly = torch.floor(pt[..., 1]).to(torch.int32) - (wh[..., 1] / 2).to(torch.int32)
    return (tlx >= 0) & (tly >= 0) & (tlx + whi[..., 0] < width) & (tly + whi[..., 1] < height)


def _streams(img, N, M):
    """Number of streams S of a (H, W) or (S, H, W) image; N tracks and M MV
    rows must split into S equal runs."""
    S = img.shape[0] if img.dim() == 3 else 1
    if S < 1 or N % S or M % S:
        raise ValueError(f"{N} tracks and {M} MV rows do not split into {S} streams")
    return S


def score_candidates_ref(img, prev_pt, cand, mv_delta, prev_wh, prev_desc, threshold,
                         block_scorer=score_blocks_ref):
    """Plain PyTorch score_candidates: score each track's 4 MV candidates
    and choose one (the per-track step of MOVExtractor.cc:264-300).

    A candidate sits at prev_pt + mv_delta[cand] (a slot without one, -1,
    at its stream's first MV row); its block's top-left truncates toward
    zero. Unusable candidates (none, or out of bounds) never win; slot 0 is
    kept unless the track has a second candidate and the best usable one
    scores strictly below 256; ties go to the first. `block_scorer` scores
    each stream's (N/S*4) blocks (score_blocks_ref, or the score_blocks
    kernel to time the unfused composition on the card).
    Returns (mv (N,) i32 chosen MV index or -1, new_pt (N, 2) f32,
    dist (N,) i32, desc (N, 8) i32, inb (N,) bool)."""
    H, W = img.shape[-2:]
    N, M = prev_pt.shape[0], mv_delta.shape[0]
    S = _streams(img, N, M)
    stream_row0 = (torch.arange(N, device=cand.device) // (N // S if N else 1)) * (M // S)
    cand_safe = torch.where(cand >= 0, cand.to(torch.int64), stream_row0[:, None])
    cand_pt = prev_pt[:, None, :] + mv_delta[cand_safe]  # (N, 4, 2)
    cand_inb = _block_inbounds(cand_pt, prev_wh[:, None, :], W, H)

    tl = (cand_pt.to(torch.int32).reshape(-1, 2) - express.BLOCK // 2).contiguous()
    prev_rep = prev_desc.repeat_interleave(N_CAND, dim=0).contiguous()
    imgs = img if img.dim() == 3 else img[None]
    scored = [block_scorer(im, tl_s.contiguous(), prev_s.contiguous(), threshold)
              for im, tl_s, prev_s in zip(imgs, tl.chunk(S), prev_rep.chunk(S))]
    dist_flat = torch.cat([d for d, _ in scored])
    desc_flat = torch.cat([d for _, d in scored])
    cand_desc = desc_flat.reshape(N, N_CAND, 8)
    cand_dist = dist_flat.reshape(N, N_CAND)

    usable = (cand >= 0) & cand_inb
    score = torch.where(usable, cand_dist, torch.full_like(cand_dist, 10_000))
    best_v, best_j = score.min(dim=1)
    multi = cand[:, 1] >= 0
    chosen_j = torch.where(multi & (best_v < 256), best_j, torch.zeros_like(best_j))

    rows = torch.arange(N, device=prev_pt.device)
    return (cand[rows, chosen_j], cand_pt[rows, chosen_j], cand_dist[rows, chosen_j],
            cand_desc[rows, chosen_j], cand_inb[rows, chosen_j])


def score_candidates(img, prev_pt, cand, mv_delta, prev_wh, prev_desc, threshold):
    """Fused per-track candidate scorer: for each of N tracks, its 4 MV
    candidates' positions, bounds tests, descriptors and Hamming distances
    to prev_desc, and the best-of-4 choice (score_candidates_ref).

    img (H, W) u8; prev_pt (N, 2) f32; cand (N, 4) i32 MV indices or -1;
    mv_delta (M, 2) f32 (its rows may be strided, e.g. a column slice of the
    packed MV table); prev_wh (N, 2) f32; prev_desc (N, 8) i32.
    S streams in one call: img (S, H, W), the tracks S runs of N/S rows, the
    MV rows S runs of M/S, and cand global MV rows (stream s's offset by
    s*M/S); track n reads image n // (N/S).
    CUDA tensors launch csrc/score_blocks.cu; CPU tensors run
    score_candidates_ref. Any other device, dtype, shape or layout raises.
    Returns (mv, new_pt, dist, desc, inb) as score_candidates_ref does."""
    _check_img(img, streams=True)
    if cand.dtype != torch.int32 or cand.dim() != 2 or cand.shape[1] != N_CAND:
        raise TypeError(f"cand must be (N, {N_CAND}) int32, got {tuple(cand.shape)} {cand.dtype}")
    N = cand.shape[0]
    _check_typed("prev_pt", prev_pt, torch.float32, (N, 2))
    _check_typed("prev_wh", prev_wh, torch.float32, (N, 2))
    _check_typed("prev_desc", prev_desc, torch.int32, (N, 8))
    if mv_delta.dtype != torch.float32 or mv_delta.dim() != 2 or mv_delta.shape[1] != 2:
        raise TypeError(f"mv_delta must be (M, 2) float32, got {tuple(mv_delta.shape)} {mv_delta.dtype}")
    if N and mv_delta.shape[0] == 0:
        raise ValueError("mv_delta needs at least one row: a track without a candidate scores row 0")
    S = _streams(img, N, mv_delta.shape[0])
    dev = _common_device("score_candidates", img, prev_pt, cand, mv_delta, prev_wh, prev_desc)
    if dev.type == "cpu":
        return score_candidates_ref(img, prev_pt, cand, mv_delta, prev_wh, prev_desc, threshold)
    _check_card_layout("score_candidates", img, prev_pt, cand, prev_wh, prev_desc)
    if mv_delta.stride(1) != 1:
        raise ValueError("score_candidates needs mv_delta's two columns side by side")
    H, W = img.shape[-2:]
    if S > 1 and (H * W) % 4:
        raise ValueError("score_candidates over streams needs H * W a multiple of 4 (aligned images)")
    # One allocation, five planes: desc (8N), dist (N), mv (N), new_pt (2N
    # floats), inb (N bools in ceil(N/4) words).
    out = torch.empty(12 * N + (N + 3) // 4, dtype=torch.int32, device=dev)
    desc = out[: 8 * N].view(N, 8)
    dist = out[8 * N: 9 * N]
    mv = out[9 * N: 10 * N]
    new_pt = out[10 * N: 12 * N].view(torch.float32).view(N, 2)
    inb = out[12 * N:].view(torch.bool)[:N]
    if N:
        _launch("score_candidates_launch", dev, img.data_ptr(), H, W, prev_pt.data_ptr(),
                cand.data_ptr(), mv_delta.data_ptr(), mv_delta.stride(0), prev_wh.data_ptr(),
                prev_desc.data_ptr(), float(threshold), N, N // S, mv_delta.shape[0] // S,
                desc.data_ptr(), dist.data_ptr(),
                mv.data_ptr(), new_pt.data_ptr(), inb.data_ptr())
        score_candidates.launches += 1
    return mv, new_pt, dist, desc, inb


score_candidates.launches = 0


class SegmentPlan(NamedTuple):
    """The summation order of one index vector over n segments: perm lists
    the kept rows stable-sorted by segment (rows left out sort past
    offsets[n]) and offsets[s]..offsets[s + 1] is segment s's run of it."""

    perm: torch.Tensor  # (R,) int32
    offsets: torch.Tensor  # (n + 1,) int32
    n: int


def segment_plan(idx, n, keep=None):
    """The plan of idx (R,) into n segments, with integer ops only and no
    host sync: a stable argsort and a searchsorted of the segment starts.
    Rows where keep (R,) bool is False are left out of every segment."""
    idx = idx.to(torch.int64)
    if keep is not None:
        idx = torch.where(keep, idx, torch.full_like(idx, n))
    perm = torch.argsort(idx, stable=True)
    starts = torch.arange(n + 1, dtype=torch.int64, device=idx.device)
    offsets = torch.searchsorted(idx[perm], starts)
    return SegmentPlan(perm.to(torch.int32), offsets.to(torch.int32), n)


def segment_sum_ref(x, plan):
    """Plain segment_sum: index_add_ over the plan's rows in the plan's
    order, which per segment is increasing row order."""
    counts = (plan.offsets[1:] - plan.offsets[:-1]).to(torch.int64)
    seg = torch.repeat_interleave(torch.arange(plan.n, device=x.device), counts)
    rows = plan.perm[: seg.shape[0]].to(torch.int64)
    out = torch.zeros((plan.n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, seg, x[rows])


def segment_sum(x, plan):
    """Ordered segment sum: out[s] = sum of x[i] over the plan's rows i of
    segment s, in increasing i, one sequential f32 sum per element. x (R,
    ...) f32, contiguous; the trailing dims are summed as C columns.

    CUDA tensors launch csrc/segment_sum.cu (the order CPU index_add_ takes,
    bit for bit); CPU tensors run segment_sum_ref. Any other device, dtype
    or layout raises. Returns (plan.n, ...) f32."""
    if x.dim() < 1 or plan.perm.dim() != 1 or plan.perm.shape[0] != x.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} does not match a plan over {plan.perm.shape[0]} rows")
    if plan.perm.dtype != torch.int32 or plan.offsets.dtype != torch.int32 or \
            tuple(plan.offsets.shape) != (plan.n + 1,):
        raise TypeError("the plan must be int32 perm (R,) and offsets (n + 1,), as segment_plan makes it")
    dev = _common_device("segment_sum", x, plan.perm, plan.offsets)
    if dev.type == "cpu":
        return segment_sum_ref(x, plan)
    if x.dtype != torch.float32:
        raise TypeError(f"segment_sum sums float32 on the card, got {x.dtype}")
    if not all(t.is_contiguous() for t in (x, plan.perm, plan.offsets)):
        raise ValueError("segment_sum needs contiguous tensors")
    C = 1
    for d in x.shape[1:]:
        C *= d
    out = torch.empty((plan.n,) + tuple(x.shape[1:]), dtype=torch.float32, device=dev)
    if out.numel():
        _launch("segment_sum_launch", dev, x.data_ptr(), C, plan.perm.data_ptr(),
                plan.offsets.data_ptr(), plan.n, out.data_ptr())
        segment_sum.launches += 1
    return out


segment_sum.launches = 0
