"""Tests of the port that need an NVIDIA card; they skip without one.

This file imports neither jax nor the JAX package, so it also runs where
those are not installed (tests/_torch_parity.py imports jax only inside
replay_jax_draws). On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(--noconftest: tests/conftest.py configures JAX for the CPU suite.)"""
import numpy as np
import pytest
import torch

from movslam_tpu_torch.ops import kernels
from tests._torch_parity import candidate_case

pytestmark = pytest.mark.cuda

EDGE_TL = np.array(
    [[0, 0], [240, 112], [0, 112], [240, 0], [5, 100], [100, 5], [239, 111], [1, 1]],
    np.int32,
)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("H,W,B", [(480, 640, 8192), (128, 256, 8), (37, 50, 13), (64, 64, 0)])
def test_score_blocks_kernel_matches_plain_version(card, H, W, B):
    rng = np.random.default_rng(B)
    img = rng.integers(0, 256, (H, W)).astype(np.uint8)
    tl = EDGE_TL if H == 128 else np.stack(
        [rng.integers(-8, W, B), rng.integers(-8, H, B)], -1).astype(np.int32)
    prev = rng.integers(0, 2**32, (len(tl), 8), dtype=np.uint32).view(np.int32)
    args = [torch.as_tensor(a, device=card) for a in (img, tl, prev)]
    before = kernels.score_blocks.launches
    dist, desc = kernels.score_blocks(*args, 25.0)
    torch.cuda.synchronize()
    assert kernels.score_blocks.launches == before + (1 if len(tl) else 0)
    want_dist, want_desc = kernels.score_blocks_ref(*args, 25.0)
    assert torch.equal(dist, want_dist) and torch.equal(desc, want_desc)


def test_score_blocks_refuses_mixed_or_strided_inputs(card):
    img = torch.zeros((64, 64), dtype=torch.uint8, device=card)
    tl = torch.zeros((4, 2), dtype=torch.int32, device=card)
    prev = torch.zeros((4, 8), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        kernels.score_blocks(img, tl.cpu(), prev, 25.0)
    with pytest.raises(ValueError):
        kernels.score_blocks(img.t(), tl, prev, 25.0)


CAND_ARGS = ("img", "prev_pt", "cand", "mv_delta", "prev_wh", "prev_desc")


@pytest.mark.parametrize("thr", [0.0, 7.5, 300.0])
def test_score_blocks_kernel_other_thresholds(card, thr):
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (128, 256)).astype(np.uint8)
    tl = np.concatenate([EDGE_TL, np.stack([rng.integers(-8, 256, 56), rng.integers(-8, 128, 56)], -1)])
    prev = rng.integers(0, 2**32, (len(tl), 8), dtype=np.uint32).view(np.int32)
    args = [torch.as_tensor(a, device=card) for a in (img, tl.astype(np.int32), prev)]
    got, want = kernels.score_blocks(*args, thr), kernels.score_blocks_ref(*args, thr)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("H,W,N,M,thr", [
    (480, 640, 2048, 4096, 25.0), (240, 320, 8, 16, 25.0), (240, 320, 0, 16, 25.0),
    (37, 50, 300, 64, 25.0), (240, 320, 512, 1024, 7.5),
])
def test_score_candidates_kernel_matches_plain_version(card, H, W, N, M, thr):
    c = candidate_case(N + M, H=H, W=W, N=N, M=M, threshold=thr)
    args = [torch.as_tensor(c[k], device=card) for k in CAND_ARGS]
    before = kernels.score_candidates.launches
    got = kernels.score_candidates(*args, thr)
    torch.cuda.synchronize()
    assert kernels.score_candidates.launches == before + (1 if N else 0)
    want = kernels.score_candidates_ref(*args, thr)
    for name, g, w in zip(("mv", "new_pt", "dist", "desc", "inb"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


def test_score_candidates_reads_strided_mv_rows(card):
    c = candidate_case(3, N=64, M=128)
    args = [torch.as_tensor(c[k], device=card) for k in CAND_ARGS]
    pack = torch.zeros((128, 8), dtype=torch.float32, device=card)
    pack[:, 0:2] = args[3]
    args[3] = pack[:, 0:2]  # a column slice of the packed MV table, as the drive passes it
    got, want = kernels.score_candidates(*args, 25.0), kernels.score_candidates_ref(*args, 25.0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_score_candidates_refuses_bad_inputs(card):
    c = candidate_case(5, N=8, M=16)
    args = [torch.as_tensor(c[k], device=card) for k in CAND_ARGS]
    with pytest.raises(ValueError):  # mixed devices
        kernels.score_candidates(args[0], args[1].cpu(), *args[2:], 25.0)
    with pytest.raises(TypeError):
        kernels.score_candidates(*args[:2], args[2].long(), *args[3:], 25.0)
    with pytest.raises(TypeError):
        kernels.score_candidates(*args[:5], args[5].float(), 25.0)
    with pytest.raises(ValueError):  # strided track rows
        kernels.score_candidates(*args[:1], args[1].t().contiguous().t(), *args[2:], 25.0)
    with pytest.raises(ValueError):  # mv_delta's columns apart
        kernels.score_candidates(*args[:3], args[3].t().contiguous().t(), *args[4:], 25.0)
    with pytest.raises(ValueError):  # an image that does not start on a word
        big = torch.zeros(64 * 65, dtype=torch.uint8, device=card)
        kernels.score_candidates(big[1:1 + 64 * 64].view(64, 64), *args[1:], 25.0)


def test_short_drive_runs_through_the_kernel(card):
    from movslam_tpu_torch.config.settings import MONOCULAR, Settings
    from movslam_tpu_torch.core.camera import Pinhole
    from movslam_tpu_torch.core.system import System
    from movslam_tpu_torch.io.synthetic import SyntheticStream

    s = Settings()
    s.camera1 = Pinhole(320.0, 320.0, 320.0, 240.0, 640, 480)
    system = System(s, MONOCULAR, device="cuda")
    stream = SyntheticStream(n_points=400, seed=11)
    before = kernels.score_candidates.launches
    for k in range(8):
        smv = stream.frame(k)
        system.track_monocular(smv.timestamp, smv)
    system.shutdown()
    torch.cuda.synchronize()
    assert system.tracking.state.name == "OK"
    assert system._prev_state.pt.is_cuda
    assert kernels.score_candidates.launches > before
