"""Tests of the port that need an NVIDIA card; they skip without one.

This file imports neither jax nor the JAX package, so it also runs where
those are not installed. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(--noconftest: tests/conftest.py configures JAX for the CPU suite.)"""
import numpy as np
import pytest
import torch

from movslam_tpu_torch.ops import kernels

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


def test_short_drive_runs_through_the_kernel(card):
    from movslam_tpu_torch.config.settings import MONOCULAR, Settings
    from movslam_tpu_torch.core.camera import Pinhole
    from movslam_tpu_torch.core.system import System
    from movslam_tpu_torch.io.synthetic import SyntheticStream

    s = Settings()
    s.camera1 = Pinhole(320.0, 320.0, 320.0, 240.0, 640, 480)
    system = System(s, MONOCULAR, device="cuda")
    stream = SyntheticStream(n_points=400, seed=11)
    before = kernels.score_blocks.launches
    for k in range(8):
        smv = stream.frame(k)
        system.track_monocular(smv.timestamp, smv)
    system.shutdown()
    torch.cuda.synchronize()
    assert system.tracking.state.name == "OK"
    assert system._prev_state.pt.is_cuda
    assert kernels.score_blocks.launches > before
