"""Tests of the port that need an NVIDIA card; they skip without one.

This file imports neither jax nor the JAX package, so it also runs where
those are not installed (tests/_torch_parity.py imports jax only inside
replay_jax_draws and window_keys). On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(--noconftest: tests/conftest.py configures JAX for the CPU suite.)"""
import numpy as np
import pytest
import torch

from movslam_tpu_torch.ops import kernels
from tests._torch_parity import candidate_case, window_case

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


def _cpu_draws(seed):
    """A sampler whose uniform draws come from a CPU generator whatever the
    device: the card and the CPU see the same RANSAC samples."""
    g = torch.Generator("cpu").manual_seed(seed)

    def sampler(n_hyp, sample, n_valid):
        hi = n_valid.clamp(min=1).to(torch.float32)
        u = torch.rand((n_hyp, sample), generator=g).to(n_valid.device)
        return torch.minimum((u * hi).to(torch.int64), (hi - 1).to(torch.int64))

    return sampler


@pytest.mark.parametrize("staged", [False, True], ids=["no_job", "staged_job"])
def test_window_on_the_card_equals_the_cpu_window(card, staged):
    """One W=4 window at 240x320, same draws on both devices: every integer
    word of the wire equal (ids, meta, pt words off the LK rows, counters,
    visibility), poses within 1e-4, and one score_candidates launch per
    frame of the window."""
    import dataclasses

    from movslam_tpu_torch.ops import frame_step, window_step

    W, N, P = 4, 512, 1024
    c = window_case(5, W, N, P)
    kw = dict(n_mvs=c["n_mvs"], reproj_err=5.0, threshold=25.0, coverage_threshold=0.2, capacity=N,
              max_cov=512)

    def run(dev):
        to = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
        st = type(c["st0"])(**{f.name: getattr(c["st0"], f.name).to(dev) for f in dataclasses.fields(c["st0"])})
        extra = {}
        if staged:
            tri = c["job"]["tri_wire"].copy()
            tri[0, 30] = 1.0
            extra = dict(patch_meta=to(c["meta"]), mtri=to(tri), mba=to(c["job"]["ba_wire"]))
        return window_step.tracked_window_step(
            to(c["imgs"]), to(c["prev_img"]), st, to(c["mvk"]), to(c["pose_pack"]), to(c["snap"]),
            to(c["intr"]), _cpu_draws(5), **extra, **kw)

    want = run("cpu")
    before = kernels.score_candidates.launches
    got = run(card)
    torch.cuda.synchronize()
    assert kernels.score_candidates.launches == before + W
    assert got["wire"].is_cuda and got["desc_w"].is_cuda and got["pose_carry"].is_cuda
    C = frame_step.packed_cols()
    w, g = want["wire"].numpy(), got["wire"].cpu().numpy()
    assert w.shape == g.shape
    o1 = W * N * C
    o2 = o1 + W * 16
    o3 = o2 + W * (P // 32)
    wp, gp = w[:o1].reshape(W, N, C), g[:o1].reshape(W, N, C)
    assert np.array_equal(gp[:, :, 1], wp[:, :, 1]) and np.array_equal(gp[:, :, 2], wp[:, :, 2])
    lk = ((wp[:, :, 2] >> 25) & 8) != 0
    assert np.array_equal(gp[~lk][:, 0], wp[~lk][:, 0])
    ws, gs = w[o1:o2].reshape(W, 16), g[o1:o2].reshape(W, 16)
    assert (ws[:, 14] == 1).all() and np.array_equal(gs[:, 12:], ws[:, 12:])
    assert np.abs(gs[:, :12].copy().view(np.float32) - ws[:, :12].copy().view(np.float32)).max() < 1e-4
    assert np.array_equal(g[o2:o3], w[o2:o3])
    assert np.array_equal(got["desc_w"].cpu().numpy(), want["desc_w"].numpy())
    if staged:
        midx = ((gp[:, :, 2] >> 12) & 0x1FFF) - 1
        assert (midx >= c["n_base"]).sum() >= 5
        assert np.abs(g[o3:].copy().view(np.float32)[3 * 1024:] - w[o3:].copy().view(np.float32)[3 * 1024:]).max() < 1e-3


def test_windowed_drive_runs_through_the_kernel(card):
    from movslam_tpu_torch.config.settings import MONOCULAR, Settings
    from movslam_tpu_torch.core.camera import Pinhole
    from movslam_tpu_torch.core.system import System
    from movslam_tpu_torch.io.synthetic import SyntheticStream

    s = Settings()
    s.camera1 = Pinhole(320.0, 320.0, 320.0, 240.0, 640, 480)
    system = System(s, MONOCULAR, device="cuda")
    stream = SyntheticStream(n_points=400, seed=42)
    items = [(f.timestamp, f) for f in (stream.frame(k) for k in range(24))]
    before = kernels.score_candidates.launches
    poses = []
    for k in range(0, 24, 8):
        poses += system.track_monocular_batch(items[k:k + 8], flush=False)
    poses += system.track_monocular_batch([], flush=True)
    system.shutdown()
    torch.cuda.synchronize()
    assert len(poses) == 24 and system.image_count == 24 and system.get_total_lost() == 0
    assert system.counts["windows"] >= 2 and system._prev_state.pt.is_cuda
    assert (kernels.score_candidates.launches - before
            == system.counts["window_frames"] + system.counts["per_frame_p"])
