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
from tests._torch_parity import (
    candidate_case, gba_map, ring_graph, stereo_settings, stereo_window_case, stereo_words, window_case,
)

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


def test_stereo_window_on_the_card_equals_the_cpu_window(card):
    """One stereo W=4 window at 240x320, same draws on both devices: id and
    meta words, counters and visibility equal; the depth and ur words' -1.0
    sentinels (the gate masks) equal, ur within 1e-3 px and depth within 1e-3
    relative; poses within 1e-4; one score_candidates launch per left frame."""
    import dataclasses

    from movslam_tpu_torch.ops import frame_step, window_step

    W, N, P = 4, 512, 1024
    c = stereo_window_case(5, W, N, P)
    kw = dict(n_mvs=c["n_mvs"], reproj_err=5.0, threshold=25.0, coverage_threshold=0.2, capacity=N,
              max_cov=512, has_stereo=True)

    def run(dev):
        to = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
        st = type(c["st0"])(**{f.name: getattr(c["st0"], f.name).to(dev) for f in dataclasses.fields(c["st0"])})
        tri = c["job"]["tri_wire"].copy()
        tri[0, 30] = 1.0
        return window_step.tracked_window_step(
            to(c["imgs"]), to(c["prev_img"]), st, to(c["mvk"]), to(c["pose_pack"]), to(c["snap"]),
            to(c["intr"]), _cpu_draws(5), to(c["dist_pack"]), to(c["imgs_right"]),
            patch_meta=to(c["meta"]), mtri=to(tri), mba=to(c["job"]["ba_wire"]), **kw)

    want = run("cpu")
    before = kernels.score_candidates.launches
    got = run(card)
    torch.cuda.synchronize()
    assert kernels.score_candidates.launches == before + W  # the right frames are never extracted
    C = frame_step.packed_cols(False, True)
    w, g = want["wire"].numpy(), got["wire"].cpu().numpy()
    assert w.shape == g.shape
    o1 = W * N * C
    o2 = o1 + W * 16
    o3 = o2 + W * (P // 32)
    wp, gp = w[:o1].reshape(W, N, C), g[:o1].reshape(W, N, C)
    assert np.array_equal(gp[:, :, 1], wp[:, :, 1]) and np.array_equal(gp[:, :, 2], wp[:, :, 2])
    (gd, gu), (wd, wu) = stereo_words(gp), stereo_words(wp)
    assert np.array_equal(gd == -1.0, wd == -1.0) and np.array_equal(gu == -1.0, wu == -1.0)
    have = wd != -1.0
    assert have.sum() > 100
    assert np.abs(gu[have] - wu[have]).max() < 1e-3
    assert np.abs(gd[have] / wd[have] - 1.0).max() < 1e-3
    ws, gs = w[o1:o2].reshape(W, 16), g[o1:o2].reshape(W, 16)
    assert (ws[:, 14] == 1).all() and np.array_equal(gs[:, 12:], ws[:, 12:])
    assert np.abs(gs[:, :12].copy().view(np.float32) - ws[:, :12].copy().view(np.float32)).max() < 1e-4
    assert np.array_equal(g[o2:o3], w[o2:o3])


def test_stereo_system_defaults_to_the_card(card):
    """System(settings, STEREO) without device= runs on the card: 12 pairs
    per frame, then a batch of 8 through the windowed drive."""
    from movslam_tpu_torch.core.system import System
    from movslam_tpu_torch.io.synthetic_stereo import SyntheticStereoStream

    system = System(stereo_settings(), System.STEREO)
    assert system.device.type == "cuda"
    items = [(left.timestamp, left, right) for left, right in SyntheticStereoStream(seed=5).pairs(20)]
    before = kernels.score_candidates.launches
    for it in items[:12]:
        system.track_stereo(*it)
    assert system.tracking.state.name == "OK" and system._prev_state.pt.is_cuda
    poses = system.track_stereo_batch(items[12:])
    system.shutdown()
    torch.cuda.synchronize()
    assert len(poses) == 8 and system.image_count == 20 and system.get_total_lost() == 0
    assert system.counts["windows"] >= 1
    assert (kernels.score_candidates.launches - before
            == system.counts["window_frames"] + system.counts["per_frame_p"])
    assert all(kf.depth_right is not None for kf in system.atlas.current.keyframes.values())


def test_vi_back_end_on_the_card_agrees_with_the_cpu(card):
    """preintegrate and the gravity/scale solve on the card against the same
    calls on the CPU, on tests/test_posegraph_imu.py's circle (constant speed,
    identity attitude, gravity tilted, the map shrunk by 2.5; 8 windows of 100
    samples, 12 LM iterations). The samples are exact, so the solve's final
    cost is the f32 preintegration's own discretization error, 1.662e-7 on a
    CPU host in both packages (JAX 1.6623e-7): a path that reads far below it
    fits something else. Bounds: the preintegration within 1e-4 relative;
    scale within 1e-3 relative and 2% of the truth; gravity direction, the
    velocities (~1.2 m/s) and the biases (~1e-5) within 1e-4 absolute; the
    final cost within 1% of the CPU's. The readings are printed (-s)."""
    from movslam_tpu_torch.ops import imu, lie

    s_true, r_c, omega, imu_dt, per_win, K = 2.5, 2.0, 0.6, 0.005, 100, 9
    g_w = lie.so3_exp(torch.tensor([0.06, -0.04, 0.0], dtype=torch.float64)).numpy() @ [0.0, 0.0, -9.81]
    tt = np.arange((K - 1) * per_win).reshape(K - 1, per_win) * imu_dt
    a_w = -r_c * omega ** 2 * np.stack([np.cos(omega * tt), np.sin(omega * tt), np.zeros_like(tt)], -1)
    acc = (a_w - g_w).astype(np.float32)
    tk = np.arange(K) * per_win * imu_dt
    ps = (np.stack([r_c * np.cos(omega * tk), r_c * np.sin(omega * tk), np.zeros(K)], -1) / s_true)
    vs = r_c * omega * np.stack([-np.sin(omega * tk), np.cos(omega * tk), np.zeros(K)], -1)
    inputs = (np.zeros_like(acc), acc, np.full((K - 1, per_win), imu_dt, np.float32),
              np.ones((K - 1, per_win), bool), np.zeros(3, np.float32), np.zeros(3, np.float32))
    out = {}
    for dev in ("cpu", card):
        args = [torch.as_tensor(x, device=dev) for x in inputs]
        pres = imu.preintegrate(*args)
        res = imu.inertial_gs_optimize(
            pres, torch.eye(3, device=dev).repeat(K, 1, 1), torch.as_tensor(ps, dtype=torch.float32, device=dev),
            torch.as_tensor(vs, dtype=torch.float32, device=dev), args[4], args[5],
            torch.ones(K - 1, dtype=torch.bool, device=dev), iters=12)
        out[str(dev)] = ({k: v.cpu().numpy() for k, v in pres.items()}, {k: v.cpu().numpy() for k, v in res.items()})
        print(f"{dev}: costs {out[str(dev)][1]['costs'].tolist()} scale {float(res['scale'])} "
              f"bg {out[str(dev)][1]['bg'].tolist()} ba {out[str(dev)][1]['ba'].tolist()}")
    (pc, rc), (pg, rg) = out["cpu"], out[str(card)]
    for k in pc:
        np.testing.assert_allclose(pg[k], pc[k], rtol=1e-4, atol=1e-4 * max(np.abs(pc[k]).max(), 1e-30))
    sc, sg = float(rc["scale"]), float(rg["scale"])
    assert abs(sc / s_true - 1.0) < 0.02 and abs(sg / sc - 1.0) < 1e-3, (sc, sg)
    for k in ("Rwg", "vel", "bg", "ba"):
        print(f"{k}: max |card - cpu| {np.abs(rg[k] - rc[k]).max():.3e}")
        np.testing.assert_allclose(rg[k], rc[k], rtol=0, atol=1e-4, err_msg=k)
    assert abs(rg["costs"][-1] / rc["costs"][-1] - 1.0) < 1e-2, (rg["costs"], rc["costs"])


def test_vi_system_defaults_to_the_card(card):
    """System(settings, IMU_MONOCULAR) without device= runs on the card: 14
    frames per frame with IMU samples, then 16 through the windowed drive, the
    init moved earlier (vi_min_kfs = 4) so that it runs on the card."""
    from movslam_tpu_torch.config.settings import IMU_MONOCULAR, Settings
    from movslam_tpu_torch.core.camera import Pinhole
    from movslam_tpu_torch.core.system import System
    from movslam_tpu_torch.io.synthetic_vi import SyntheticVIStream

    s = Settings()
    s.camera1 = Pinhole(320.0, 320.0, 320.0, 240.0, 640, 480)
    s.sensor = IMU_MONOCULAR
    system = System(s, IMU_MONOCULAR)
    assert system.device.type == "cuda"
    system.mapper.vi_min_kfs = 4
    items = list(SyntheticVIStream(n_points=400, seed=11).items(30))
    before = kernels.score_candidates.launches
    for ts, smv, imu in items[:14]:
        system.track_monocular(ts, smv, imu=imu)
    poses = system.track_monocular_batch(items[14:])
    system.shutdown()
    torch.cuda.synchronize()
    assert system.atlas.current.imu_initialized and system.get_total_lost() == 0
    assert len(poses) == 16 and system.image_count == 30
    assert sorted(system.imu_buffer.by_frame) == list(range(1, 30))
    assert (kernels.score_candidates.launches - before
            == system.counts["window_frames"] + system.counts["per_frame_p"])


def test_pose_graph_on_the_card_agrees_with_the_cpu(card):
    """ops/posegraph.pose_graph_solve on tests/test_posegraph_imu.py's ring
    (12 nodes, 20 LM iterations) on the card and on the CPU. The card's
    segment sums take the CPU's order, but its matmuls, jacfwd and Cholesky
    round differently, so the poses are held within 1e-4, not bit for bit;
    both close the loop (final cost < 1e-3). Printed (-s)."""
    from movslam_tpu_torch.ops import posegraph

    args, R_gt, t_gt = ring_graph(np.random.default_rng(12345))
    out = {}
    for dev in ("cpu", card):
        res = posegraph.pose_graph_solve(*[torch.as_tensor(a, device=dev) for a in args])
        out[str(dev)] = [x.cpu().numpy() for x in res]
    (Rc, tc, cc), (Rg, tg, cg) = out["cpu"], out[str(card)]
    print(f"pose graph: max |card - cpu| R {np.abs(Rg - Rc).max():.3e} t {np.abs(tg - tc).max():.3e}, "
          f"final cost card {cg[-1]:.3e} cpu {cc[-1]:.3e}")
    assert cg[-1] < 1e-3 and cc[-1] < 1e-3
    np.testing.assert_allclose(Rg, Rc, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tg, tc, rtol=0, atol=1e-4)
    assert np.abs(tg - t_gt).max() < 2e-2


def test_global_ba_on_the_card_agrees_with_the_cpu(card):
    """core/local_mapping.global_bundle_adjustment of one 40-keyframe map with
    a stereo row (bf = 80; the K = 48 bucket) on the card and on the CPU:
    keyframe poses and points within 1e-4 and the same observations pruned.
    The stereo row fixes the scale: a monocular map's free scale gauge makes
    f32 solves part (tests/test_torch_global_ba.py). Printed (-s)."""
    from movslam_tpu_torch.core import camera, local_mapping, map as pmap

    out = {}
    for dev in ("cpu", card):
        m, cam, kfs = gba_map(pmap, camera, n_kf=40, n_mp=300, seed=3, bf=80.0)
        local_mapping.global_bundle_adjustment(m, cam, device=dev, bf=80.0, iters=10)
        pts = [m.mappoints[k] for k in sorted(m.mappoints)]
        out[str(dev)] = (np.stack([kf.R for kf in kfs]), np.stack([kf.t for kf in kfs]),
                         np.stack([mp.pos for mp in pts]), [len(mp.obs) for mp in pts])
    (Rc, tc, Xc, oc), (Rg, tg, Xg, og) = out["cpu"], out[str(card)]
    print(f"global BA: max |card - cpu| R {np.abs(Rg - Rc).max():.3e} t {np.abs(tg - tc).max():.3e} "
          f"points {np.abs(Xg - Xc).max():.3e}")
    assert og == oc
    for name, g, c in (("R", Rg, Rc), ("t", tg, tc), ("points", Xg, Xc)):
        np.testing.assert_allclose(g, c, rtol=0, atol=1e-4, err_msg=name)


def test_score_candidates_over_streams_matches_plain_version(card):
    """S = 8 streams in one launch against the plain version and against 8
    single-stream launches, bit-exact."""
    S, N, M = 8, 256, 512
    cases = [candidate_case(40 + s, H=480, W=640, N=N, M=M) for s in range(S)]
    singles = [kernels.score_candidates(*(torch.as_tensor(c[k], device=card) for k in CAND_ARGS), 25.0)
               for c in cases]
    cand = np.concatenate([np.where(c["cand"] >= 0, c["cand"] + s * M, -1) for s, c in enumerate(cases)])
    args = [torch.as_tensor(np.stack([c["img"] for c in cases]), device=card)]
    args += [torch.as_tensor(np.concatenate([c[k] for c in cases]), device=card) for k in CAND_ARGS[1:]]
    args[2] = torch.as_tensor(cand.astype(np.int32), device=card)
    before = kernels.score_candidates.launches
    got = kernels.score_candidates(*args, 25.0)
    torch.cuda.synchronize()
    assert kernels.score_candidates.launches == before + 1
    want = kernels.score_candidates_ref(*args, 25.0)
    offset = torch.as_tensor(np.repeat(np.arange(S) * M, N), dtype=torch.int32, device=card)
    mv = torch.cat([s[0] for s in singles])
    for name, g, w, one in zip(("mv", "new_pt", "dist", "desc", "inb"), got, want,
                               [torch.where(mv >= 0, mv + offset, mv)] + [torch.cat(x) for x in list(zip(*singles))[1:]]):
        assert g.dtype == w.dtype and torch.equal(g, w) and torch.equal(g, one), name


def test_sharded_ba_on_the_card_agrees_with_ba_solve(card):
    """parallel/sharded_ba.py on one NCCL rank (a HashStore, world size 1)
    against ops/ba.ba_solve on the card, at tests/test_parallel.py's
    tolerances. The case is monocular with one fixed keyframe, so its scale
    is free, and the two solvers sum in their own orders (the sharded BA
    adds the damping after its all-reduce), so they part along that scale
    (printed, -s). Poses and points are compared once the scale about the
    fixed keyframe is removed (parallel/gba.remove_scale_gauge)."""
    import torch.distributed as dist

    from movslam_tpu_torch.ops.ba import ba_solve
    from movslam_tpu_torch.parallel.gba import remove_scale_gauge
    from movslam_tpu_torch.parallel.sharded_ba import make_sharded_ba
    from tests._torch_dist import sharded_ba_case

    case = sharded_ba_case(np.random.default_rng(12345))
    T = lambda x: torch.as_tensor(x, device=card)  # noqa: E731
    base = [T(case[k]) for k in ("kf_R", "kf_t", "kf_fixed", "kf_valid", "mp_pos", "mp_valid",
                                 "obs_kf", "obs_mp", "obs_uv", "obs_valid", "obp_single")]
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        R, t, X, costs = make_sharded_ba(iters=8)(*base, *case["intr"])
    finally:
        dist.destroy_process_group()
    res = ba_solve(*base, *case["intr"], iters=8)
    again = ba_solve(*base, *case["intr"], iters=8)
    Ra, ta, Xa = (x.double().cpu().numpy() for x in (R, t, X))
    Rb, tb, Xb = (res[k].double().cpu().numpy() for k in ("kf_R", "kf_t", "mp_pos"))
    scale, t_s, X_s = remove_scale_gauge(Ra, ta, Xa, Rb, tb, 0)
    t2, X2 = (again[k].double().cpu().numpy() for k in ("kf_t", "mp_pos"))
    print(f"sharded vs ba_solve: max |t| {np.abs(ta - tb).max():.3e}, |X| {np.abs(Xa - Xb).max():.3e}; "
          f"scale {scale:.6f}, then |t| {np.abs(t_s - tb).max():.3e}, |X| {np.abs(X_s - Xb).max():.3e}; "
          f"ba_solve twice: |t| {np.abs(t2 - tb).max():.3e}, |X| {np.abs(X2 - Xb).max():.3e}")
    np.testing.assert_allclose(Ra, Rb, atol=5e-3)
    np.testing.assert_allclose(t_s, tb, atol=5e-3)
    np.testing.assert_allclose(X_s, Xb, atol=5e-2)
    costs = costs.cpu().numpy()
    assert costs[-1] <= costs[0] and costs[-1] <= float(res["cost"]) * 1.1 + 1e-3


def _spread(rng, shape):
    """f32 values whose sum depends on its order (magnitudes 1e-4 to 1e4)."""
    mag = 10.0 ** rng.uniform(-4, 4, (shape[0],) + (1,) * (len(shape) - 1))
    return (rng.normal(size=shape) * mag).astype(np.float32)


@pytest.mark.parametrize("trail", [(3,), (6,), (3, 3), (6, 6)], ids=["C3", "C6", "C9", "C36"])
@pytest.mark.parametrize("masked", [False, True], ids=["every_row", "rows_left_out"])
def test_segment_sum_is_bit_equal_to_cpu_index_add(card, trail, masked):
    """csrc/segment_sum.cu against CPU index_add_ over every row of the same
    inputs, bit for bit, with empty segments; where the plan leaves rows out
    they carry zeros, as the BA's padding does. Two launches agree."""
    rng = np.random.default_rng(len(trail) * 10 + masked)
    R, n = 50_000, 700
    idx = rng.integers(0, n - 100, R)  # the last 100 segments stay empty
    x = _spread(rng, (R,) + trail)
    keep = rng.random(R) < 0.7 if masked else np.ones(R, bool)
    x[~keep] = 0.0
    plan = kernels.segment_plan(torch.as_tensor(idx, device=card), n,
                                torch.as_tensor(keep, device=card) if masked else None)
    xd = torch.as_tensor(x, device=card)
    before = kernels.segment_sum.launches
    got, again = kernels.segment_sum(xd, plan), kernels.segment_sum(xd, plan)
    torch.cuda.synchronize()
    assert kernels.segment_sum.launches == before + 2
    want = torch.zeros((n,) + trail).index_add_(0, torch.as_tensor(idx), torch.as_tensor(x))
    assert torch.equal(got.cpu(), want) and torch.equal(got, again)


def test_segment_sum_refuses_bad_inputs(card):
    plan = kernels.segment_plan(torch.zeros(8, dtype=torch.int64, device=card), 4)
    x = torch.zeros((8, 6), device=card)
    with pytest.raises(ValueError):
        kernels.segment_sum(x.cpu(), plan)  # mixed devices
    with pytest.raises(ValueError):
        kernels.segment_sum(torch.zeros((6, 8), device=card).t(), plan)  # strided
    with pytest.raises(TypeError):
        kernels.segment_sum(x.double(), plan)
    with pytest.raises(ValueError):
        kernels.segment_sum(x[:7], plan)  # rows and plan disagree


def test_ba_solve_twice_is_bit_equal(card):
    """Two ops/ba.ba_solve calls on one monocular problem (a free scale) give
    the same bits on the card: its sums are ordered. A fresh problem and the
    pose graph too."""
    from movslam_tpu_torch.ops import posegraph
    from movslam_tpu_torch.ops.ba import ba_solve
    from tests._torch_dist import sharded_ba_case

    case = sharded_ba_case(np.random.default_rng(12345))
    args = [torch.as_tensor(case[k], device=card) for k in (
        "kf_R", "kf_t", "kf_fixed", "kf_valid", "mp_pos", "mp_valid", "obs_kf", "obs_mp", "obs_uv",
        "obs_valid", "obp_single")]
    a, b = (ba_solve(*args, *case["intr"], iters=8) for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    ring = [torch.as_tensor(x, device=card) for x in ring_graph(np.random.default_rng(12345))[0]]
    p, q = (posegraph.pose_graph_solve(*ring) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(p, q))


def test_windowed_drive_twice_gives_equal_wires(card):
    """The windowed drive of 24 frames twice with the same seed: every
    dispatched program's int32 wire and every pose bit-equal (chip_smoke.py
    gates the same on phase 3's per-frame drive)."""
    import chip_smoke
    from movslam_tpu_torch.config.settings import MONOCULAR, Settings
    from movslam_tpu_torch.core.camera import Pinhole
    from movslam_tpu_torch.core.system import System
    from movslam_tpu_torch.io.synthetic import SyntheticStream

    s = Settings()
    s.camera1 = Pinhole(320.0, 320.0, 320.0, 240.0, 640, 480)
    stream = SyntheticStream(n_points=400, seed=42)
    frames = [stream.frame(k) for k in range(24)]
    batches = [(0, 8, False), (8, 16, False), (16, 24, False), (0, 0, True)]
    runs = [chip_smoke.repro_drive(System, s, MONOCULAR, frames, batches)[1] for _ in range(2)]
    assert len(runs[0]["wires"]) >= 3 and runs[0]["wires"] == runs[1]["wires"]
    assert runs[0]["poses"] == runs[1]["poses"] and runs[0]["trajectory"] == runs[1]["trajectory"]
