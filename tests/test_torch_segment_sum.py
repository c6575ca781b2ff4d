"""The ordered segment sum of the port's BA and pose graph (ops/kernels.py::
segment_plan, segment_sum; csrc/segment_sum.cu on the card) on the CPU.

The card's kernel sums each segment's rows in increasing row order, which is
the order CPU index_add_ takes; the first test guards that premise, which
the card tests (tests/test_torch_cuda.py) and chip_smoke.py's bit-equality
gate rely on. The others hold the plan, the plain version and the solvers'
ordered path (ops/ba._ordered forced on the CPU) against index_add_, bit for
bit."""
import numpy as np
import pytest
import torch

from movslam_tpu_torch.ops import ba, kernels, posegraph
from tests._torch_parity import mapper_job_case, ring_graph


def _spread(rng, shape):
    """f32 values whose sum depends on its order (magnitudes 1e-4 to 1e4)."""
    mag = 10.0 ** rng.uniform(-4, 4, (shape[0],) + (1,) * (len(shape) - 1))
    return (rng.normal(size=shape) * mag).astype(np.float32)


def _loop_sum(x, idx, n, order):
    out = np.zeros((n,) + x.shape[1:], np.float32)
    for i in order:
        out[idx[i]] += x[i]  # one float32 add per element
    return out


@pytest.mark.parametrize("threads", [1, 4])
def test_cpu_index_add_is_a_sequential_loop_in_row_order(threads):
    rng = np.random.default_rng(threads)
    R, C, n = 20_000, 36, 64
    x, idx = _spread(rng, (R, C)), rng.integers(0, n, R)
    forward = _loop_sum(x, idx, n, range(R))
    assert not np.array_equal(forward, _loop_sum(x, idx, n, range(R - 1, -1, -1)))  # the order shows
    old = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        got = torch.zeros((n, C)).index_add_(0, torch.as_tensor(idx), torch.as_tensor(x))
    finally:
        torch.set_num_threads(old)
    assert np.array_equal(got.numpy(), forward)


def test_plan_is_a_stable_argsort_of_the_segments():
    rng = np.random.default_rng(0)
    R, n = 5000, 300
    idx = rng.integers(0, n - 50, R)  # empty segments at the end
    plan = kernels.segment_plan(torch.as_tensor(idx), n)
    assert plan.perm.dtype == plan.offsets.dtype == torch.int32 and plan.n == n
    assert np.array_equal(plan.perm.numpy(), np.argsort(idx, kind="stable"))
    assert np.array_equal(plan.offsets.numpy(), np.concatenate([[0], np.cumsum(np.bincount(idx, minlength=n))]))
    keep = rng.random(R) < 0.5
    masked = kernels.segment_plan(torch.as_tensor(idx), n, torch.as_tensor(keep))
    rows = np.flatnonzero(keep)
    kept = masked.offsets[-1].item()
    assert kept == keep.sum()
    assert np.array_equal(masked.perm[:kept].numpy(), rows[np.argsort(idx[rows], kind="stable")])
    assert not keep[masked.perm[kept:].numpy()].any()  # left-out rows sort past the last segment


@pytest.mark.parametrize("trail", [(3,), (6,), (3, 3), (6, 6)], ids=["C3", "C6", "C9", "C36"])
@pytest.mark.parametrize("masked", [False, True], ids=["every_row", "rows_left_out"])
def test_segment_sum_equals_index_add(trail, masked):
    rng = np.random.default_rng(len(trail) + 7 * masked)
    R, n = 4000, 500
    idx = rng.integers(0, n - 40, R)
    x = _spread(rng, (R,) + trail)
    keep = rng.random(R) < 0.6 if masked else np.ones(R, bool)
    x[~keep] = 0.0  # rows a plan leaves out carry zeros, as the BA's padding does
    plan = kernels.segment_plan(torch.as_tensor(idx), n, torch.as_tensor(keep) if masked else None)
    before = kernels.segment_sum.launches
    got = kernels.segment_sum(torch.as_tensor(x), plan)
    assert kernels.segment_sum.launches == before  # the CPU runs the plain version
    want = torch.zeros((n,) + trail).index_add_(0, torch.as_tensor(idx), torch.as_tensor(x))
    assert got.shape == (n,) + trail and torch.equal(got, want)
    assert torch.equal(ba._segment_sum(torch.as_tensor(x), torch.as_tensor(idx), n), want)


def test_segment_sum_refuses_what_the_plan_does_not_match():
    plan = kernels.segment_plan(torch.zeros(8, dtype=torch.int64), 4)
    with pytest.raises(ValueError):
        kernels.segment_sum(torch.zeros((7, 6)), plan)
    with pytest.raises(TypeError):
        kernels.segment_sum(torch.zeros((8, 6)), kernels.SegmentPlan(plan.perm.long(), plan.offsets, 4))


def _ba_wire(seed, stereo):
    c = mapper_job_case(seed, C=64, K=16, P=256, O=1024, n_kf=6, n_pts=120)
    if stereo:  # a right-image column on half of the observations
        obs = c["ba_wire"][16 * 14 + 256 * 4:16 * 14 + 256 * 4 + 1024 * 6].reshape(1024, 6)
        obs[::2, 4] = np.where(obs[::2, 5] > 0, obs[::2, 2] - 4.0, -1.0)
    return c


@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
def test_ba_solve_ordered_path_equals_index_add(monkeypatch, stereo):
    """ops/ba.ba_solve with the card's plans (padding observations and pad
    pairs left out) gives the index_add_ path's bits on the CPU."""
    c = _ba_wire(3, stereo)

    def run():
        return ba.ba_solve_wire(torch.as_tensor(c["ba_wire"]), [float(v) for v in c["intr"]],
                                40.0 if stereo else 0.0, K=16, P=256, O=1024, MOPP=16)

    want = run()
    monkeypatch.setattr(ba, "_ordered", lambda x: True)
    got = run()
    assert torch.equal(got, want)


def test_pose_graph_ordered_path_equals_index_add(monkeypatch):
    args = [torch.as_tensor(a) for a in ring_graph(np.random.default_rng(0))[0]]
    want = posegraph.pose_graph_solve(*args)
    monkeypatch.setattr(ba, "_ordered", lambda x: True)
    got = posegraph.pose_graph_solve(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_schur_pieces_build_their_plans_when_none_is_passed(monkeypatch):
    """visual_linearize, schur_reduce and backsub_landmarks without plans
    (other callers) build their own and give the same bits."""
    monkeypatch.setattr(ba, "_ordered", lambda x: True)
    c = mapper_job_case(5, C=64, K=16, P=256, O=1024, n_kf=6, n_pts=120)
    wire = torch.as_tensor(c["ba_wire"])
    K, P, O = 16, 256, 1024
    kf = wire[:K * 14].reshape(K, 14)
    mp = wire[K * 14:K * 14 + P * 4].reshape(P, 4)
    ob = wire[K * 14 + P * 4:K * 14 + P * 4 + O * 6].reshape(O, 6)
    obp = wire[K * 14 + P * 4 + O * 6:].reshape(P, 16).to(torch.int64)
    okf, omp, valid = ob[:, 0].long(), ob[:, 1].long(), ob[:, 5] > 0
    R, t, X = kf[:, :9].reshape(K, 3, 3), kf[:, 9:12], mp[:, :3]
    w = valid.float()
    free = torch.ones((O, 1, 1))
    fx, fy, cx, cy = (float(v) for v in c["intr"])
    plans = ba.segment_plans(okf, omp, valid, obp, K, P, O)
    outs = []
    for p in (plans, None):
        lin = ba.visual_linearize(R, t, X, okf, omp, ob[:, 2:4], w, free, fx, fy, cx, cy, None, 0.0, K, P, p)
        S, rhs, Hinv = ba.schur_reduce(lin["W"], lin["g_p"], lin["g_l"], lin["Hpp"], lin["Hll"], okf, omp, obp,
                                       torch.tensor(1e-4), K, P, O, plans=p)
        dX = ba.backsub_landmarks(torch.full((K, 6), 1e-3), lin["W"], Hinv, lin["g_l"], okf, omp, P,
                                  mp[:, 3] > 0, p)
        outs.append([lin["g_p"], lin["g_l"], lin["Hpp"], lin["Hll"], S, rhs, dX])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_vi_ba_ordered_path_builds_its_plans_once(monkeypatch):
    """ops/vi_ba.vi_ba_solve on tests/test_vi_ba.py's scene: the ordered
    path gives the index_add_ path's bits, with one set of plans for the
    whole LM loop (three segment_plan calls)."""
    from tests import test_torch_vi_ba as tv

    sc = tv.ref._scene()
    win = tv._windows(sc["times"])

    def run():
        return tv._port_solve(sc, tv._port_pres(win), sc["kf_R"], sc["kf_t"] + 0.01, sc["v"], sc["X"], iters=4)

    want = run()
    calls = []
    plan = kernels.segment_plan
    monkeypatch.setattr(ba, "_ordered", lambda x: True)
    monkeypatch.setattr(ba, "segment_plan", lambda *a, **k: calls.append(1) or plan(*a, **k))
    got = run()
    assert len(calls) == 3
    assert all(np.array_equal(got[k], want[k]) for k in want)
