"""The ordered segment sum of the port's BA and pose graph (ops/kernels.py::
segment_plan, segment_sum; csrc/segment_sum.cu on the card) on the CPU.

The card's kernel sums each segment's rows in increasing row order, which is
the order CPU index_add_ takes; the first test guards that premise, which
the card tests (tests/test_torch_cuda.py) and chip_smoke.py's bit-equality
gate rely on. The others hold the plan, the plain version, the grouped entry
point segment_sums and the solvers' ordered path (ops/ba._ordered forced on
the CPU) against index_add_, bit for bit, and count the groups the solvers
launch."""
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


SUMS_JOBS = [  # (R, n, trailing shape, segments in use, share of rows kept)
    (4096, 48, (6,), 11, 0.7), (4096, 1024, (3,), 1024, 0.7), (3000, 300, (6, 6), 250, 1.0),
    (500, 7, (), 7, 0.5),
]


@pytest.mark.parametrize("count", [1, 2, 3, 4])
def test_segment_sums_ref_equals_index_add_job_by_job(count):
    """segment_sums over 1-4 jobs of different plans, segment counts and C
    (its plain version on the CPU, segment_sums_ref) equals index_add_ job
    by job, bit for bit, and launches nothing."""
    rng = np.random.default_rng(count)
    jobs, wants = [], []
    for R, n, trail, used, kept in SUMS_JOBS[:count]:
        idx = rng.integers(0, used, R)
        x = _spread(rng, (R,) + trail)
        keep = rng.random(R) < kept
        x[~keep] = 0.0
        jobs.append((torch.as_tensor(x), kernels.segment_plan(torch.as_tensor(idx), n, torch.as_tensor(keep))))
        wants.append(torch.zeros((n,) + trail).index_add_(0, torch.as_tensor(idx), torch.as_tensor(x)))
    before = kernels.segment_sum.launches
    for got in (kernels.segment_sums(jobs), kernels.segment_sums_ref(jobs)):
        assert len(got) == count and all(g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, wants))
    assert kernels.segment_sum.launches == before


def test_segment_sums_refuses_what_a_kernel_would_not_take():
    """More than four jobs, jobs on different devices, x and plan on
    different devices, rows that disagree with the plan, and (past the CPU,
    here the meta device) a non-f32 or strided x, or a device that is not
    CUDA."""
    plan = kernels.segment_plan(torch.zeros(8, dtype=torch.int64), 4)
    x = torch.zeros((8, 6))
    with pytest.raises(ValueError, match="at most 4"):
        kernels.segment_sums([(x, plan)] * 5)
    meta_plan = kernels.SegmentPlan(plan.perm.to("meta"), plan.offsets.to("meta"), 4)
    with pytest.raises(ValueError, match="different devices"):
        kernels.segment_sums([(x, plan), (x.to("meta"), meta_plan)])
    with pytest.raises(ValueError, match="different devices"):
        kernels.segment_sums([(x.to("meta"), plan)])
    with pytest.raises(ValueError, match="does not match"):
        kernels.segment_sums([(x, plan), (x[:7], plan)])
    with pytest.raises(TypeError, match="float32"):
        kernels.segment_sums([(x.to("meta", torch.float64), meta_plan)])
    with pytest.raises(ValueError, match="contiguous"):
        kernels.segment_sums([(torch.zeros((6, 8), device="meta").t(), meta_plan)])
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernels.segment_sums([(x.to("meta"), meta_plan)])
    assert kernels.segment_sums([]) == []


def _count_groups(monkeypatch):
    """Force the card's ordered path on the CPU and record the number of
    jobs of every kernels.segment_sums call."""
    calls = []
    sums = kernels.segment_sums
    monkeypatch.setattr(ba, "_ordered", lambda x: True)
    monkeypatch.setattr(kernels, "segment_sums", lambda jobs: calls.append(len(jobs)) or sums(jobs))
    return calls


@pytest.mark.parametrize("iters", [10, 3])
def test_ba_solve_makes_one_launch_per_group(monkeypatch, iters):
    """An ordered ba_solve makes 1 + 3 iters segment_sums calls carrying
    4 + 7 iters jobs (31 and 74 at 10 LM iterations): the linearization's
    four sums, the Schur reduction's two and the back-substitution's one."""
    c = _ba_wire(3, False)
    calls = _count_groups(monkeypatch)
    ba.ba_solve_wire(torch.as_tensor(c["ba_wire"]), [float(v) for v in c["intr"]], 0.0,
                     K=16, P=256, O=1024, MOPP=16, iters=iters)
    assert len(calls) == 1 + 3 * iters and sum(calls) == 4 + 7 * iters
    assert calls[0] == 4 and calls[1:4] == [2, 1, 4]


@pytest.mark.parametrize("iters", [20, 5])
def test_pose_graph_makes_one_launch_per_linearization(monkeypatch, iters):
    """An ordered pose_graph_solve makes 1 + iters segment_sums calls of two
    jobs (H and g): 21 calls and 42 jobs at 20 LM iterations."""
    args = [torch.as_tensor(a) for a in ring_graph(np.random.default_rng(0))[0]]
    calls = _count_groups(monkeypatch)
    posegraph.pose_graph_solve(*args, iters=iters)
    assert calls == [2] * (1 + iters)


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
