"""Port parity: parallel/sharded_ba.py and parallel/gba.py on two gloo ranks
(CPU processes spawned over a FileStore in tmp_path; tests/_torch_dist.py)
against the port's single-device solvers and the reference's
make_sharded_ba on the virtual CPU mesh. Tolerances are
tests/test_parallel.py::test_sharded_ba_matches_single_device's: t 5e-3,
points 5e-2 (weakly constrained depths amplify summation-order
differences), final cost <= 1.1 x single + 1e-3."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from movslam_tpu.parallel.mesh import make_mesh
from movslam_tpu.parallel.sharded_ba import make_sharded_ba as jax_sharded_ba
from movslam_tpu_torch.core import camera, map as pmap
from movslam_tpu_torch.core.system import System
from movslam_tpu_torch.core.verbose import Verbose
from movslam_tpu_torch.config.settings import MONOCULAR
from movslam_tpu_torch.io.synthetic import SyntheticStream
from movslam_tpu_torch.ops.ba import ba_solve
from movslam_tpu_torch.parallel import gba, mesh, multistream, sharded_ba
from tests import _torch_dist as td
from tests._torch_parity import gba_map

Verbose.level = Verbose.QUIET
ITERS = 8  # test_parallel.py's


@pytest.fixture(scope="module")
def case():
    return td.sharded_ba_case(np.random.default_rng(12345))


@pytest.fixture(scope="module")
def port_two_ranks(case, tmp_path_factory):
    return td.run(2, td.sharded_ba_rank, tmp_path_factory.mktemp("sba"), case, ITERS)


def _single(case):
    T = torch.as_tensor
    return ba_solve(T(case["kf_R"]), T(case["kf_t"]), T(case["kf_fixed"]), T(case["kf_valid"]),
                    T(case["mp_pos"]), T(case["mp_valid"]), T(case["obs_kf"]), T(case["obs_mp"]),
                    T(case["obs_uv"]), T(case["obs_valid"]), T(case["obp_single"]), *case["intr"],
                    iters=ITERS)


def _check(t_sh, X_sh, costs, t_ref, X_ref, cost_ref):
    np.testing.assert_allclose(t_sh, t_ref, atol=5e-3)
    np.testing.assert_allclose(X_sh, X_ref, atol=5e-2)
    assert costs[-1] <= costs[0]
    assert costs[-1] <= cost_ref * 1.1 + 1e-3


def test_sharded_ba_matches_single_device(case, port_two_ranks):
    (R0, t0, X0, c0), (R1, t1, X1, c1) = port_two_ranks
    # every rank solved the same camera system and took the same decisions
    assert np.array_equal(R0, R1) and np.array_equal(t0, t1) and np.array_equal(c0, c1)
    res = _single(case)
    _check(t0, np.concatenate([X0, X1]), c0, res["kf_t"].numpy(), res["mp_pos"].numpy(),
           float(res["cost"]))


def test_sharded_ba_matches_jax_mesh(case, port_two_ranks):
    obs_mp, obp = td.local_indices(case, 2)
    J = jnp.asarray
    R, t, X, costs = jax_sharded_ba(make_mesh(2), iters=ITERS)(
        J(case["kf_R"]), J(case["kf_t"]), J(case["kf_fixed"]), J(case["kf_valid"]),
        J(case["mp_pos"]), J(case["mp_valid"]), J(case["obs_kf"]), J(obs_mp), J(case["obs_uv"]),
        J(case["obs_valid"]), J(obp), *case["intr"])
    (_, t0, X0, c0), (_, _, X1, _) = port_two_ranks
    costs = np.asarray(costs)
    _check(t0, np.concatenate([X0, X1]), c0, np.asarray(t), np.asarray(X), float(costs[-1]))
    # the same cost trend: each iteration's trial cost within 1% of the reference's
    np.testing.assert_allclose(c0, costs, rtol=1e-2)


DRIVE_CAMERA = (320.0, 320.0, 320.0, 240.0, 640, 480)


def test_system_gba_over_two_ranks_matches_one_device(tmp_path):
    """tests/test_gba_sharded.py on two ranks, with a 16-frame drive whose
    keyframes but the first are moved by ~1 cm: both ranks load one
    checkpoint and end with identical maps, which agree with mesh=None (10
    LM iterations) once mono BA's free scale about the fixed keyframe is
    removed (tests/test_torch_gba_sharded.py says why)."""
    stream = SyntheticStream(n_points=400, seed=17)
    system = System(td.camera_settings(DRIVE_CAMERA), MONOCULAR, device="cpu")
    items = [(f.timestamp, f) for f in stream.frames(16)]
    for k in range(0, len(items), 8):
        system.track_monocular_batch(items[k:k + 8], flush=False)
    system.track_monocular_batch([], flush=True)
    system.mapper.spin(final=True)
    assert system.get_total_lost() == 0 and system.atlas.current.n_keyframes() >= 4
    td.perturb_poses(system.atlas.current)
    path = str(tmp_path / "map.atlas")
    system.save_atlas(path)
    before = td.map_state(system.atlas.current)

    a, b = td.run(2, td.gba_rank, tmp_path, path, 10, DRIVE_CAMERA)
    for k in a["kf"]:
        assert np.array_equal(a["kf"][k][0], b["kf"][k][0]) and np.array_equal(a["kf"][k][1], b["kf"][k][1])
    assert all(np.array_equal(a["mp"][k], b["mp"][k]) for k in a["mp"]) and a["obs"] == b["obs"]

    system.global_bundle_adjustment(iters=10)  # mesh=None on the same map
    one = td.map_state(system.atlas.current)
    assert a["obs"] == one["obs"] and set(a["kf"]) == set(one["kf"]) == set(before["kf"])
    kfs, ids = sorted(one["kf"]), sorted(one["mp"])
    _, t_s, X_s = td.remove_scale_gauge(a, one, kfs, ids)
    np.testing.assert_allclose(t_s, [one["kf"][k][1] for k in kfs], atol=5e-3)
    np.testing.assert_allclose([a["kf"][k][0] for k in kfs], [one["kf"][k][0] for k in kfs], atol=5e-3)
    np.testing.assert_allclose(X_s, [one["mp"][k] for k in ids], atol=5e-2)
    moved = max(np.abs(before["kf"][k][1] - one["kf"][k][1]).max() for k in kfs)
    assert moved > 1e-4  # the solve did move the keyframes


def test_sharded_gba_drops_the_stereo_row(tmp_path):
    """The reference's mesh path takes bf and never passes it on (ROADMAP
    Queue 3): on a map with a stereo row the sharded solve equals its own
    bf = 0 solve, while one device uses the row."""
    results = td.run(1, td.stereo_gba_rank, tmp_path)
    assert results[0]


def test_parallel_refuses_to_run_without_a_group():
    with pytest.raises(RuntimeError, match="process group"):
        sharded_ba.make_sharded_ba()
    with pytest.raises(RuntimeError, match="process group"):
        mesh.shard_range(8)
    m, cam, _ = gba_map(pmap, camera, n_kf=4, n_mp=40)
    with pytest.raises(RuntimeError, match="process group"):
        gba.global_bundle_adjustment_sharded(m, cam, device="cpu")
    fn = multistream.make_multistream_propagate("cpu", group=object())
    with pytest.raises(RuntimeError, match="process group"):
        fn(*[np.zeros((2, 1))] * 11, 25.0)
