"""The port's SE(3) helpers and pose graph (ops/lie.py se3_log / se3_inverse,
ops/posegraph.py) against the JAX package on the same numpy inputs.

Tolerances: se3_log / se3_inverse 1e-5 absolute (1e-3 near pi, where the
f32 arccos loses digits); edge residuals and Jacobians 1e-4 relative to their
largest entry; relaxed poses 1e-4 absolute.

se3_log is compared where f32 can evaluate the reference's formula: below
1e-4 rad (the series branch) and from 0.3 rad up. Between, its closed-form
branch divides the cancellation 1 - theta sin / (2 (1 - cos)) by theta^2, and
one ulp of cos moves the result by up to |t| (port vs JAX: 9.2 at 1e-4..1e-3
rad, 0.27 at 1e-3..1e-2, 3.6e-4 at 1e-2..0.1, 3.1e-5 at 0.1..0.3, on |t| ~ 2):
a fault of the reference (ROADMAP Queue 3) that the port keeps.

The reference's pose_graph_solve is jitted. On the XLA CPU backend the jitted
se3_log loses the EPS of (1 - cos) + EPS for 1e-8 < theta^2 < ~1e-7 and
divides by zero: the residual comes out inf/NaN, LM rejects the step, and the
jitted solve ends 1e-3 to 1e-2 away from the same function run op by op
(jax.disable_jit), which the port matches. Op by op the reference takes
~3.5 s per LM iteration on a CPU host, so tier 1 compares the first
iteration (its linearization, block assembly, solve and accept rule) and the
slow tier all twenty; the port's twenty are held to the reference test's own
bounds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movslam_tpu.ops import lie as jlie
from movslam_tpu.ops import posegraph as jpg
from movslam_tpu_torch.ops import lie, posegraph
from tests._torch_parity import assert_close, ring_graph, t, to_np


def _random_poses(rng, n, max_angle, min_angle=0.0):
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    phi = (axis * rng.uniform(min_angle, max_angle, (n, 1))).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray(phi)))
    return R, rng.normal(0, 2, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("min_angle,max_angle,atol", [
    (0.0, 1e-4, 1e-5), (0.3, 1.0, 1e-5), (1.0, 3.0, 1e-5), (3.0, np.pi - 1e-3, 1e-3)])
def test_se3_log_and_inverse_match_jax(min_angle, max_angle, atol):
    R, tr = _random_poses(np.random.default_rng(3), 256, max_angle, min_angle)
    assert_close(lie.se3_log(t(R), t(tr)), jlie.se3_log(jnp.asarray(R), jnp.asarray(tr)), atol, what="se3_log")
    Ri, ti = lie.se3_inverse(t(R), t(tr))
    Rj, tj = jlie.se3_inverse(jnp.asarray(R), jnp.asarray(tr))
    assert_close(Ri, Rj, 1e-6, what="R^T")
    assert_close(ti, tj, 1e-5, what="-R^T t")
    if max_angle < 3.0:  # the log inverts the exponential below pi
        xi = lie.se3_log(t(R), t(tr))
        R2, t2 = lie.se3_exp(xi)
        assert_close(R2, R, 1e-5)
        assert_close(t2, tr, 1e-4)


def test_se3_log_jacfwd_at_identity_is_finite():
    """The pose graph differentiates the log at a zero increment: both
    branches must keep finite tangents there. d log(exp(xi)) / d xi = I."""
    J = torch.func.jacfwd(lambda xi: lie.se3_log(*lie.se3_exp(xi)))(torch.zeros(6))
    assert J.dtype == torch.float32 and torch.isfinite(J).all()
    assert_close(J, np.eye(6), 1e-6)
    Jj = jax.jit(jax.jacfwd(lambda xi: jlie.se3_log(*jlie.se3_exp(xi))))(jnp.zeros(6))
    assert_close(J, Jj, 1e-6)


def test_edge_linearization_matches_jax():
    rng = np.random.default_rng(7)
    n = 16
    Ri, ti = _random_poses(rng, n, 1.0)
    Rj, tj = _random_poses(rng, n, 1.0)
    Rm, tm = jpg.relative_pose(Ri, ti, Rj, tj)
    dR, dt = _random_poses(rng, n, 1.0, 0.3)  # measurement errors in the conditioned band
    Rm = (np.einsum("nij,njk->nik", dR, Rm)).astype(np.float32)
    tm = (tm + 0.05 * dt).astype(np.float32)
    args = (Ri, ti, Rj, tj, Rm, tm)
    got = torch.func.vmap(posegraph._edge_lin)(*[t(a) for a in args])
    want = jax.jit(jax.vmap(jpg._edge_lin))(*[jnp.asarray(a) for a in args])
    for name, g, w in zip(("r", "Ji", "Jj"), got, want):
        w = to_np(w)
        assert g.dtype == torch.float32
        assert_close(g, w, 1e-4 * np.abs(w).max(), what=name)


def _assert_closes_loop(R_out, t_out, costs, R_gt, t_gt):
    """The reference test's bounds (its f32 floor)."""
    assert costs[-1] < 1e-3, costs
    for k in range(len(R_gt)):
        cos = (np.trace(R_out[k] @ R_gt[k].T) - 1) / 2
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 0.3, k
        assert np.linalg.norm(t_out[k] - t_gt[k]) < 2e-2, k


def _assert_matches_op_by_op_jax(args, iters):
    R, tr, costs = (to_np(x) for x in posegraph.pose_graph_solve(*[t(a) for a in args], iters=iters))
    with jax.disable_jit():
        Rj, tj, cj = (np.asarray(x) for x in jpg.pose_graph_solve(*[jnp.asarray(a) for a in args], iters=iters))
    assert_close(R, Rj, 1e-4, what="R")
    assert_close(tr, tj, 1e-4, what="t")
    # the costs down to the f32 floor (~1e-13 on this ring)
    assert_close(costs, cj, 1e-11, rtol=1e-2, what="costs")


def test_pose_graph_closes_loop_like_jax():
    args, R_gt, t_gt = ring_graph(np.random.default_rng(12345))
    R, tr, costs = (to_np(x) for x in posegraph.pose_graph_solve(*[t(a) for a in args]))
    assert costs.shape == (posegraph.LM_ITERS,) and np.isfinite(costs).all()
    _assert_closes_loop(R, tr, costs, R_gt, t_gt)
    _assert_matches_op_by_op_jax(args, iters=1)


@pytest.mark.slow
def test_pose_graph_all_iterations_like_jax():
    _assert_matches_op_by_op_jax(ring_graph(np.random.default_rng(12345))[0], iters=posegraph.LM_ITERS)


def test_pose_graph_free_node_without_edges_stays_put():
    """A free, valid node that no edge touches has a zero block (only the LM
    damping): its update must stay finite and zero, and the rest of the
    graph must still close; an invalid node is left as it was."""
    args, R_gt, t_gt = ring_graph(np.random.default_rng(5))
    R0, t0, fixed, valid = args[:4]
    lone_R, lone_t = np.eye(3, dtype=np.float32)[None], np.array([[5.0, 5.0, 5.0]], np.float32)
    R0 = np.concatenate([R0, lone_R, lone_R])
    t0 = np.concatenate([t0, lone_t, lone_t + 1])
    fixed = np.concatenate([fixed, [False, False]])
    valid = np.concatenate([valid, [True, False]])
    R, tr, costs = (to_np(x) for x in posegraph.pose_graph_solve(
        *[t(a) for a in (R0, t0, fixed, valid) + args[4:]]))
    assert np.isfinite(R).all() and np.isfinite(tr).all()
    assert_close(R[-2:], R0[-2:], 1e-6)
    assert_close(tr[-2:], t0[-2:], 1e-6)
    _assert_closes_loop(R[:-2], tr[:-2], costs, R_gt, t_gt)
    assert_close(R[0], R0[0], 0.0, what="the fixed node")
