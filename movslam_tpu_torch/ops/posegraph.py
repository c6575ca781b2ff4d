"""SE(3) pose-graph relaxation (Levenberg-Marquardt over relative-pose edges).

Port of movslam_tpu/ops/posegraph.py. Per-edge Jacobians come from
forward-mode autodiff vmapped over the edges; the normal system is dense
(6K x 6K), its K x K blocks and the gradient segment-summed
(ops/ba._segment_sums: one launch of the ordered kernel on the card, so
1 + iters launches a call; `index_add_` on the CPU; the plans are built
once per call), and solved by Cholesky. Used by core/map_merge.py to relax
the welded keyframe graph.

Conventions: node poses are camera-from-world (T_iw); an edge (i, j)
measures T_ij = T_iw o T_jw^-1; the residual is
log(T_ij_meas^-1 o T_i o T_j^-1).
"""
from __future__ import annotations

import numpy as np
import torch

from . import ba
from .kernels import segment_plan
from .lie import se3_compose, se3_exp, se3_inverse, se3_log
from .linalg import solve_psd

LM_ITERS = 20


def _edge_residual(xi_i, xi_j, Ri, ti, Rj, tj, Rm, tm):
    """Residual of one edge with left-multiplied increments xi on both nodes."""
    dRi, dti = se3_exp(xi_i)
    dRj, dtj = se3_exp(xi_j)
    Ri_, ti_ = se3_compose(dRi, dti, Ri, ti)
    Rj_, tj_ = se3_compose(dRj, dtj, Rj, tj)
    Rj_inv, tj_inv = se3_inverse(Rj_, tj_)
    Rij, tij = se3_compose(Ri_, ti_, Rj_inv, tj_inv)
    Rm_inv, tm_inv = se3_inverse(Rm, tm)
    Re, te = se3_compose(Rm_inv, tm_inv, Rij, tij)
    return se3_log(Re, te)


def _edge_lin(Ri, ti, Rj, tj, Rm, tm):
    """Residual at zero increment and the Jacobians wrt both nodes: (r, Ji, Jj)."""
    zero = torch.zeros(6, dtype=Ri.dtype, device=Ri.device)
    r = _edge_residual(zero, zero, Ri, ti, Rj, tj, Rm, tm)
    Ji, Jj = torch.func.jacfwd(_edge_residual, argnums=(0, 1))(zero, zero, Ri, ti, Rj, tj, Rm, tm)
    return r, Ji, Jj


def pose_graph_solve(node_R, node_t, node_fixed, node_valid, edge_i, edge_j, edge_R, edge_t,
                     edge_w, iters=LM_ITERS):
    """LM pose-graph relaxation.

    node_R (K, 3, 3), node_t (K, 3): camera-from-world poses;
    node_fixed / node_valid (K,) bool (gauge: fix at least one node);
    edge_i / edge_j (E,) int; edge_R / edge_t: measured relative poses
    T_i T_j^-1; edge_w (E,): weights (0 disables an edge).

    Returns (node_R, node_t, costs (iters,)): the cost after each step's
    trial update, as the reference's scan returns it. No host sync inside."""
    K = node_R.shape[0]
    edge_i = edge_i.to(torch.int64)
    edge_j = edge_j.to(torch.int64)
    free = node_valid & ~node_fixed
    w = edge_w * node_valid[edge_i] * node_valid[edge_j]
    free_i = free[edge_i].to(node_R.dtype)[:, None, None]
    free_j = free[edge_j].to(node_R.dtype)[:, None, None]
    lin_edges = torch.func.vmap(_edge_lin)
    # Dense normal system: every edge adds its four 6x6 blocks.
    ab = torch.cat([edge_i * K + edge_i, edge_j * K + edge_j, edge_i * K + edge_j,
                    edge_j * K + edge_i])
    node = torch.cat([edge_i, edge_j])
    ordered = ba._ordered(node_R)
    plan_ab = segment_plan(ab, K * K) if ordered else None
    plan_node = segment_plan(node, K) if ordered else None

    def linearize(R, t):
        r, Ji, Jj = lin_edges(R[edge_i], t[edge_i], R[edge_j], t[edge_j], edge_R, edge_t)
        Ji = Ji * free_i
        Jj = Jj * free_j
        cost = (r * w[:, None] * r).sum()
        Jiw = Ji * w[:, None, None]
        Jjw = Jj * w[:, None, None]
        blocks = torch.cat([Jiw.transpose(1, 2) @ Ji, Jjw.transpose(1, 2) @ Jj,
                            Jiw.transpose(1, 2) @ Jj, Jjw.transpose(1, 2) @ Ji])
        H, g = ba._segment_sums([(blocks, ab, K * K, plan_ab),
                                 (torch.cat([(Jiw.transpose(1, 2) @ r[:, :, None])[..., 0],
                                             (Jjw.transpose(1, 2) @ r[:, :, None])[..., 0]]), node, K, plan_node)])
        H = H.reshape(K, K, 6, 6).permute(0, 2, 1, 3).reshape(K * 6, K * 6)
        return H, -g.reshape(-1), cost

    m = free.to(node_R.dtype).repeat_interleave(6)
    eye = torch.eye(K * 6, dtype=node_R.dtype, device=node_R.device)
    R, t = node_R, node_t
    lam = torch.tensor(1e-6, dtype=node_R.dtype, device=node_R.device)
    H, b, cost0 = linearize(R, t)
    costs = []
    for _ in range(iters):
        Hd = (H + lam * eye) * m[:, None] * m[None, :] + torch.diag(1.0 - m)
        dxi = solve_psd(Hd + 1e-8 * eye, b * m).reshape(K, 6)
        dxi = torch.where(torch.isfinite(dxi), dxi, torch.zeros_like(dxi))
        dR, dt = se3_exp(dxi)
        R_new, t_new = se3_compose(dR, dt, R, t)
        R_new = torch.where(free[:, None, None], R_new, R)
        t_new = torch.where(free[:, None], t_new, t)
        H1, b1, cost1 = linearize(R_new, t_new)
        accept = (cost1 < cost0) & torch.isfinite(cost1)
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        # The next step's linearization at the accepted poses is this one's.
        H = torch.where(accept, H1, H)
        b = torch.where(accept, b1, b)
        cost0 = torch.where(accept, cost1, cost0)
        lam = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-9, 1e6)
        costs.append(cost1)
    return R, t, torch.stack(costs)


def relative_pose(Ri, ti, Rj, tj):
    """Edge measurement T_i o T_j^-1 from two absolute poses (numpy)."""
    Rj_inv = np.swapaxes(Rj, -1, -2)
    tj_inv = -np.einsum("...ij,...j->...i", Rj_inv, tj)
    return Ri @ Rj_inv, np.einsum("...ij,...j->...i", Ri, tj_inv) + ti
