"""Port parity: ops/mapper_step (triangulation + gates + local BA on wires).

One staged mapper job, made with numpy from a seed
(tests/_torch_parity.mapper_job_case), goes through the reference's
mapper_step_wire and the port's, at reduced sizes (C=64, K/P/O = 8/128/512).
Tolerances: triangulated X within 1e-4 relative to the scene's depth on rows
that pass the gates; BA poses and points within 1e-4 (two fixed keyframes);
per-observation chi2 within 1e-3 relative; `ok` flags equal on every
candidate that is not within a stated margin of a gate; track-id lanes of
patch_tri bit-exact, including ids whose f32 patterns are denormals and
NaNs; patch shapes pinned to (C_PATCH, 10) and (P_PATCH, 3)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from movslam_tpu.ops import mapper_step as jms
from movslam_tpu_torch.ops import mapper_step
from tests._torch_parity import ID_BIT_CASES, assert_close, assert_exact, mapper_job_case, t, to_np

pytestmark = pytest.mark.smoke

SIZES = dict(C=64, K=8, P=128, O=512)


def _bits(x):
    return np.ascontiguousarray(to_np(x)).view(np.int32)


def test_constants_match_reference():
    for name in ("TRI_CAP", "BA_K", "BA_P", "BA_O", "BA_MOPP", "C_PATCH", "P_PATCH", "MAPPER_SMALL",
                 "MAPPER_BIG", "REPROJ_TRI", "COS_PARALLAX", "SCALE_FACTOR", "N_LEVELS"):
        assert getattr(mapper_step, name) == getattr(jms, name), name


@pytest.fixture(scope="module", params=[(0, 0.0), (1, 7.0)], ids=["no_far_gate", "far_gate_7m"])
def both(request):
    seed, th_far = request.param
    case = mapper_job_case(seed, **SIZES, th_far=th_far)
    want = jms.mapper_step_wire(jnp.asarray(case["tri_wire"]), jnp.asarray(case["ba_wire"]),
                                jnp.asarray(case["intr"]), 0.0, **SIZES)
    got = mapper_step.mapper_step_wire(t(case["tri_wire"]), t(case["ba_wire"]), t(case["intr"]), 0.0,
                                       **SIZES)
    return case, {k: np.asarray(v) for k, v in want.items()}, {k: to_np(v) for k, v in got.items()}


def test_patch_shapes_and_id_lanes(both):
    case, want, got = both
    assert got["patch_tri"].shape == want["patch_tri"].shape == (mapper_step.C_PATCH, 10)
    assert got["patch_mp"].shape == want["patch_mp"].shape == (mapper_step.P_PATCH, 3)
    assert got["wire"].shape == want["wire"].shape and got["wire"].dtype == np.float32
    n = case["n_tri"]
    assert_exact(_bits(got["patch_tri"][:, 3])[:n], case["tids"], "id lane vs the staged ids")
    assert_exact(_bits(got["patch_tri"][:, 3]), _bits(want["patch_tri"][:, 3]), "id lane vs reference")
    assert set(ID_BIT_CASES.tolist()) <= set(_bits(got["patch_tri"][:, 3])[:n].tolist())
    assert not np.isfinite(ID_BIT_CASES.view(np.float32)[2:]).any()  # the NaN patterns really are


def test_gates_and_triangulation(both):
    case, want, got = both
    n = case["n_tri"]
    Xw = mapper_step.split_mapper_wire(want["wire"], **SIZES)[0]
    Xg = mapper_step.split_mapper_wire(got["wire"], **SIZES)[0]
    ok_w, ok_g = want["patch_tri"][:, 4] > 0, got["patch_tri"][:, 4] > 0
    # Margins: a candidate counts as near a gate when the reference's own X
    # puts it within 0.1 px^2 of the reprojection gate, 2e-5 of the parallax
    # gate, 1e-3 m of zero depth or 1e-2 m of the far threshold.
    tw = case["tri_wire"]
    th_far = float(tw[0, 24])
    P1 = tw[0, 0:12].reshape(3, 4).astype(np.float64)
    R1, t1 = tw[0, 12:21].reshape(3, 3).astype(np.float64), tw[0, 21:24].astype(np.float64)
    near = np.zeros(mapper_step.C_PATCH, bool)
    for i in range(n):
        row = tw[1 + i, :28].astype(np.float64)  # without the id lane
        Xh = np.append(Xw[i], 1.0)
        p1, p2 = P1 @ Xh, row[0:12].reshape(3, 4) @ Xh
        e1 = np.sum((p1[:2] / p1[2] - row[12:14]) ** 2)
        e2 = np.sum((p2[:2] / p2[2] - row[14:16]) ** 2)
        R2, t2 = row[16:25].reshape(3, 3), row[25:28]
        d1, d2 = np.linalg.norm(Xw[i] + R1.T @ t1), np.linalg.norm(Xw[i] + R2.T @ t2)
        r1 = R1.T @ np.array([(row[12] - 160) / 320, (row[13] - 120) / 320, 1.0])
        r2 = R2.T @ np.array([(row[14] - 160) / 320, (row[15] - 120) / 320, 1.0])
        cos = r1 @ r2 / (np.linalg.norm(r1) * np.linalg.norm(r2))
        near[i] = (
            min(abs(e1 - 5.0), abs(e2 - 5.0)) < 0.1 or abs(cos - mapper_step.COS_PARALLAX) < 2e-5
            or min(abs(p1[2]), abs(p2[2])) < 1e-3
            or (th_far > 0 and min(abs(d1 - th_far), abs(d2 - th_far)) < 1e-2)
        )
    # The parallax-failing rows (second camera = first) are degenerate for the
    # DLT: their X is arbitrary on both sides, and they fail by cos = 1.
    assert near[:n].mean() < 0.1
    assert_exact(ok_g[~near], ok_w[~near], "ok flags away from the gates' margins")
    assert not ok_g[n:].any() and not ok_g[:n][case["bad"]].any()
    assert ok_g[:n].sum() >= (n // 2 if th_far == 0 else 5)
    if th_far > 0:
        assert (ok_g[:n].sum() < (~case["bad"]).sum())  # the far gate rejected some
    both_ok = ok_g & ok_w
    assert_close(Xg[both_ok[: SIZES["C"]]], Xw[both_ok[: SIZES["C"]]], 1e-4 * 8.0, what="X (8 m scene)")
    # normal, mind, maxd of the accepted rows
    assert_close(got["patch_tri"][both_ok][:, [0, 1, 2, 5, 6, 7, 8, 9]],
                 want["patch_tri"][both_ok][:, [0, 1, 2, 5, 6, 7, 8, 9]], 1e-3, what="patch_tri floats")


def test_ba_section_and_split(both):
    case, want, got = both
    Xw, kf_w, mp_w, obs_w = jms.split_mapper_wire(want["wire"], **SIZES)
    Xg, kf_g, mp_g, obs_g = mapper_step.split_mapper_wire(torch.from_numpy(got["wire"]), **SIZES)
    assert (Xg.shape, kf_g.shape, mp_g.shape, obs_g.shape) == (Xw.shape, kf_w.shape, mp_w.shape, obs_w.shape)
    assert kf_g.shape == (SIZES["K"], 12) and obs_g.shape == (SIZES["O"], 2)
    ba_in = case["ba_wire"]
    kf_in = ba_in[: SIZES["K"] * 14].reshape(SIZES["K"], 14)
    assert_exact(kf_g[:2], kf_in[:2, :12], "fixed keyframes come back unchanged")
    assert np.abs(kf_g[2:6] - kf_in[2:6, :12]).max() > 1e-3  # the free ones moved: a real solve
    assert_close(kf_g, kf_w, 1e-4, what="BA keyframe poses")
    assert_close(mp_g, mp_w, 1e-4, what="BA points")
    valid = ba_in[SIZES["K"] * 14 + SIZES["P"] * 4:][: SIZES["O"] * 6].reshape(-1, 6)[:, 5] > 0
    assert_close(obs_g[valid, 0], obs_w[valid, 0], 1e-3 * obs_w[valid, 0].max(), 1e-3, what="chi2")
    assert_close(obs_g[valid, 1], obs_w[valid, 1], 1e-3, what="depth")
    assert_close(got["patch_mp"][: SIZES["P"]], mp_g, 0.0, what="patch_mp = BA points")
    assert not got["patch_mp"][SIZES["P"]:].any()


def test_tri_wire_row_count_is_checked():
    case = mapper_job_case(0, **SIZES)
    with pytest.raises(ValueError, match="C \\+ 1"):
        mapper_step.mapper_step_wire(t(case["tri_wire"][:-1]), t(case["ba_wire"]), t(case["intr"]), 0.0,
                                     **SIZES)
