"""Port parity: ops/mvselect + ops/propagate against the JAX reference, bit-exact."""
import numpy as np
import jax.numpy as jnp
import pytest

from movslam_tpu.ops import express as jexp
from movslam_tpu.ops import mvselect as jmv
from movslam_tpu.ops import propagate as jprop
from movslam_tpu_torch.ops import mvselect, propagate
from tests._torch_parity import assert_exact, synthetic_pframe, t, u32

pytestmark = pytest.mark.smoke
BORDER_SEEDS = (3, 4, 5)  # every track within 8 px of a border


def _inputs(seed, border=False):
    d = synthetic_pframe(seed=seed)
    st = d["state"]
    if border:
        # Every track within 8 px of a border, some just outside it (where
        # truncation and floor differ), and MV rects reaching the edges.
        rng = np.random.default_rng(100 + seed)
        H, W = d["img"].shape
        n = len(st["pt"])
        off = rng.uniform(-1.5, 8.0, n).astype(np.float32)
        side = rng.integers(0, 4, n)
        pt = st["pt"]
        pt[side == 0, 0] = off[side == 0]
        pt[side == 1, 0] = W - 1 - off[side == 1]
        pt[side == 2, 1] = off[side == 2]
        pt[side == 3, 1] = H - 1 - off[side == 3]
        x0 = np.clip(pt[:, 0] - rng.uniform(0, 16, n), 0, W - 17)[: len(d["mv_rect"])]
        y0 = np.clip(pt[:, 1] - rng.uniform(0, 16, n), 0, H - 17)[: len(d["mv_rect"])]
        m = len(x0)
        d["mv_rect"][:m] = np.stack([x0, y0, x0 + 16, y0 + 16], -1)
    # Descriptors taken from the previous image at each track, so that some
    # candidates pass the Hamming gate and the claim logic is exercised.
    tl = st["pt"].astype(np.int32) - 8
    blocks = jexp.gather_blocks(jnp.asarray(d["img"]).astype(jnp.float32), jnp.asarray(tl))
    st["desc"] = np.asarray(jexp.compute_descriptor(blocks, 25.0))
    d["mv_delta"] *= 0.25
    return d


def test_candidate_mvs_and_point_covered_exact(rng):
    d = _inputs(1)
    pts, valid = d["state"]["pt"], d["state"]["valid"]
    got = mvselect.candidate_mvs(t(pts), t(valid), t(d["mv_rect"]), t(d["mv_valid"]))
    want = jmv.candidate_mvs(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(d["mv_rect"]), jnp.asarray(d["mv_valid"])
    )
    assert_exact(got, np.asarray(want))
    assert_exact(
        mvselect.point_covered(t(pts), t(d["mv_rect"]), t(d["mv_valid"])),
        np.asarray(jmv.point_covered(jnp.asarray(pts), jnp.asarray(d["mv_rect"]), jnp.asarray(d["mv_valid"]))),
    )


def test_priority_rank_exact_with_ties(rng):
    n = 300
    valid = rng.uniform(size=n) > 0.2
    age = rng.integers(0, 3, n).astype(np.int32)  # many ties: stability matters
    desc = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    desc[::7] = desc[0]
    got = propagate.priority_rank(t(valid), t(age), t(desc.view(np.int32)))
    want = jprop.priority_rank(jnp.asarray(valid), jnp.asarray(age), jnp.asarray(desc))
    assert_exact(got, np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2, *BORDER_SEEDS])
def test_propagate_and_seed_exact(seed):
    d = _inputs(seed, border=seed in BORDER_SEEDS)
    st = d["state"]
    H, W = d["img"].shape
    args = [
        d["img"], st["pt"], st["valid"], st["coverage"], st["age"], st["desc"],
        st["mb_wh"], d["mv_delta"], d["mv_rect"], d["mv_dindx"], d["mv_valid"],
    ]
    want = jprop.propagate_mv_tracks(*[jnp.asarray(a) for a in args], d["kps_rect"].shape[0], 25.0)
    targs = [t(a) for a in args]
    targs[5] = t(st["desc"].view(np.int32))
    got = propagate.propagate_mv_tracks(*targs, d["kps_rect"].shape[0], 25.0)
    assert np.asarray(want["accepted"]).sum() > 10  # the gate really let tracks through
    for k in ("new_pt", "accepted", "dist", "kp_claimed"):
        assert_exact(got[k], np.asarray(want[k]), k)
    assert_exact(u32(got["new_desc"]), np.asarray(want["new_desc"]), "new_desc")

    s_got = propagate.seed_new_tracks(
        t(d["img"]), t(d["kps_rect"]), t(d["kps_valid"]), got["kp_claimed"], 25.0, W, H
    )
    s_want = jprop.seed_new_tracks(
        jnp.asarray(d["img"]), jnp.asarray(d["kps_rect"]), jnp.asarray(d["kps_valid"]),
        want["kp_claimed"], 25.0, W, H,
    )
    for g, w, name in zip(s_got, s_want, ("pt", "desc", "accept", "seed_order")):
        assert_exact(u32(g) if name == "desc" else g, np.asarray(w), name)

