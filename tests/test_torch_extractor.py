"""Port parity: core/trackstate + core/extractor against the JAX reference.

Track ids, ages, descriptors, validity and next_id are bit-exact. Positions
are exact for MV-propagated, seeded and grid tracks; LK-tracked rows are
held to 1e-3 px (see tests/test_torch_lk.py)."""
import numpy as np
import jax.numpy as jnp
import pytest

from movslam_tpu.core import extractor as jext
from movslam_tpu.core.trackstate import TrackState as JState
from movslam_tpu.io.synthetic import SyntheticStream as JStream
from movslam_tpu_torch.core import extractor
from movslam_tpu_torch.core.trackstate import TrackState
from tests._torch_parity import (
    assert_exact, assert_state_equal, jax_state_arrays, synthetic_pframe, t, u32,
)

pytestmark = pytest.mark.smoke


def _jstate(d):
    return JState(**{k: jnp.asarray(v) for k, v in d.items()})


def test_from_numpy_round_trips_a_jax_state():
    d = synthetic_pframe()["state"]
    js = _jstate(d)
    ps = TrackState.from_numpy(jax_state_arrays(js), device="cpu")
    assert_state_equal(ps, js)
    got, want = ps.to_numpy(), js.to_numpy()
    for k in ("pt", "track_id", "age", "desc", "coverage", "rows"):
        assert_exact(got[k], want[k], k)
    assert got["desc"].dtype == np.uint32 and got["next_id"] == want["next_id"]


def test_compact_keeps_first_duplicate_exact(rng):
    segs_np = []
    for n in (40, 25, 30):
        segs_np.append({
            "pt": rng.uniform(0, 100, (n, 2)).astype(np.float32),
            "track_id": rng.integers(0, 30, n).astype(np.int32),
            "age": rng.integers(0, 9, n).astype(np.int32),
            "desc": rng.integers(0, 2**32, (n, 8), dtype=np.uint32),
            "wh": np.full((n, 2), 16.0, np.float32),
            "coverage": rng.uniform(size=n) > 0.5,
            "accept": rng.uniform(size=n) > 0.3,
            "order": rng.permutation(n).astype(np.int32),
        })
    for cap in (50, 200):
        want = jext._compact([{k: jnp.asarray(v) for k, v in s.items()} for s in segs_np],
                             cap, jnp.asarray(7, jnp.int32))
        segs_t = [{k: t(v.view(np.int32) if k == "desc" else v) for k, v in s.items()} for s in segs_np]
        got = extractor._compact(segs_t, cap, t(np.int32(7)))
        assert_state_equal(got, want)


def test_p_frame_body_exact_with_coverage_lk():
    d = synthetic_pframe(seed=4)
    st = d["state"]
    st["coverage"] = (np.arange(len(st["valid"])) % 5 == 0) & st["valid"]
    args = [d["mv_delta"], d["mv_rect"], d["mv_dindx"], d["mv_valid"], d["kps_rect"], d["kps_valid"]]
    want = jext._p_frame_step(
        jnp.asarray(d["img"]), jnp.asarray(d["prev_img"]), _jstate(st), *[jnp.asarray(a) for a in args],
        jnp.asarray(0.95, jnp.float32), 25.0, 0.2, capacity=512, max_cov=64,
    )
    got = extractor._p_frame_body(
        t(d["img"]), t(d["prev_img"]), TrackState.from_numpy(st, device="cpu"), *[t(a) for a in args],
        t(np.float32(0.95)), 25.0, 0.2, capacity=512, max_cov=64,
    )
    assert np.asarray(want.coverage).sum() > 0
    assert_state_equal(got, want)


def _small_stream(seed, keyint=1000):
    return JStream(n_points=150, seed=seed, width=320, height=240,
                   max_mvs=1024, max_kps=512, keyint=keyint)


def test_extractor_on_stream_exact():
    """Frames 0-4 of a synthetic stream with an I-frame at 3: cold start,
    P-frames and LK carry-over. The port is fed the reference's state at
    every frame, so each step is compared on its own."""
    stream = _small_stream(5, keyint=3)
    jx = jext.MOVExtractor(threshold=25, capacity=512)
    px = extractor.MOVExtractor(threshold=25, capacity=512, device="cpu")
    j_prev, p_prev, prev_img = None, None, None
    for k in range(5):
        smv = stream.frame(k)
        j_st = jx.extract(smv, j_prev, prev_img)
        p_st = px.extract(smv, p_prev, None if prev_img is None else t(prev_img))
        lk_rows = np.asarray(j_st.valid) if k == 3 else None  # I-frame: all LK
        assert_state_equal(p_st, j_st, lk_rows=lk_rows)
        assert px.next_id == jx.next_id
        j_prev, prev_img = j_st, smv.im_gray
        p_prev = TrackState.from_numpy(jax_state_arrays(j_st), device="cpu")
    assert int(np.asarray(j_st.valid).sum()) > 50


def test_relocalize_merge_exact():
    stream = _small_stream(7)
    f0, f1 = stream.frame(0), stream.frame(1)
    j0 = jext.MOVExtractor(threshold=25, capacity=512).extract(f0, None, None)
    rows = np.flatnonzero(np.asarray(j0.valid))[:60]
    R = 64
    proj = np.zeros((R, 2), np.float32)
    proj[:60] = np.asarray(j0.pt)[rows] + np.float32(0.6)
    pvalid = np.arange(R) < 60
    ids = np.full(R, -1, np.int32)
    ids[:60] = np.asarray(j0.track_id)[rows]
    reloc = {"kf_img": f0.im_gray, "proj_pts": proj, "proj_valid": pvalid, "track_ids": ids}
    jx = jext.MOVExtractor(threshold=25, capacity=512)
    jx.extract(f0, None, None)
    want = jx.extract(f1, j0, f0.im_gray, reloc=reloc)
    px = extractor.MOVExtractor(threshold=25, capacity=512, device="cpu")
    got = px.extract(f1, TrackState.from_numpy(jax_state_arrays(j0), device="cpu"), t(f0.im_gray), reloc=reloc)
    # Relocalized rows are LK-tracked: they lead the merged state.
    lk_rows = np.isin(np.asarray(want.track_id), ids[:60]) | np.asarray(want.coverage)
    assert_state_equal(got, want, lk_rows=lk_rows)
    assert u32(got.desc).dtype == np.uint32
