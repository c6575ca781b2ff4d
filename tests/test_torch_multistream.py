"""Port parity: S streams in one call (kernels.score_candidates_ref and
ops/propagate.py with a stream axis, parallel/multistream.py) against S
single-stream calls and against the reference's sharded vmap
(movslam_tpu/parallel/multistream.py) on the virtual CPU mesh. Integers
bit-exact; positions exact (the same f32 add)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from movslam_tpu.parallel.mesh import make_mesh
from movslam_tpu.parallel.multistream import make_multistream_propagate as jax_multistream
from movslam_tpu_torch.ops import kernels, propagate
from movslam_tpu_torch.parallel.multistream import make_multistream_propagate
from tests._torch_parity import assert_exact, candidate_case, t, u32
from tests.test_torch_propagate import _inputs

S = 3
KEYS = ("new_pt", "accepted", "dist", "kp_claimed", "new_desc")


def _stream_args(seeds):
    """Per-stream propagate inputs (numpy): image, track state, MV tables."""
    out = []
    for seed in seeds:
        d = _inputs(seed, border=seed % 2 == 1)
        st = d["state"]
        out.append([d["img"], st["pt"], st["valid"], st["coverage"], st["age"],
                    st["desc"].view(np.int32), st["mb_wh"], d["mv_delta"], d["mv_rect"],
                    d["mv_dindx"], d["mv_valid"]])
    return out


def test_score_candidates_over_streams_equals_single_calls():
    cases = [candidate_case(seed) for seed in (5, 6, 7)]
    M = cases[0]["mv_delta"].shape[0]
    singles = [kernels.score_candidates(*(t(c[k]) for k in ("img", "prev_pt", "cand", "mv_delta",
                                                              "prev_wh", "prev_desc")), 25.0)
               for c in cases]
    cand = np.concatenate([np.where(c["cand"] >= 0, c["cand"] + s * M, -1) for s, c in enumerate(cases)])
    cat = lambda k: t(np.concatenate([c[k] for c in cases]))  # noqa: E731
    img = t(np.stack([c["img"] for c in cases]))
    got = kernels.score_candidates(img, cat("prev_pt"), t(cand.astype(np.int32)), cat("mv_delta"),
                                   cat("prev_wh"), cat("prev_desc"), 25.0)
    mv, new_pt, dist, desc, inb = (torch.cat(x) for x in zip(*singles))
    offset = torch.as_tensor(np.repeat(np.arange(S) * M, len(cases[0]["cand"])), dtype=torch.int32)
    assert_exact(got[0], torch.where(mv >= 0, mv + offset, mv), "mv (global rows)")
    for g, w, name in zip(got[1:], (new_pt, dist, desc, inb), ("new_pt", "dist", "desc", "inb")):
        assert_exact(g, w, name)
    # a track without a candidate scores its own stream's first row
    empty = (cand[:, 0] < 0)
    assert empty[len(cases[0]["cand"]):].any()


def test_score_candidates_refuses_uneven_streams():
    c = candidate_case(5, N=10)
    img = t(np.stack([c["img"]] * 3))
    with pytest.raises(ValueError, match="streams"):
        kernels.score_candidates(img, t(c["prev_pt"]), t(c["cand"]), t(c["mv_delta"]),
                                 t(c["prev_wh"]), t(c["prev_desc"]), 25.0)


def test_propagate_over_streams_equals_single_calls():
    per = _stream_args((0, 1, 2))
    K = 512
    singles = [propagate.propagate_mv_tracks(*[t(a) for a in args], K, 25.0) for args in per]
    batched = propagate.propagate_mv_tracks(*[t(np.stack(x)) for x in zip(*per)], K, 25.0)
    assert sum(int(s["accepted"].sum()) for s in singles) > 30
    for k in KEYS:
        assert_exact(batched[k], torch.stack([s[k] for s in singles]), k)


def test_multistream_propagate_matches_jax_mesh():
    assert len(jax.devices()) >= S, "conftest provides virtual CPU devices"
    per = _stream_args((3, 4, 5))
    stacked = [np.stack(x) for x in zip(*per)]
    jargs = [jnp.asarray(a) for a in stacked]
    jargs[5] = jnp.asarray(stacked[5].view(np.uint32))
    want = jax_multistream(make_mesh(S))(*jargs, 25.0)
    got = make_multistream_propagate("cpu")(*[t(a) for a in stacked], 25.0)
    assert np.asarray(want["accepted"]).sum() > 30
    for k in KEYS:
        g = u32(got[k]) if k == "new_desc" else got[k]
        assert_exact(g, np.asarray(want[k]), k)


def test_umeyama_copy_matches_the_evaluator(rng):
    from evaluation.evaluator import umeyama_alignment
    from movslam_tpu_torch.multistream_eval import umeyama_alignment as port_umeyama

    gt = rng.normal(size=(50, 3))
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    R *= np.linalg.det(R)
    est = (0.7 * gt @ R.T + [1.0, -2.0, 0.5]) + rng.normal(0, 1e-3, (50, 3))
    for got, want in zip(port_umeyama(gt, est), umeyama_alignment(gt, est, with_scale=True)):
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_multistream_eval_runs_on_the_cpu(capsys):
    import json

    from movslam_tpu_torch import multistream_eval

    assert multistream_eval.main(["multistream_eval", "2", "8", "--cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    front = lines[0]["sharded_frontend"]
    assert front["streams"] == 2 and front["device"] == "cpu" and front["propagate_ms_per_batch"] > 0
    assert [x["seed"] for x in lines[1:]] == [100, 101] and all(x["lost"] == 0 for x in lines[1:])
