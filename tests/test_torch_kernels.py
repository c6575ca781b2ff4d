"""score_blocks and score_candidates: the port's plain versions against the
JAX XLA path, the interpreted Pallas kernel and the reference's choice rule
(bit-exact), and the wrappers' checks. The CUDA kernels themselves are
tested on the card in tests/test_torch_cuda.py."""
import numpy as np
import jax.numpy as jnp
import pytest

from movslam_tpu.ops import bitdesc as jbit
from movslam_tpu.ops import express as jexp
from movslam_tpu.ops import propagate as jprop
from movslam_tpu.ops.pallas_kernels import score_blocks as pallas_score_blocks
from movslam_tpu_torch.ops import kernels
from tests._torch_parity import assert_exact, candidate_case, t, u32

CAND_ARGS = ("img", "prev_pt", "cand", "mv_delta", "prev_wh", "prev_desc")

EDGE_TL = np.array(
    [[0, 0], [240, 112], [0, 112], [240, 0], [5, 100], [100, 5], [239, 111], [1, 1]],
    np.int32,
)


def _inputs(rng, H, W, B):
    img = rng.integers(0, 256, (H, W)).astype(np.uint8)
    tl = np.stack([rng.integers(-8, W, B), rng.integers(-8, H, B)], -1).astype(np.int32)
    prev = rng.integers(0, 2**32, (B, 8), dtype=np.uint32)
    return img, tl, prev


def _xla_path(img, tl, prev, thr):
    blocks = jexp.gather_blocks(jnp.asarray(img).astype(jnp.float32), jnp.asarray(tl))
    desc = jexp.compute_descriptor(blocks, thr)
    return np.asarray(jbit.hamming(desc, jnp.asarray(prev))), np.asarray(desc)


@pytest.mark.parametrize("shape", [(480, 640, 64), (128, 256, 8), (37, 50, 13)])
def test_score_blocks_ref_matches_xla_path(rng, shape):
    img, tl, prev = _inputs(rng, *shape)
    if shape[0] == 128:
        tl = EDGE_TL
    dist, desc = kernels.score_blocks(t(img), t(tl), t(prev.view(np.int32)), 25.0)
    want_dist, want_desc = _xla_path(img, tl, prev, 25.0)
    assert_exact(u32(desc), want_desc, "desc")
    assert_exact(dist, want_dist, "dist")


def test_score_blocks_ref_matches_pallas_interpret(rng):
    img, tl, prev = _inputs(rng, 128, 256, 16)
    tl[:8] = EDGE_TL
    jd, jdesc = pallas_score_blocks(
        jnp.asarray(img), jnp.asarray(tl), jnp.asarray(prev), 25.0, interpret=True
    )
    dist, desc = kernels.score_blocks_ref(t(img), t(tl), t(prev.view(np.int32)), 25.0)
    assert_exact(u32(desc), np.asarray(jdesc), "desc")
    assert_exact(dist, np.asarray(jd), "dist")


def test_score_blocks_wrapper_rejects_bad_inputs(rng):
    img, tl, prev = _inputs(rng, 64, 64, 4)
    p = t(prev.view(np.int32))
    with pytest.raises(TypeError):
        kernels.score_blocks(t(img).float(), t(tl), p, 25.0)
    with pytest.raises(TypeError):
        kernels.score_blocks(t(img), t(tl).long(), p, 25.0)
    with pytest.raises(TypeError):
        kernels.score_blocks(t(img), t(tl), p[:3], 25.0)
    with pytest.raises(ValueError):
        kernels.score_blocks(t(img)[:8], t(tl), p, 25.0)
    # A tensor that is on neither the CPU nor CUDA is refused, not computed.
    with pytest.raises(ValueError):
        kernels.score_blocks(t(img).to("meta"), t(tl).to("meta"), p.to("meta"), 25.0)
    before = kernels.score_blocks.launches
    kernels.score_blocks(t(img), t(tl), p, 25.0)
    assert kernels.score_blocks.launches == before  # the plain version is no launch



def _choice_rule(c, threshold):
    """Each slot scored by score_blocks_ref, then the JAX reference's choice
    (movslam_tpu/ops/propagate.py:117-150), as numpy."""
    img, pt, cand, mv_delta, wh = c["img"], c["prev_pt"], c["cand"], c["mv_delta"], c["prev_wh"]
    N = cand.shape[0]
    H, W = img.shape
    cand_pt = pt[:, None, :] + mv_delta[np.maximum(cand, 0)]
    inb = np.asarray(jprop._block_inbounds(jnp.asarray(cand_pt), jnp.asarray(wh[:, None, :]), W, H))
    tl = cand_pt.astype(np.int32).reshape(-1, 2) - 8
    dist, desc = kernels.score_blocks_ref(t(img), t(tl), t(np.repeat(c["prev_desc"], 4, 0)), threshold)
    dist, desc = dist.numpy().reshape(N, 4), desc.numpy().reshape(N, 4, 8)
    score = jnp.where(jnp.asarray((cand >= 0) & inb), jnp.asarray(dist), 10_000)
    best_j = np.asarray(jnp.argmin(score, axis=1))
    best = np.asarray(jnp.min(score, axis=1))
    chosen = np.where((cand[:, 1] >= 0) & (best < 256), best_j, 0)
    r = np.arange(N)
    want = (cand[r, chosen], cand_pt[r, chosen], dist[r, chosen], desc[r, chosen], inb[r, chosen])
    return want, {"score": np.asarray(score), "best": best, "cand_pt": cand_pt, "inb": inb}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_candidates_ref_matches_blocks_and_choice_rule(seed):
    c = candidate_case(seed)
    got = kernels.score_candidates(*[t(c[k]) for k in CAND_ARGS], 25.0)
    want, why = _choice_rule(c, 25.0)
    for name, g, w in zip(("mv", "new_pt", "dist", "desc", "inb"), got, want):
        assert_exact(g, w, name)
    # The inputs reach every case of the rule.
    cand, score, best, cpt = c["cand"], why["score"], why["best"], why["cand_pt"]
    multi = cand[:, 1] >= 0
    assert (cand[:, 0] < 0).any(), "rows without a candidate"
    assert (multi & (best == 256)).any(), "a best distance of exactly 256 keeps slot 0"
    assert (multi & (best < 40)).any(), "near matches"
    assert (multi & (score[:, 0] == score[:, 1]) & (score[:, 0] == best) & (best < 256)).any(), "ties"
    assert ((cand >= 0) & ~why["inb"]).any(), "candidates out of bounds"
    assert (multi & (best == 10_000)).any(), "tracks with no usable candidate"
    assert ((np.floor(cpt) != np.trunc(cpt)) & (cand >= 0)[..., None]).any(), "truncation != floor"


def test_score_candidates_wrapper_rejects_bad_inputs():
    c = candidate_case(0, N=8, M=16)
    args = [t(c[k]) for k in CAND_ARGS]
    for i, bad in ((1, args[1].double()), (2, args[2].long()), (3, args[3].half()),
                   (4, args[4][:3]), (5, args[5].float())):
        with pytest.raises(TypeError):
            kernels.score_candidates(*args[:i], bad, *args[i + 1:], 25.0)
    with pytest.raises(ValueError):
        kernels.score_candidates(args[0][:8], *args[1:], 25.0)
    with pytest.raises(ValueError):
        kernels.score_candidates(*args[:3], args[3][:0], *args[4:], 25.0)
    with pytest.raises(ValueError):
        kernels.score_candidates(*[a.to("meta") for a in args], 25.0)
    before = kernels.score_candidates.launches
    kernels.score_candidates(*args, 25.0)
    assert kernels.score_candidates.launches == before  # the plain version is no launch
