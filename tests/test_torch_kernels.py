"""score_blocks: the port's plain version against the JAX XLA path and the
interpreted Pallas kernel (bit-exact), and the wrapper's checks. The CUDA
kernel itself is tested on the card in tests/test_torch_cuda.py."""
import numpy as np
import jax.numpy as jnp
import pytest

from movslam_tpu.ops import bitdesc as jbit
from movslam_tpu.ops import express as jexp
from movslam_tpu.ops.pallas_kernels import score_blocks as pallas_score_blocks
from movslam_tpu_torch.ops import kernels
from tests._torch_parity import assert_exact, t, u32

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

