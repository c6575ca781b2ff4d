"""Port parity: ops/bitdesc + ops/express against the JAX reference, bit-exact."""
import numpy as np
import jax.numpy as jnp
import pytest

from movslam_tpu.ops import bitdesc as jbit
from movslam_tpu.ops import express as jexp
from movslam_tpu_torch.ops import bitdesc, express
from tests._torch_parity import assert_exact, t, u32
from tests.test_express import _random_blocks

pytestmark = pytest.mark.smoke


def test_pack_popcount_hamming_exact(rng):
    bits = rng.integers(0, 2, (40, 256)).astype(bool)
    bits[0] = True  # all-ones words: the sign bit of every int32 carrier
    got = bitdesc.pack_bits(t(bits))
    want = np.asarray(jbit.pack_bits(jnp.asarray(bits)))
    assert_exact(u32(got), want, "pack_bits")
    assert_exact(bitdesc.unpack_bits(got), bits, "unpack_bits")
    assert_exact(bitdesc.popcount(got), np.asarray(jbit.popcount(jnp.asarray(want))))
    a, b = got[:20], got[20:]
    assert_exact(
        bitdesc.hamming(a, b),
        np.asarray(jbit.hamming(jnp.asarray(want[:20]), jnp.asarray(want[20:]))),
    )


@pytest.mark.parametrize("thr", [10, 25, 40])
def test_descriptor_and_detector_exact(rng, thr):
    blocks = _random_blocks(rng, 128)
    passed, desc = express.detect_and_describe(t(blocks), thr)
    jp, jd = jexp.detect_and_describe(jnp.asarray(blocks), thr)
    assert_exact(u32(desc), np.asarray(jd), "descriptor")
    assert_exact(passed, np.asarray(jp), "detector")
    assert_exact(express.compute_express(t(blocks), thr), np.asarray(jp))
    assert_exact(u32(express.compute_descriptor(t(blocks), thr)), np.asarray(jd))


def test_gather_blocks_and_dense_grid_exact(rng):
    img = rng.integers(0, 256, (240, 320)).astype(np.uint8)
    img[40:90, 60:70] = 250  # a stripe the detector fires on
    tl = np.stack([rng.integers(-20, 330, 64), rng.integers(-20, 250, 64)], -1).astype(np.int32)
    assert_exact(
        express.gather_blocks(t(img), t(tl)),
        np.asarray(jexp.gather_blocks(jnp.asarray(img).astype(jnp.float32), jnp.asarray(tl))),
    )
    c, p, d = express.dense_grid_detect(t(img), 25)
    jc, jp, jd = jexp.dense_grid_detect(jnp.asarray(img), 25)
    assert_exact(c, np.asarray(jc))
    assert_exact(p, np.asarray(jp))
    assert_exact(u32(d), np.asarray(jd))
