"""Port parity: ops/image + ops/lk against the JAX reference.

Tolerance: tracked positions within 1e-3 px (the port gathers where the
reference multiplies by hat-weight matrices, so sums round differently);
status equal wherever the reference's min-eigenvalue is clear of the 1e-4
gate (> 2e-4)."""
import numpy as np
import jax.numpy as jnp
import pytest

from movslam_tpu.ops import image as jimg
from movslam_tpu.ops import lk as jlk
from movslam_tpu_torch.ops import image, lk
from tests._torch_parity import assert_close, assert_exact, t
from tests.test_lk import _textured

pytestmark = pytest.mark.smoke


def test_pyramid_and_patches_close(rng):
    img = _textured(rng)[:120, :160].astype(np.float32)
    for got, want in zip(image.build_pyramid(t(img), 3), jimg.build_pyramid(jnp.asarray(img), 3)):
        assert_close(got, np.asarray(want), 1e-4)
    centers = rng.uniform(-5, 170, (20, 2)).astype(np.float32)
    assert_close(
        image.sample_patches(t(img), t(centers), 7),
        np.asarray(jimg.sample_patches(jnp.asarray(img), jnp.asarray(centers), 7)),
        1e-3,
    )


def _min_eig_finest(prev, pts):
    """The reference's min-eigenvalue at the finest level, for the gate margin."""
    Pwin = jimg.sample_patches(jnp.asarray(prev, jnp.float32), jnp.asarray(pts), 31)
    T = np.asarray(Pwin)
    gx = 0.5 * (np.pad(T, ((0, 0), (0, 0), (0, 1)), mode="edge")[:, :, 1:]
                - np.pad(T, ((0, 0), (0, 0), (1, 0)), mode="edge")[:, :, :-1])[:, 16:47, 16:47]
    gy = 0.5 * (np.pad(T, ((0, 0), (0, 1), (0, 0)), mode="edge")[:, 1:, :]
                - np.pad(T, ((0, 0), (1, 0), (0, 0)), mode="edge")[:, :-1, :])[:, 16:47, 16:47]
    a, b, c = (gx * gx).sum((1, 2)), (gx * gy).sum((1, 2)), (gy * gy).sum((1, 2))
    return 0.5 * (a + c - np.sqrt((a - c) ** 2 + 4 * b * b)) / 31**2


@pytest.mark.parametrize("shift", [(3.0, -2.0), (-1.5, 0.75), (12.0, 9.0)])
def test_lk_track_close(rng, shift):
    big = _textured(rng)
    dx, dy = shift
    prev = big[20:260, 20:340].astype(np.uint8)
    ys, xs = np.mgrid[0:240, 0:320].astype(np.float32)
    cur = jimg.bilinear_sample(jnp.asarray(big, jnp.float32), jnp.stack(
        [jnp.asarray(xs + 20 + dx), jnp.asarray(ys + 20 + dy)], -1))
    cur = np.clip(np.asarray(cur), 0, 255).astype(np.uint8)
    pts = np.concatenate([
        rng.uniform(-4, 324, (40, 2)), rng.uniform(30, 290, (40, 2)),
    ]).astype(np.float32)
    valid = rng.uniform(size=len(pts)) > 0.1
    new_pts, status = lk.lk_track(t(prev), t(cur), t(pts), t(valid))
    j_pts, j_status = jlk.lk_track(jnp.asarray(prev), jnp.asarray(cur), jnp.asarray(pts), jnp.asarray(valid))
    assert_close(new_pts, np.asarray(j_pts), 1e-3, what="LK positions")
    clear = _min_eig_finest(prev, pts) > 2e-4
    assert_exact(status.numpy()[clear], np.asarray(j_status)[clear], "LK status")
    assert np.asarray(j_status).sum() > 40
