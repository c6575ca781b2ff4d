"""Port parity: ops/frame_step (the per-frame program) on its int32 wire.

A 320x240 synthetic stream supplies real motion vectors; the map snapshot
holds each frame-0 track back-projected onto the background plane, so
background tracks are PnP inliers and foreground ones outliers. Both stages'
RANSAC draws are the reference's, replayed. Tolerances: id and meta words
equal; pt words equal (within 1 LSB = 1/32 px on LK-tracked rows);
visibility words equal; pose within 1e-4; counters equal."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from movslam_tpu.core.extractor import MOVExtractor as JExtractor
from movslam_tpu.io.synthetic import SyntheticStream as JStream
from movslam_tpu.ops import frame_step as jfs
from movslam_tpu_torch.core.trackstate import TrackState
from movslam_tpu_torch.ops import frame_step
from tests._torch_parity import assert_close, assert_exact, jax_state_arrays, replay_jax_draws, t

pytestmark = pytest.mark.smoke


def _scenario(seed):
    stream = JStream(n_points=150, seed=seed, width=320, height=240, max_mvs=1024, max_kps=512)
    f0, f1 = stream.frame(0), stream.frame(1)
    st0 = JExtractor(threshold=25, capacity=512).extract(f0, None, None)
    v = np.asarray(st0.valid)
    tids = np.asarray(st0.track_id)[v]
    world = stream._bg_world(0, np.asarray(st0.pt)[v].astype(np.float64))
    P = 1024
    snap = np.zeros((P, 12), np.float32)
    n = len(tids)
    snap[:n, 0:2] = world
    snap[:n, 2] = stream.bg_depth
    snap[:n, 5] = 1.0  # viewing direction from the camera (+z)
    snap[:n, 6] = 1.0
    snap[:n, 7] = 1000.0
    snap[:n, 8] = 1.0
    snap[:n, 9] = (np.arange(n) % 3) != 0  # two thirds in the reference KF
    tid_col = np.full(P, np.iinfo(np.int32).max, np.int32)
    tid_col[:n] = tids[::-1]  # row order differs from id order
    snap[:n, 0:3] = snap[:n, 0:3][::-1]
    snap[:, 10] = tid_col.view(np.float32)
    R1, t1 = stream.gt_pose(0)  # prior: the previous frame's pose
    mvk, n_mvs = f1.packed_joint()
    trailer = np.zeros((2, 8), np.float32)
    trailer.reshape(-1)[0:9] = R1.reshape(-1)
    trailer.reshape(-1)[9:12] = t1
    trailer.reshape(-1)[12] = f1.coverage_area
    mvk = np.concatenate([mvk, trailer]).astype(np.float32)
    intr = np.array([320.0, 320.0, 160.0, 120.0], np.float32)
    return f0.im_gray, f1.im_gray, st0, mvk, n_mvs, snap, intr


@pytest.mark.parametrize("seed", [3, 8])
def test_tracked_frame_step_wire(seed):
    prev_img, img, st0, mvk, n_mvs, snap, intr = _scenario(seed)
    kw = dict(n_mvs=n_mvs, reproj_err=5.0, threshold=25.0, coverage_threshold=0.2,
              capacity=512, max_cov=512)
    key = jax.random.PRNGKey(seed)
    want = jfs.tracked_frame_step(
        jnp.asarray(img), jnp.asarray(prev_img), st0, jnp.asarray(mvk), None,
        jnp.asarray(snap), jnp.asarray(intr), key, **kw,
    )
    _, k = jax.random.split(key)
    k1, k2 = jax.random.split(k)
    got = frame_step.tracked_frame_step(
        t(img), t(prev_img), TrackState.from_numpy(jax_state_arrays(st0), device="cpu"), t(mvk), t(snap),
        t(intr), replay_jax_draws([k1, k2]), **kw,
    )
    N, C = 512, frame_step.packed_cols()
    w_wire = np.asarray(want["wire"])
    g_wire = got["wire"].numpy()
    assert g_wire.shape == w_wire.shape and g_wire.dtype == np.int32
    wp, gp = w_wire[: N * C].reshape(N, C), g_wire[: N * C].reshape(N, C)
    assert_exact(gp[:, 1], wp[:, 1], "track id words")
    assert_exact(gp[:, 2], wp[:, 2], "meta words")
    lk = ((wp[:, 2] >> 25) & 8) != 0
    assert_exact(gp[~lk, 0], wp[~lk, 0], "pt words")
    for col in (0, 1):  # the two i16 halves of the LK rows' pt words
        q = lambda w: ((w << (16 * (1 - col))) >> 16)  # noqa: E731
        assert np.abs(q(gp[lk, 0]) - q(wp[lk, 0])).max(initial=0) <= 1
    ws, gs = w_wire[N * C : N * C + 16], g_wire[N * C : N * C + 16]
    assert ws[14] == 1 and ws[12] >= 10  # both stages solved: a real comparison
    assert_exact(gs[12:], ws[12:], "n_ref, n_inliers, ok, next_id")
    assert_close(gs[:12].view(np.float32), ws[:12].view(np.float32), 1e-4, what="pose")
    assert_exact(g_wire[N * C + 16 :], w_wire[N * C + 16 :], "visibility words")


def test_wire_pack_helpers_round_trip(rng):
    pt = rng.uniform(-900, 900, (64, 2)).astype(np.float32)
    words = frame_step.pack_pt_i32(t(pt))
    assert_exact(words, np.asarray(jfs.pack_pt_i32(jnp.asarray(pt))))
    assert_close(frame_step.unpack_pt_np(words.numpy()), np.round(pt * 32) / 32, 0.0)
    b = rng.uniform(size=256) > 0.5
    bits = frame_step.pack_bits_i32(t(b))
    assert_exact(bits, np.asarray(jfs.pack_bits_i32(jnp.asarray(b))))
    assert_exact(frame_step.unpack_bits_np(bits.numpy(), 256), b)
    uv = rng.uniform(0, 320, (32, 2)).astype(np.float32)
    intr = np.array([300.0, 310.0, 160.0, 120.0], np.float32)
    dist = np.array([-0.2, 0.05, 1e-3, -1e-3, 0.01, 0, 0, 0, 0, 0], np.float32)
    assert_close(
        frame_step.undistort_points(t(uv), t(intr), t(dist)),
        np.asarray(jfs.undistort_points_jax(jnp.asarray(uv), jnp.asarray(intr), jnp.asarray(dist))),
        1e-3,
    )
    torch.testing.assert_close(frame_step.unpack_pt_np(np.asarray(jfs.pack_pt_i32(jnp.asarray(pt)))),
                               jfs.unpack_pt_np(np.asarray(jfs.pack_pt_i32(jnp.asarray(pt)))))
