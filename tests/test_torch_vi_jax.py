"""The reference's two visual-inertial drives (tests/test_vi_system.py:50 and
:104) through both packages on the CPU, side by side (slow tier).

SyntheticVIStream(n_points=400, seed=11) at 640x480, vi_min_kfs = 8: 60
frames through track_monocular(..., imu=) and 96 frames through
track_monocular_batch in batches of 8 (flush=False, then flush=True). Both
packages must meet the reference's metric bound (median keyframe
camera-centre error, no fitted scale, < 0.15 * max(span, 0.5)) in every run,
and the port's median must lie within a margin of the reference's:

  - windowed (one run each, default RANSAC draws): WINDOWED_MARGIN. The two
    medians read 0.0139 m (JAX) and 0.0166 m (port) on a CPU host, and the
    port's 0.022-0.031 m on the card;
  - per frame: the median over RANSAC_KEYS of each run's median, the JAX PRNG
    key and the port's generator seed set to the same numbers,
    PER_FRAME_MARGIN. One run is no measure here: the first init, at 8
    keyframes over 0.67 s, tilts gravity by 0-0.4 rad depending on the draw,
    and over keys 1-5 the reference's own medians span 0.027-0.182 m (CPU
    runs). Fed the same keyframes and samples, the two inits agree to f32
    rounding (tests/test_torch_inertial.py)."""
import jax
import numpy as np
import pytest

from movslam_tpu.config import settings as jsettings
from movslam_tpu.core import camera as jcamera
from movslam_tpu.core import system as jsystem
from movslam_tpu.io import synthetic_vi as jsynthetic_vi
from movslam_tpu_torch.core.system import System
from movslam_tpu_torch.io.synthetic_vi import SyntheticVIStream
from tests.test_torch_vi_system import metric_errors, vi_settings

pytestmark = pytest.mark.slow

WINDOWED_MARGIN = 0.03  # m: ~10x the CPU gap of the windowed medians
RANSAC_KEYS = (1, 2, 3, 4, 5)
PER_FRAME_MARGIN = 0.05  # m: the medians over RANSAC_KEYS read 0.094 (JAX) and 0.127 m (port)


def _jax_system():
    s = jsettings.Settings()
    s.camera1 = jcamera.Pinhole(320.0, 320.0, 320.0, 240.0, 640, 480)
    s.fps = 30.0
    s.sensor = jsettings.IMU_MONOCULAR
    return jsystem.System(s, jsettings.IMU_MONOCULAR)


def _drive(system, items, windowed):
    system.mapper.vi_min_kfs = 8
    if windowed:
        poses = []
        for k in range(0, len(items), 8):
            poses += system.track_monocular_batch(items[k:k + 8], flush=False)
        poses += system.track_monocular_batch([], flush=True)
    else:
        poses = [system.track_monocular(ts, smv, imu=imu) for ts, smv, imu in items]
    system.shutdown()
    return poses


def _both(n, windowed, key=None):
    """One drive of each package over the first n items; returns the median
    errors (JAX, port), the bound and both systems."""
    jstream = jsynthetic_vi.SyntheticVIStream(n_points=400, seed=11)
    stream = SyntheticVIStream(n_points=400, seed=11)
    jsys = _jax_system()
    port = System(vi_settings(), System.IMU_MONOCULAR, device="cpu")
    if key is not None:
        jsys.tracking._pnp_key = jax.random.PRNGKey(key)
        port.tracking.generator.manual_seed(key)
    _drive(jsys, list(jstream.items(n)), windowed)
    poses = _drive(port, list(stream.items(n)), windowed)
    jerrs, bound = metric_errors(jsys, jstream, n)
    errs, _ = metric_errors(port, stream, n)
    m = port.atlas.current
    assert jsys.atlas.current.imu_initialized and m.imu_initialized, key
    assert port.get_total_lost() == 0 and len(poses) == port.image_count == n, key
    assert np.median(jerrs) < bound, (key, np.median(jerrs), bound)
    assert np.median(errs) < bound, (key, np.median(errs), bound)
    if not windowed:
        last = max(m.keyframes.values(), key=lambda kf: kf.id)
        assert last.velocity is not None and last.bias_g is not None and port.mapper.vi_ba_ms, key
    print(f"{'windowed' if windowed else 'per-frame'} {n} frames, key {key}: median keyframe metric error JAX "
          f"{np.median(jerrs):.4f} m, port {np.median(errs):.4f} m (bound {bound:.4f} m); init stages "
          f"JAX {jsys.atlas.current.imu_init_count} (scale {jsys.atlas.current.imu_scale:.4f}), port "
          f"{m.imu_init_count} {[(i[1], i[2]) for i in port.mapper.vi_inits if i[2] is not None]}")
    return float(np.median(jerrs)), float(np.median(errs))


@pytest.mark.parametrize("windowed,n", [(False, 60), (True, 96)], ids=["per_frame", "windowed"])
def test_vi_drive_agrees_with_reference(windowed, n):
    if windowed:
        jmed, med = _both(n, True)
        assert abs(med - jmed) < WINDOWED_MARGIN, (med, jmed)
        return
    runs = np.array([_both(n, False, key) for key in RANSAC_KEYS])
    jmed, med = np.median(runs, axis=0)
    print(f"per-frame medians over keys {RANSAC_KEYS}: JAX {runs[:, 0].round(4).tolist()} -> {jmed:.4f} m, "
          f"port {runs[:, 1].round(4).tolist()} -> {med:.4f} m")
    assert abs(med - jmed) < PER_FRAME_MARGIN, (med, jmed)


def test_vi_drives_with_the_mapper_thread():
    """The port's VI drives with keyframes processed on the mapper thread
    (async_mapping=True): the init stages and the VI BA run there under
    map_lock while tracking goes on; 30 frames per frame, 48 windowed,
    vi_min_kfs = 4."""
    stream = SyntheticVIStream(n_points=400, seed=11)
    items = list(stream.items(48))
    for windowed, n in ((False, 30), (True, 48)):
        port = System(vi_settings(), System.IMU_MONOCULAR, device="cpu", async_mapping=True)
        port.mapper.vi_min_kfs = 4
        if windowed:
            poses = []
            for k in range(0, n, 8):
                poses += port.track_monocular_batch(items[k:k + 8], flush=False)
            poses += port.track_monocular_batch([], flush=True)
        else:
            poses = [port.track_monocular(ts, smv, imu=imu) for ts, smv, imu in items[:n]]
        port.shutdown()
        errs, bound = metric_errors(port, stream, n)
        assert port.atlas.current.imu_init_count >= 1 and port.get_total_lost() == 0
        assert len(poses) == port.image_count == n
        assert np.median(errs) < bound, (windowed, np.median(errs), bound)
        assert windowed or port.mapper.vi_ba_ms
