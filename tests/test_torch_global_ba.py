"""The port's global BA (core/local_mapping.global_bundle_adjustment):
every good keyframe optimized, maps beyond the largest keyframe bucket in
overlapping windows (ports of tests/test_global_ba.py, with small buckets
so that the CPU solves stay small), and the same synthetic map through both
packages.

The parity case runs a ~40-keyframe map with a stereo row (bf = 80, the
rig of chip_smoke.py phase 6): keyframe poses and points within 1e-4 after 10
LM iterations (measured: 1.2e-6 and 1e-5). A monocular map is not compared
pose by pose: its scale gauge is free, the reduced camera system's condition
number is ~1.4e8 (beyond f32's 1e7), and the step along the gauge is set by
rounding, so the two packages' f32 solves part by up to 0.34 m in one
iteration on the same wire. Monocular maps are held to the reference test's
own gates (every keyframe moved, everything finite).
"""
import numpy as np
import pytest

from movslam_tpu.core import camera as jcamera
from movslam_tpu.core import local_mapping as jlm
from movslam_tpu.core import map as jmap
from movslam_tpu_torch.core import camera, local_mapping, map as pmap
from movslam_tpu_torch.core.verbose import Verbose
from tests._torch_parity import assert_close, gba_map

Verbose.level = Verbose.QUIET


def _moved(m, kfs, before):
    return sum(1 for kf in kfs[1:] if np.linalg.norm(m.keyframes[kf.id].t - before[kf.id]) > 1e-9)


def test_global_ba_touches_every_keyframe(monkeypatch):
    monkeypatch.setattr(local_mapping, "GBA_KF_BUCKETS", (32, 64, 128))
    m, cam, kfs = gba_map(pmap, camera, n_kf=120)
    before = {kf.id: kf.t.copy() for kf in kfs}
    local_mapping.global_bundle_adjustment(m, cam, device="cpu", iters=10)
    # every non-anchor keyframe was optimized (no silent truncation)
    assert _moved(m, kfs, before) >= len(kfs) - 2
    for kf in kfs:
        assert np.isfinite(m.keyframes[kf.id].t).all()
    assert kfs[0].t.tolist() == before[kfs[0].id].tolist()  # the gauge anchor


def test_global_ba_windowed_beyond_bucket(monkeypatch):
    """A map beyond the largest bucket runs in overlapping windows: every
    keyframe is still optimized, each window anchored by the last."""
    monkeypatch.setattr(local_mapping, "GBA_KF_BUCKETS", (16, 32, 48))
    m, cam, kfs = gba_map(pmap, camera, n_kf=120)
    calls = []
    solve = local_mapping.ba_solve_wire
    monkeypatch.setattr(local_mapping, "ba_solve_wire", lambda *a, **k: calls.append(k["K"]) or solve(*a, **k))
    before = {kf.id: kf.t.copy() for kf in kfs}
    local_mapping.global_bundle_adjustment(m, cam, device="cpu", iters=5)
    assert _moved(m, kfs, before) >= len(kfs) - 2
    assert calls == [64, 64, 64, 64], calls  # windows start at 0, 24, 48, 72; 48 KFs pad to 64


def test_global_ba_matches_jax():
    """One 40-keyframe stereo map built in both packages from one seed (the
    K = 48 bucket, 512 points, 2048 observations)."""
    maps = {}
    for name, mapmod, cammod, lm in (("port", pmap, camera, local_mapping), ("jax", jmap, jcamera, jlm)):
        m, cam, kfs = gba_map(mapmod, cammod, n_kf=40, n_mp=300, seed=3, bf=80.0)
        t0 = np.stack([kf.t for kf in kfs])
        kw = {"device": "cpu"} if name == "port" else {}
        lm.global_bundle_adjustment(m, cam, bf=80.0, iters=10, **kw)
        pts = sorted(m.mappoints.values(), key=lambda mp: mp.id)
        maps[name] = (np.stack([kf.R for kf in kfs]), np.stack([kf.t for kf in kfs]),
                      np.stack([mp.pos for mp in pts]), [len(mp.obs) for mp in pts], t0)
    (Rp, tp, Xp, op, t0), (Rj, tj, Xj, oj, _) = maps["port"], maps["jax"]
    assert op == oj  # the same observations pruned
    assert_close(Rp, Rj, 1e-4, what="R")
    assert_close(tp, tj, 1e-4, what="t")
    assert_close(Xp, Xj, 1e-4, what="points")
    assert np.abs(tp - t0).max() > 1e-2  # BA moved the keyframes


@pytest.mark.parametrize("n_kf,bucket", [(3, 48), (49, 96), (385, 768), (512, 768)])
def test_global_ba_buckets(n_kf, bucket):
    assert local_mapping._bucket(n_kf, local_mapping.GBA_KF_BUCKETS[0],
                                 local_mapping.GBA_KF_BUCKETS[-1]) == bucket
    assert local_mapping.GBA_KF_BUCKETS == jlm.GBA_KF_BUCKETS
    assert (local_mapping.GBA_MAX_MP, local_mapping.GBA_MAX_OBS) == (jlm.GBA_MAX_MP, jlm.GBA_MAX_OBS)
