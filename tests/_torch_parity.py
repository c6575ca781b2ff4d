"""Parity helpers for the PyTorch port: one numpy input, two implementations.

Inputs are made with numpy from a seed, fed to the JAX reference function
(movslam_tpu) and to its port (movslam_tpu_torch), and the outputs are
compared as numpy arrays with a stated tolerance.
"""
from __future__ import annotations

import numpy as np
import torch

torch.set_num_threads(2)  # tier-1 runs several xdist workers on one host


def to_np(x):
    """torch tensor / jax array / numpy -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def u32(x):
    """Descriptor words as uint32 bit patterns, whichever side they came from."""
    a = np.ascontiguousarray(to_np(x))
    return a.view(np.uint32) if a.dtype == np.int32 else a


def t(x, dtype=None):
    """numpy -> CPU torch tensor (a copy)."""
    a = np.array(x, dtype=dtype) if dtype is not None else np.array(x)
    return torch.from_numpy(a)


def assert_exact(got, want, what=""):
    """Bit-exact: integer outputs (descriptors, ids, counts, wire words)."""
    np.testing.assert_array_equal(to_np(got), to_np(want), err_msg=what)


def assert_close(got, want, atol, rtol=0.0, what=""):
    """Float outputs within a stated tolerance."""
    np.testing.assert_allclose(to_np(got), to_np(want), atol=atol, rtol=rtol, err_msg=what)


def jax_state_arrays(st):
    """A JAX TrackState's leaves as a dict of numpy arrays (for from_numpy)."""
    return {
        "pt": np.asarray(st.pt), "track_id": np.asarray(st.track_id),
        "age": np.asarray(st.age), "desc": np.asarray(st.desc),
        "mb_wh": np.asarray(st.mb_wh), "coverage": np.asarray(st.coverage),
        "valid": np.asarray(st.valid), "next_id": np.asarray(st.next_id),
    }


def assert_state_equal(port_state, jax_state, lk_rows=None, lk_atol=1e-3):
    """TrackState parity: integer fields exact; positions exact except on
    LK-tracked rows (default: the coverage-flagged ones), held to lk_atol."""
    j = jax_state_arrays(jax_state)
    assert_exact(port_state.valid, j["valid"], "valid")
    assert_exact(port_state.track_id, j["track_id"], "track_id")
    assert_exact(port_state.age, j["age"], "age")
    assert_exact(u32(port_state.desc), j["desc"], "desc")
    assert_exact(port_state.coverage, j["coverage"], "coverage")
    assert_exact(int(port_state.next_id), int(j["next_id"]), "next_id")
    assert_close(port_state.mb_wh, j["mb_wh"], 0.0, what="mb_wh")
    lk = j["coverage"] if lk_rows is None else np.asarray(lk_rows)
    v = j["valid"]
    pt = to_np(port_state.pt)
    assert_close(pt[v & ~lk], j["pt"][v & ~lk], 0.0, what="pt (MV, seed, grid)")
    assert_close(pt[v & lk], j["pt"][v & lk], lk_atol, what="pt (LK)")


def synthetic_pframe(capacity=512, n_mvs=1024, n_kps=512, H=240, W=320, seed=0):
    """The random P-frame inputs of __graft_entry__._example_pframe_args, as
    numpy: a textured image pair, a half-full track state and MV tables."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (H, W)).astype(np.uint8)
    prev_img = rng.integers(0, 255, (H, W)).astype(np.uint8)
    n = capacity // 2
    state = {
        "pt": rng.uniform(16, 200, (capacity, 2)).astype(np.float32),
        "track_id": np.arange(capacity, dtype=np.int32),
        "age": rng.integers(0, 5, capacity).astype(np.int32),
        "desc": rng.integers(0, 2**32, (capacity, 8), dtype=np.uint32),
        "mb_wh": np.full((capacity, 2), 16.0, np.float32),
        "coverage": np.zeros(capacity, bool),
        "valid": np.arange(capacity) < n,
        "next_id": np.int32(capacity),
    }
    mv_delta = rng.normal(0, 2, (n_mvs, 2)).astype(np.float32)
    x0 = rng.uniform(0, W - 17, n_mvs).astype(np.float32)
    y0 = rng.uniform(0, H - 17, n_mvs).astype(np.float32)
    mv_rect = np.stack([x0, y0, x0 + 16, y0 + 16], -1)
    mv_dindx = (np.arange(n_mvs) % n_kps).astype(np.int32)
    mv_valid = np.ones(n_mvs, bool)
    kx = rng.uniform(0, W - 17, n_kps).astype(np.float32)
    ky = rng.uniform(0, H - 17, n_kps).astype(np.float32)
    kps_rect = np.stack([kx, ky, np.full(n_kps, 16.0), np.full(n_kps, 16.0)], -1).astype(np.float32)
    kps_valid = np.ones(n_kps, bool)
    return {
        "img": img, "prev_img": prev_img, "state": state,
        "mv_delta": mv_delta, "mv_rect": mv_rect, "mv_dindx": mv_dindx,
        "mv_valid": mv_valid, "kps_rect": kps_rect, "kps_valid": kps_valid,
    }


def replay_jax_draws(keys, split=True):
    """A port sampler that replays the reference's RANSAC draws.

    Each call consumes the next JAX key and returns what the reference
    draws from it: `jax.random.randint(k, (n_hyp, sample), 0, max(n_valid,
    1))`, with k = split(key)[0] for PnP (pnp.py:207) and k = key for the
    two-view initializer (twoview.py:147)."""
    import jax

    keys = list(keys)

    def sampler(n_hyp, sample, n_valid):
        key = keys.pop(0)
        k = jax.random.split(key)[0] if split else key
        u = jax.random.randint(k, (n_hyp, sample), 0, max(int(n_valid), 1))
        return torch.as_tensor(np.array(u), dtype=torch.int64, device=n_valid.device)

    return sampler
