"""Fixed-capacity track state — device-side feature tracks.

Port of movslam_tpu/core/trackstate.py: a dataclass of tensors in place of
the flax pytree. Descriptors are int32 words carrying the reference's
uint32 bit patterns; `to_numpy` hands them back as uint32 views.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

MAX_TRACKS = 2048  # > 39*29 = 1131 dense-grid blocks at 640x480


@dataclasses.dataclass
class TrackState:
    """One frame's feature tracks (see the reference for field meanings).

    pt (N, 2) f32; track_id (N,) i32 (-1 invalid); age (N,) i32;
    desc (N, 8) i32; mb_wh (N, 2) f32; coverage (N,) bool; valid (N,) bool;
    next_id () i32 — the extractor's id counter (mCurrentId)."""

    pt: torch.Tensor
    track_id: torch.Tensor
    age: torch.Tensor
    desc: torch.Tensor
    mb_wh: torch.Tensor
    coverage: torch.Tensor
    valid: torch.Tensor
    next_id: torch.Tensor

    @property
    def capacity(self):
        return self.pt.shape[0]

    @property
    def device(self):
        return self.pt.device

    @staticmethod
    def empty(capacity=MAX_TRACKS, next_id=0, *, device):
        z = dict(device=device)
        return TrackState(
            pt=torch.zeros((capacity, 2), dtype=torch.float32, **z),
            track_id=torch.full((capacity,), -1, dtype=torch.int32, **z),
            age=torch.zeros(capacity, dtype=torch.int32, **z),
            desc=torch.zeros((capacity, 8), dtype=torch.int32, **z),
            mb_wh=torch.full((capacity, 2), 16.0, dtype=torch.float32, **z),
            coverage=torch.zeros(capacity, dtype=torch.bool, **z),
            valid=torch.zeros(capacity, dtype=torch.bool, **z),
            next_id=torch.tensor(next_id, dtype=torch.int32, **z),
        )

    @staticmethod
    def from_numpy(arrays, *, device):
        """Build from numpy arrays keyed by field name — e.g. a JAX
        TrackState's leaves pulled to the host. Descriptors may be uint32 or
        int32; they are reinterpreted bit for bit."""
        def t(name, dtype):
            return torch.as_tensor(np.asarray(arrays[name]).astype(dtype), device=device)

        desc = np.ascontiguousarray(arrays["desc"])
        return TrackState(
            pt=t("pt", np.float32),
            track_id=t("track_id", np.int32),
            age=t("age", np.int32),
            desc=torch.as_tensor(desc.view(np.int32).copy(), device=device),
            mb_wh=t("mb_wh", np.float32),
            coverage=t("coverage", bool),
            valid=t("valid", bool),
            next_id=torch.tensor(int(np.asarray(arrays["next_id"])), dtype=torch.int32, device=device),
        )

    @staticmethod
    def rebuild(packed, desc, next_id):
        """Rebuild a TrackState on the device of `packed` from one frame's
        packed export (ops/frame_step words: pt 2 x i16 | track id | meta)
        and its descriptor row (the window program's desc_w side channel):
        the rewind to a mid-window frame, without a host round trip. mb_wh is
        not exported, so the 16x16 default comes back; pt carries the wire's
        1/32-px quantisation."""
        from ..ops.frame_step import unpack_pt_dev

        dev = packed.device
        meta = packed[:, 2]
        flags = (meta >> 25) & 0xF
        valid = (flags & 4) != 0
        tid = packed[:, 1]
        N = packed.shape[0]
        return TrackState(
            pt=unpack_pt_dev(packed[:, 0]),
            track_id=torch.where(valid, tid, torch.full_like(tid, -1)),
            age=meta & 0xFFF,
            desc=desc,
            mb_wh=torch.full((N, 2), 16.0, dtype=torch.float32, device=dev),
            coverage=(flags & 8) != 0,
            valid=valid,
            next_id=torch.as_tensor(next_id, dtype=torch.int32, device=dev),
        )

    def to_numpy(self):
        """Host view with invalid entries dropped; descriptors as uint32."""
        v = self.valid.cpu().numpy()
        return {
            "pt": self.pt.cpu().numpy()[v],
            "track_id": self.track_id.cpu().numpy()[v],
            "age": self.age.cpu().numpy()[v],
            "desc": self.desc.cpu().numpy()[v].view(np.uint32),
            "coverage": self.coverage.cpu().numpy()[v],
            "next_id": int(self.next_id),
            "rows": np.flatnonzero(v),  # compacted slot -> capacity row
        }
