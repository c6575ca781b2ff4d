"""Explicit device selection: CUDA when asked for, or an error."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """Turn a user's `device` argument into a torch.device.

    Raises when CUDA is requested and unavailable; never substitutes the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but torch.cuda.is_available() is False"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    return dev


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 with two's-complement wrap (u32 bit patterns)."""
    return (torch.remainder(x + 2**31, 2**32) - 2**31).to(torch.int32)
