"""256-bit binary descriptors packed as (..., 8) int32 words.

Port of movslam_tpu/ops/bitdesc.py. The reference stores uint32 words; here
each word is an int32 tensor carrying the same bit pattern (torch has no
`>>` on uint32 on the CPU and no popcount), and popcount is SWAR on int64.
Bit i of a descriptor lives at bit (i % 32) of word (i // 32); bit i is
pixel (row=i//16, col=i%16) of a 16x16 macroblock.
"""
from __future__ import annotations

import torch

from ..device import wrap_i32

DESC_WORDS = 8  # 256 bits / 32


def pack_bits(bits):
    """(..., 256) bool -> (..., 8) int32 (u32 bit patterns)."""
    b = bits.to(torch.int64).reshape(bits.shape[:-1] + (DESC_WORDS, 32))
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return wrap_i32((b << shifts).sum(-1))


def unpack_bits(desc):
    """(..., 8) int32 -> (..., 256) bool."""
    shifts = torch.arange(32, dtype=torch.int64, device=desc.device)
    bits = ((desc.to(torch.int64) & 0xFFFFFFFF)[..., None] >> shifts) & 1
    return bits.reshape(desc.shape[:-1] + (256,)).to(torch.bool)


def _popcount32(x):
    """Per-word popcount of int32 bit patterns -> int64 (SWAR)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def popcount(desc):
    """Set bits per descriptor: (..., 8) -> (...,) int32."""
    return _popcount32(desc).sum(-1).to(torch.int32)


def hamming(d1, d2):
    """Hamming distance between packed descriptors (broadcasting) -> int32."""
    return _popcount32(torch.bitwise_xor(d1, d2)).sum(-1).to(torch.int32)
