"""`bwtint_t` (uint32) arithmetic on int64 tensors.

torch on the CPU has no uint32 arithmetic, so every u32 value of the
search (SA interval bounds, packed entry words, occ counts) is carried in
an int64 tensor and masked back to 32 bits after each add or subtract
that can wrap.  `k == 0xFFFFFFFF` plays the role of (bwtint_t)(-1), as in
`ibwa_tpu/fm/device.py`.  Packed int32 words (the priority key) are
carried sign-extended in int64 and wrapped with `wrap_i32`.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
NEG1 = 0xFFFFFFFF


def from_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor holding u32 bit patterns -> int64 u32 values."""
    return x.to(torch.int64) & MASK


def to_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 u32 values -> int32 tensor with the same bit pattern."""
    return wrap_i32(x).to(torch.int32)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int64 value of its low 32 bits read as int32 (what
    JAX's int32 arithmetic produces on overflow)."""
    return ((x + 0x80000000) & MASK) - 0x80000000


def popcount(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of u32 values carried in int64 (torch has no
    popcount op).  The final multiply does not wrap at 32 bits in int64,
    hence the closing & 0xFF."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def partial_mask(nb: torch.Tensor) -> torch.Tensor:
    """Keep the top nb 2-bit fields of a word (bwt.c:109; nb in 1..16),
    as `ibwa_tpu/fm/device.py::_partial_mask`."""
    return ~((1 << ((16 - nb) * 2)) - 1) & MASK


def int_log2(v: torch.Tensor, max_value: int) -> torch.Tensor:
    """Exact integer log2 (bit length - 1) of 0 <= v <= max_value, with
    log2(0) == 0 (stdaln-style bit scan).  torch has no clz; the gap
    counts this serves are small, so a bit-length loop bounded by
    max_value stays a handful of ops."""
    out = torch.zeros_like(v)
    for s in range(1, max(int(max_value), 1).bit_length()):
        out = out + ((v >> s) > 0).to(v.dtype)
    return out
