"""The dropout masks of the configuration, drawn again for the reference.

The port documents its masks (proqa_tpu_torch/ops/random.py): element n of
a tensor, in row-major order of its padded shape, is kept where

    bits(n) = mix32(mix32(lo32(n) ^ k0) ^ hi32(n) ^ k1) >= floor(rate * 2^32)

with (k0, k1) derived from the site's 64-bit seed and a stream id (0 for
activations, 1 for attention probabilities), mix32 a xor-shift-multiply
finaliser. This is a frozen copy of that function in plain torch integer
ops, so that the reference drops the same elements as the program.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_M1, _M2 = 0x7FEB352D, 0x846CA68B
ACTIVATIONS, PROBABILITIES = 0, 1  # stream ids


def _mix_int(x: int) -> int:
    x &= MASK32
    x ^= x >> 16
    x = (x * _M1) & MASK32
    x ^= x >> 15
    x = (x * _M2) & MASK32
    return x ^ (x >> 16)


def keys(seed: int, stream: int) -> tuple[int, int]:
    seed &= (1 << 64) - 1
    k0 = _mix_int((seed & MASK32) ^ _mix_int((stream & MASK32) ^ 0x9E3779B9))
    return k0, _mix_int((seed >> 32) ^ _mix_int(k0 ^ 0x85EBCA6B))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & MASK32


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def keep(seed: int, stream: int, rate: float, shape, device) -> torch.Tensor:
    """The keep mask (bool, `shape`) of a site's seed."""
    k0, k1 = keys(seed, stream)
    numel = 1
    for d in shape:
        numel *= d
    n = torch.arange(numel, dtype=torch.int64, device=device)
    bits = _mix(_mix((n & MASK32) ^ k0) ^ (n >> 32) ^ k1)
    return (bits >= min(int(rate * (1 << 32)), MASK32)).view(shape)
