"""Counter-based random bits for the dropout kernels (K2, K3, K4).

The TPU kernels draw their masks from the core's hardware PRNG, which cannot
be replayed outside a structurally identical kernel
(proqa_tpu/ops/pallas_attention.py:239-244). The port uses a keyed 32-bit
hash instead: element n of a tensor gets

    bits(n) = mix32(mix32(lo32(n) ^ k0) ^ hi32(n) ^ k1)

where mix32 is a 32-bit integer finaliser (xor-shift, multiply, twice) and
(k0, k1) = `keys(seed, stream)` come from a 64-bit seed and a stream id. The
same function is written once in CUDA (csrc/random.cuh) and once here with
torch integer ops, so a kernel and its plain version draw the same bits and
their masks agree exactly. Nothing is stored: a backward pass regenerates the
forward's mask from the seed.

The keep rule is unsigned: keep where bits >= threshold(rate), so
P(keep) = 1 - threshold / 2^32 ~= 1 - rate. (The JAX kernels compare in
signed int32 to work around a Mosaic lowering bug; that does not carry over.)
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_M1, _M2 = 0x7FEB352D, 0x846CA68B  # mix32's multipliers


def mix32(x: int) -> int:
    """The 32-bit finaliser on a Python int (used for the keys)."""
    x &= MASK32
    x ^= x >> 16
    x = (x * _M1) & MASK32
    x ^= x >> 15
    x = (x * _M2) & MASK32
    x ^= x >> 16
    return x


def keys(seed: int, stream: int) -> tuple[int, int]:
    """The two 32-bit key words of a (64-bit seed, stream id) pair."""
    seed &= (1 << 64) - 1
    k0 = mix32((seed & MASK32) ^ mix32((stream & MASK32) ^ 0x9E3779B9))
    k1 = mix32((seed >> 32) ^ mix32(k0 ^ 0x85EBCA6B))
    return k0, k1


def threshold(rate: float) -> int:
    """The unsigned 32-bit threshold under which bits drop an element."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} must be in [0, 1)")
    return min(int(rate * (1 << 32)), MASK32)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32): split x into 16-bit halves so
    no partial product leaves int64 (a full 32x32 product would overflow)."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def bits(k0: int, k1: int, counter: torch.Tensor) -> torch.Tensor:
    """bits(n) for an int64 tensor of element indices; int64 in [0, 2^32)."""
    lo, hi = counter & MASK32, counter >> 32
    return _mix32(_mix32(lo ^ k0) ^ hi ^ k1)


def keep_mask(seed: int, stream: int, rate: float, shape, device) -> torch.Tensor:
    """The keep mask of a contiguous tensor of `shape`: element n (its flat
    index) is kept where bits(n) >= threshold(rate)."""
    k0, k1 = keys(seed, stream)
    numel = 1
    for d in shape:
        numel *= d
    counter = torch.arange(numel, dtype=torch.int64, device=device)
    return (bits(k0, k1, counter) >= threshold(rate)).view(shape)
