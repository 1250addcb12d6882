"""Fused inverted dropout (kernel K4).

Counterpart of proqa_tpu/ops/pallas_dropout.py:pallas_dropout: one pass that
reads x, regenerates the keep mask from a seed (ops/random.py) and writes
where(keep, f32(x) * (1 / (1 - rate)), 0) rounded to x's dtype. The backward
applies the same function, with the same seed, to the cotangent; nothing but
the seed is saved. CUDA tensors run the hand-written kernel in
csrc/dropout.cu; CPU tensors run `dropout_reference`, its plain PyTorch
version, which draws the same bits.
"""
from __future__ import annotations

import torch

from proqa_tpu_torch import _build
from proqa_tpu_torch.ops import random

STREAM = 0  # the stream id of dropout masks (ops/random.py:keys; csrc/dropout.cu)

# kernel launches since the last reset (the main path's proof of use)
launches = 0


def dropout_reference(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same mask and arithmetic."""
    keep = random.keep_mask(seed, STREAM, rate, x.shape, x.device)
    inv = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
    return torch.where(keep, x.float() * inv, 0.0).to(x.dtype)


def _dropout_kernel(x: torch.Tensor, rate: float, seed: int, threshold: int) -> torch.Tensor:
    global launches
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"dropout kernel takes bf16 or f32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("dropout kernel takes a contiguous tensor")
    y = torch.empty_like(x)
    # the kernel derives the keys of (seed mod 2^64, STREAM) itself, as
    # random.keys does; ctypes passes the seed as an unsigned 64-bit word
    _build.launch("proqa_dropout", x.device, x.data_ptr(), y.data_ptr(), x.numel(), seed,
                  threshold, 1.0 / (1.0 - rate), int(x.dtype == torch.bfloat16))
    launches += 1
    return y


def _apply(x: torch.Tensor, rate: float, seed: int, threshold: int) -> torch.Tensor:
    if x.device.type == "cuda":
        return _dropout_kernel(x, rate, seed, threshold)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return dropout_reference(x, rate, seed)


class _Dropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rate, seed, threshold):
        ctx.args = rate, seed, threshold
        return _apply(x, rate, seed, threshold)

    @staticmethod
    def backward(ctx, g):
        # same seed => same mask; dropout is linear given its mask
        return _apply(g.contiguous(), *ctx.args), None, None, None


def dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Inverted dropout of any contiguous bf16 or f32 tensor; the identity at
    rate 0. `seed` (64-bit) chooses the mask. Where no gradient is asked for
    (grad mode off, or x needs none) the kernel runs without an autograd
    node: the same launch, less host time."""
    if rate == 0.0:
        return x
    threshold = random.threshold(rate)  # validates the rate
    x = x.contiguous()
    if x.requires_grad and torch.is_grad_enabled():
        return _Dropout.apply(x, rate, seed, threshold)
    return _apply(x, rate, seed, threshold)
