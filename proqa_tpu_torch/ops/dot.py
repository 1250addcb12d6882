"""Matrix products with an f32 result, the counterpart of JAX's
`preferred_element_type=jnp.float32` on bf16 operands.

bf16 x bf16 products are exact in f32, so on the CPU an f32 product of the
up-cast operands is the same arithmetic. On the GPU, `torch.mm` / `torch.bmm`
with `out_dtype=torch.float32` keep the bf16 tensor-core path and return the
f32 accumulator instead of rounding it to bf16 first. Those calls have no
derivative in PyTorch, so `_DotF32` gives them the one JAX's transpose rule
gives a DEFAULT-precision dot: the f32 cotangent is rounded to the operand
dtype, multiplied by the other operand with f32 accumulation, and the result
rounded to the operand dtype. f32 operands run in full f32: TF32 is off
(`pin_f32_precision`).
"""
from __future__ import annotations

import torch


def pin_f32_precision() -> None:
    """Keep f32 matrix products in full f32 on the GPU. The JAX package pins
    f32 scoring to full precision (proqa_tpu/ops/mips.py:40-44), and its
    from-scratch retriever training collapsed under lowered f32 matmul
    precision, so both switches are set explicitly."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an f32 result on the GPU; b is [K, N] or batched like a."""
    if b.dim() == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.view(*a.shape[:-1], b.shape[-1])
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                    out_dtype=torch.float32)
    return out.view(*a.shape[:-1], b.shape[-1])


class _DotF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _mm_f32(g.to(a.dtype), b.transpose(-1, -2).to(a.dtype)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = g.to(b.dtype)
            if b.dim() == 2:
                a2 = a.reshape(-1, a.shape[-1])
                db = _mm_f32(a2.t().to(b.dtype), gb.reshape(-1, gb.shape[-1])).to(b.dtype)
            else:
                db = _mm_f32(a.transpose(-1, -2).to(b.dtype), gb).to(b.dtype)
        return da, db


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as f32. b is [K, N], or batched like a ([..., K, N])."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.device.type != "cuda":
        return torch.matmul(a.float(), b.float())
    return _DotF32.apply(a, b)
