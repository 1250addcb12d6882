"""Matrix products with an f32 result, the counterpart of JAX's
`preferred_element_type=jnp.float32` on bf16 operands.

bf16 x bf16 products are exact in f32, so on the CPU an f32 product of the
up-cast operands is the same arithmetic. On the GPU, `torch.mm` / `torch.bmm`
with `out_dtype=torch.float32` keep the bf16 tensor-core path and return the
f32 accumulator instead of rounding it to bf16 first. f32 operands run in
full f32: TF32 is off (`pin_f32_precision`).
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


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as f32. b is [K, N], or batched like a ([..., K, N])."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.device.type != "cuda":
        return torch.matmul(a.float(), b.float())
    if b.dim() == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.view(*a.shape[:-1], b.shape[-1])
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                    out_dtype=torch.float32)
    return out.view(*a.shape[:-1], b.shape[-1])
