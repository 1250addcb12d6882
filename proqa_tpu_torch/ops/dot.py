"""Matrix products with an f32 result, the counterpart of JAX's
`preferred_element_type=jnp.float32` on bf16 operands.

bf16 x bf16 products are exact in f32, so on the CPU an f32 product of the
up-cast operands is the same arithmetic. On the GPU, `torch.mm` / `torch.bmm`
with `out_dtype=torch.float32` keep the bf16 tensor-core path and return the
f32 accumulator instead of rounding it to bf16 first. Those calls have no
derivative in PyTorch, so `_DotF32` gives them the one JAX's transpose rule
gives a DEFAULT-precision dot: the f32 cotangent is rounded to the operand
dtype, multiplied by the other operand with f32 accumulation, and the result
rounded to the operand dtype. f32 operands run in full f32: the product
runs inside `full_f32`, which turns TF32 off for that call only, as the JAX
package passes HIGHEST precision to each f32 product
(proqa_tpu/ops/mips.py:40-44).
"""
from __future__ import annotations

import contextlib
import threading

import torch

# full_f32 saves, sets and restores process-wide switches: two threads inside
# it at once could have one's restore turn TF32 back on under the other's
# product, so the whole block holds this lock (reentrant: blocks may nest)
_F32_LOCK = threading.RLock()


def pin_f32_precision() -> None:
    """Keep f32 matrix products in full f32 on the GPU. The JAX package pins
    f32 scoring to full precision (proqa_tpu/ops/mips.py:40-44), and its
    from-scratch retriever training collapsed under lowered f32 matmul
    precision, so both switches are set explicitly."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def full_f32():
    """Run the enclosed f32 products in full f32 (TF32 off for cuBLAS and
    cuDNN), then restore the caller's settings, whatever they were. The
    switches are the process's: the products this pins are launched on the
    host inside the block, which is when cuBLAS reads them. One thread at a
    time runs a block (`_F32_LOCK`); an f32 product launched outside any
    block while another thread is inside one may still run without TF32."""
    with _F32_LOCK:
        matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul
            torch.backends.cudnn.allow_tf32 = cudnn


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an f32 result on the GPU; b is [K, N] or batched like a."""
    if b.dim() == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.view(*a.shape[:-1], b.shape[-1])
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                    out_dtype=torch.float32)
    return out.view(*a.shape[:-1], b.shape[-1])


def dot_f32_backward(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor, need_a: bool = True,
                     need_b: bool = True) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """The gradients of dot_f32(a, b) for the cotangent g of its f32 result
    (g may come in a narrower dtype that holds its values exactly), None
    where not needed. On the GPU with bf16 operands, JAX's transpose rule as
    above; f32 operands in full f32; on the CPU the f32 products of the
    up-cast operands, rounded to each operand's dtype (what autograd gives
    the up-cast product there)."""
    da = db = None
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        g = g.float()
        with full_f32():
            if need_a:
                da = torch.matmul(g, b.transpose(-1, -2))
            if need_b:
                db = _weight_grad(a, g, b.dim() > 2)
        return da, db
    if a.device.type != "cuda":
        g = g.float()
        if need_a:
            da = torch.matmul(g, b.float().transpose(-1, -2)).to(a.dtype)
        if need_b:
            db = _weight_grad(a.float(), g, b.dim() > 2).to(b.dtype)
        return da, db
    return _rounded_backward(a, b, g, need_a, need_b)


def _rounded_backward(a, b, g, need_a, need_b):
    """JAX's transpose rule for a DEFAULT-precision dot (module docstring),
    the products by _mm_f32."""
    da = db = None
    if need_a:
        da = _mm_f32(g.to(a.dtype), b.transpose(-1, -2).to(a.dtype)).to(a.dtype)
    if need_b:
        gb = g.to(b.dtype)
        if b.dim() == 2:
            a2 = a.reshape(-1, a.shape[-1])
            db = _mm_f32(a2.t().to(b.dtype), gb.reshape(-1, gb.shape[-1])).to(b.dtype)
        else:
            db = _mm_f32(a.transpose(-1, -2).to(b.dtype), gb).to(b.dtype)
    return da, db


def _weight_grad(a: torch.Tensor, g: torch.Tensor, batched: bool) -> torch.Tensor:
    """a^T g for a [..., K] and g [..., N]: summed over every leading dim (the
    gradient of a [K, N] operand), or batch by batch (of a batched one)."""
    if batched:
        return torch.matmul(a.transpose(-1, -2), g)
    return a.reshape(-1, a.shape[-1]).t() @ g.reshape(-1, g.shape[-1])


class _DotF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return _rounded_backward(a, b, g, *ctx.needs_input_grad)


def product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """dot_f32's product; on the GPU with bf16 operands without a derivative
    (for a caller that forms the gradient itself: ops/fused_bert.py's dense
    layer, dot_f32_backward)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        with full_f32():
            return torch.matmul(a, b)
    if a.device.type != "cuda":
        return torch.matmul(a.float(), b.float())
    return _mm_f32(a, b)


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as f32. b is [K, N], or batched like a ([..., K, N])."""
    if a.device.type == "cuda" and not (a.dtype == b.dtype == torch.float32):
        return _DotF32.apply(a, b)
    return product_f32(a, b)
