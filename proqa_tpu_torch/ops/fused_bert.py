"""The BERT layer's fused epilogues: F1, the dense epilogue, and F2, the
residual add with LayerNorm.

On the TPU, XLA fuses the work around each product of a BERT layer into the
product's output; there is no Pallas kernel for it. In eager PyTorch each of
these ops is a pass over f32 activations. Two hand-written kernels take
their place on the forwards that record no autograd graph:

- F1, `dense_epilogue` (csrc/dense_epilogue.cu): the f32 product plus the
  f32 bias, rounded once to the output dtype (proqa_tpu/models/bert.py:147-150);
  with `gelu`, exact GELU in f32 on that rounded value, rounded again
  (:273-274). Bound by bytes: 6 B an element in bf16.
- F2, `add_layer_norm` (csrc/layer_norm.cu): x + residual rounded to the
  activation dtype, then LayerNorm in f32 with a two-pass variance, scale and
  bias in f32, and one rounding (:137-144 with the residuals at :277, :286;
  the embedding LayerNorm at :241 has none). Bound by bytes: 6 B an element
  with a residual, 4 B without.

CUDA tensors run the kernels and raise where a kernel cannot take them, or
where a gradient is asked for (the kernels have no backward yet: the model
runs its differentiable ops there, models/bert.py). CPU tensors run
`dense_epilogue_reference` and `add_layer_norm_reference`, the plain PyTorch
chains the model ran before the kernels existed.
"""
from __future__ import annotations

import torch

from proqa_tpu_torch import _build

MAX_DENSE_COLS = 12_288  # F1 stages the bias row in 48 KB of shared memory
MAX_LN_WIDTH = 1_024     # F2 holds a row in a warp's registers, 32 floats a lane
_DTYPES = (torch.bfloat16, torch.float32)

# kernel launches since the last reset (the main path's proof of use)
dense_launches = 0
layer_norm_launches = 0


def dense_epilogue_reference(y: torch.Tensor, bias: torch.Tensor, out_dtype: torch.dtype,
                             gelu: bool = False) -> torch.Tensor:
    """Plain PyTorch version of F1."""
    out = (y + bias).to(out_dtype)
    if gelu:
        out = torch.nn.functional.gelu(out.float(), approximate="none").to(out_dtype)
    return out


def add_layer_norm_reference(x: torch.Tensor, residual: torch.Tensor | None,
                             scale: torch.Tensor, bias: torch.Tensor,
                             eps: float) -> torch.Tensor:
    """Plain PyTorch version of F2."""
    if residual is not None:
        x = x + residual
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _no_gradient(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward: call it where no autograd graph is recorded")


def _check_params(name: str, width: int, device, *params) -> None:
    for p in params:
        if p.dtype != torch.float32 or p.shape != (width,) or p.device != device:
            raise ValueError(f"{name}: parameters must be f32 [{width}] on {device}, got "
                             f"{p.dtype} {tuple(p.shape)} on {p.device}")


def _dense_epilogue_kernel(y, bias, out_dtype, gelu):
    global dense_launches
    _no_gradient("dense_epilogue", y, bias)
    if y.dtype != torch.float32 or out_dtype not in _DTYPES:
        raise TypeError(f"dense_epilogue kernel takes an f32 product to bf16 or f32, got "
                        f"{y.dtype} to {out_dtype}")
    cols = y.shape[-1]
    if not 1 <= cols <= MAX_DENSE_COLS:
        raise ValueError(f"dense_epilogue kernel takes 1 to {MAX_DENSE_COLS} columns, got {cols}")
    _check_params("dense_epilogue", cols, y.device, bias)
    y, bias = y.contiguous(), bias.contiguous()
    out = torch.empty(y.shape, dtype=out_dtype, device=y.device)
    if out.numel():
        _build.launch("proqa_dense_epilogue", y.device, y.data_ptr(), bias.data_ptr(),
                      out.data_ptr(), y.numel() // cols, cols, int(out_dtype == torch.bfloat16),
                      int(gelu))
        dense_launches += 1
    return out


def _add_layer_norm_kernel(x, residual, scale, bias, eps):
    global layer_norm_launches
    _no_gradient("add_layer_norm", x, residual, scale, bias)
    if x.dtype not in _DTYPES:
        raise TypeError(f"add_layer_norm kernel takes bf16 or f32, got {x.dtype}")
    if residual is not None and (residual.dtype != x.dtype or residual.shape != x.shape
                                 or residual.device != x.device):
        raise ValueError(f"add_layer_norm: residual {residual.dtype} {tuple(residual.shape)} "
                         f"does not match x {x.dtype} {tuple(x.shape)}")
    h = x.shape[-1]
    if not 1 <= h <= MAX_LN_WIDTH:
        raise ValueError(f"add_layer_norm kernel takes widths 1 to {MAX_LN_WIDTH}, got {h}")
    _check_params("add_layer_norm", h, x.device, scale, bias)
    x, scale, bias = x.contiguous(), scale.contiguous(), bias.contiguous()
    residual = None if residual is None else residual.contiguous()
    out = torch.empty_like(x)
    if out.numel():
        _build.launch("proqa_add_layer_norm", x.device, x.data_ptr(),
                      None if residual is None else residual.data_ptr(), scale.data_ptr(),
                      bias.data_ptr(), out.data_ptr(), x.numel() // h, h, eps,
                      int(x.dtype == torch.bfloat16))
        layer_norm_launches += 1
    return out


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return False
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    return True


def dense_epilogue(y: torch.Tensor, bias: torch.Tensor, out_dtype: torch.dtype,
                   gelu: bool = False) -> torch.Tensor:
    """round(y + bias) in out_dtype for an f32 product y [..., N] and an f32
    bias [N]; with gelu, round(gelu(that)) after it (exact GELU in f32)."""
    if _on_cpu(y):
        return dense_epilogue_reference(y, bias, out_dtype, gelu)
    return _dense_epilogue_kernel(y, bias, out_dtype, gelu)


def add_layer_norm(x: torch.Tensor, residual: torch.Tensor | None, scale: torch.Tensor,
                   bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm(x + residual) over the last dim, in f32, rounded to x's
    dtype; the sum is rounded to x's dtype first. residual may be None."""
    if _on_cpu(x):
        return add_layer_norm_reference(x, residual, scale, bias, eps)
    return _add_layer_norm_kernel(x, residual, scale, bias, eps)
