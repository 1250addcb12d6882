"""Fused attention forward (kernel K2) for BERT encoding.

Counterpart of proqa_tpu/ops/pallas_attention.py:fused_attention at dropout
rate 0: softmax(q k^T * sm_scale + key-padding bias) v per (batch, head), in
the JAX layout [B, H, T, Dh]. CUDA tensors run the hand-written kernel in
csrc/attention_fwd.cu; CPU tensors run `fused_attention_reference`, its plain
PyTorch version. The backward kernel and in-kernel dropout belong to the
training slice and are not here.
"""
from __future__ import annotations

import torch

from proqa_tpu_torch import _build
from proqa_tpu_torch.ops.dot import dot_f32

MASK_BIAS = -1e30  # pallas_attention.py:32; -inf would turn all-padding rows into NaN
HEAD_DIMS = (16, 64)  # BertConfig.tiny and BERT-base; the kernel is instantiated for these

# kernel launches since the last reset (the main path's proof of use)
launches = 0


def fused_attention_reference(q, k, v, key_mask, *, sm_scale: float) -> torch.Tensor:
    """Plain PyTorch version: f32 scores and softmax, probabilities rounded to
    the input dtype for p v with f32 accumulation."""
    s = dot_f32(q, k.transpose(-1, -2)) * sm_scale
    bias = torch.where(key_mask[:, None, None, :] != 0, 0.0, MASK_BIAS).to(torch.float32)
    p = torch.softmax(s + bias, dim=-1)
    return dot_f32(p.to(q.dtype), v).to(q.dtype)


def fused_attention(q, k, v, key_mask, *, sm_scale: float,
                    dropout_rate: float = 0.0) -> torch.Tensor:
    """q, k, v [B, H, T, Dh] (T % 128 == 0, T <= 1024); key_mask [B, T],
    nonzero = attend. Returns [B, H, T, Dh] in q's dtype."""
    global launches
    bsz, nh, t, dh = q.shape
    if t % 128 or t > 1024:
        raise ValueError(f"T={t} must be a multiple of 128 and <= 1024")
    if k.shape != q.shape or v.shape != q.shape or tuple(key_mask.shape) != (bsz, t):
        raise ValueError(
            f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
            f"key_mask {tuple(key_mask.shape)} do not match [B, H, T, Dh] / [B, T]"
        )
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention-probability dropout needs the training kernels "
            "(ROADMAP Queue 2: K3, K4)"
        )
    if any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "fused_attention has no backward yet (ROADMAP Queue 2: K3); "
            "call it under torch.no_grad()"
        )
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, key_mask, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype of bf16 or f32, got {q.dtype}, {k.dtype}, {v.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    if key_mask.dtype != torch.int32:
        raise TypeError(f"key_mask must be int32, got {key_mask.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v), ("key_mask", key_mask)):
        if x.device != q.device or not x.is_contiguous() or x.data_ptr() % 32:
            raise ValueError(f"{name} must be a contiguous, 32-byte aligned tensor on {q.device}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = _build.library().proqa_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(), out.data_ptr(),
            bsz, nh, t, dh, float(sm_scale), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "attention_fwd")
    launches += 1
    return out
