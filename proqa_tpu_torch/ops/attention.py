"""Fused attention for BERT: forward (kernel K2) and backward (kernel K3).

Counterpart of proqa_tpu/ops/pallas_attention.py:fused_attention:
dropout(softmax(q k^T * sm_scale + key-padding bias)) v per (batch, head), in
the JAX layout [B, H, T, Dh], with inverted dropout on the attention
probabilities. The mask of element (b, h, i, j) comes from the counter-based
bits of its flat index under the caller's seed (ops/random.py), so the
backward regenerates it: only q, k, v, the key mask and the seed are saved
(`_fa_fwd`, pallas_attention.py:170-172). CUDA tensors run the hand-written
kernels csrc/attention_fwd.cu and csrc/attention_bwd.cu; CPU tensors run
`fused_attention_reference` and `fused_attention_backward_reference`, their
plain PyTorch versions, which draw the same bits.
"""
from __future__ import annotations

import torch

from proqa_tpu_torch import _build
from proqa_tpu_torch.ops import random
from proqa_tpu_torch.ops.dot import dot_f32

MASK_BIAS = -1e30  # pallas_attention.py:32; -inf would turn all-padding rows into NaN
HEAD_DIMS = (16, 64)  # BertConfig.tiny and BERT-base; the kernels are instantiated for these
STREAM = 1  # the stream id of attention-probability masks (ops/random.py:keys)

# kernel launches since the last reset (the main path's proof of use)
launches = 0           # K2, forward
backward_launches = 0  # K3


def _probs(q, k, key_mask, sm_scale, dropout_rate, seed):
    """(p, pd): the f32 softmax and its dropped-out version (pd is p at rate 0)."""
    s = dot_f32(q, k.transpose(-1, -2)) * sm_scale
    bias = torch.where(key_mask[:, None, None, :] != 0, 0.0, MASK_BIAS).to(torch.float32)
    p = torch.softmax(s + bias, dim=-1)
    if dropout_rate == 0.0:
        return p, p, None
    keep = random.keep_mask(seed, STREAM, dropout_rate, p.shape, p.device)
    inv = torch.tensor(1.0 / (1.0 - dropout_rate), dtype=torch.float32)
    return p, torch.where(keep, p * inv, 0.0), (keep, inv)


def fused_attention_reference(q, k, v, key_mask, *, sm_scale: float,
                              dropout_rate: float = 0.0, seed: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K2: f32 scores and softmax, dropout on the f32
    probabilities, which are then rounded to the input dtype for p v with f32
    accumulation (pallas_attention.py:73-80)."""
    _, pd, _ = _probs(q, k, key_mask, sm_scale, dropout_rate, seed)
    return dot_f32(pd.to(q.dtype), v).to(q.dtype)


def fused_attention_backward_reference(q, k, v, key_mask, do, *, sm_scale: float,
                                       dropout_rate: float = 0.0, seed: int = 0):
    """Plain PyTorch version of K3: (dq, dk, dv) by the formulas of the TPU
    kernel (pallas_attention.py:97-124), with the forward's mask regenerated."""
    p, pd, drop = _probs(q, k, key_mask, sm_scale, dropout_rate, seed)
    dv = dot_f32(pd.to(q.dtype).transpose(-1, -2), do).to(q.dtype)
    dp = dot_f32(do, v.transpose(-1, -2))
    if drop is not None:
        keep, inv = drop
        dp = torch.where(keep, dp * inv, 0.0)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    ds = (ds * sm_scale).to(q.dtype)
    dq = dot_f32(ds, k).to(q.dtype)
    dk = dot_f32(ds.transpose(-1, -2), q).to(q.dtype)
    return dq, dk, dv


def _check_kernel_inputs(tensors, dh):
    q = tensors[0]
    if q.dtype not in (torch.bfloat16, torch.float32) or any(x.dtype != q.dtype for x in tensors):
        raise TypeError(f"q, k, v (and do) must share a dtype of bf16 or f32, got "
                        f"{[x.dtype for x in tensors]}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")


def _aligned(name, x, device):
    if x.device != device or not x.is_contiguous() or x.data_ptr() % 32:
        raise ValueError(f"{name} must be a contiguous, 32-byte aligned tensor on {device}")


def _dropout_args(rate: float, seed: int):
    if rate == 0.0:
        return 0, 0, 0, 0, 1.0
    k0, k1 = random.keys(seed, STREAM)
    return 1, k0, k1, random.threshold(rate), 1.0 / (1.0 - rate)


def _forward_kernel(q, k, v, key_mask, sm_scale, rate, seed):
    global launches
    bsz, nh, t, dh = q.shape
    _check_kernel_inputs((q, k, v), dh)
    if key_mask.dtype != torch.int32:
        raise TypeError(f"key_mask must be int32, got {key_mask.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v), ("key_mask", key_mask)):
        _aligned(name, x, q.device)
    out = torch.empty_like(q)
    _build.launch("proqa_attention_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  key_mask.data_ptr(), out.data_ptr(), bsz, nh, t, dh, float(sm_scale),
                  int(q.dtype == torch.bfloat16), *_dropout_args(rate, seed))
    launches += 1
    return out


def _backward_kernel(q, k, v, key_mask, do, sm_scale, rate, seed):
    global backward_launches
    bsz, nh, t, dh = q.shape
    _check_kernel_inputs((q, k, v, do), dh)
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do), ("key_mask", key_mask)):
        _aligned(name, x, q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    # scratch (attention_bwd.cu): each query row's max logit, sum of exps, its
    # reciprocal and D; with dropout in bf16, the mask as bits, 1 per score
    stats = torch.empty(4, bsz * nh * t, dtype=torch.float32, device=q.device)
    bits = None
    if rate > 0.0 and q.dtype == torch.bfloat16:
        bits = torch.empty(bsz * nh * t * t // 64, dtype=torch.int64, device=q.device)
    _build.launch("proqa_attention_bwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  do.data_ptr(), key_mask.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  stats.data_ptr(), None if bits is None else bits.data_ptr(), bsz, nh, t, dh,
                  float(sm_scale), int(q.dtype == torch.bfloat16), *_dropout_args(rate, seed))
    backward_launches += 1
    return dq, dk, dv


def _on_cpu(q) -> bool:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return q.device.type == "cpu"


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask, sm_scale, rate, seed):
        ctx.save_for_backward(q, k, v, key_mask)
        ctx.args = (sm_scale, rate, seed)
        if _on_cpu(q):
            return fused_attention_reference(q, k, v, key_mask, sm_scale=sm_scale,
                                             dropout_rate=rate, seed=seed)
        return _forward_kernel(q, k, v, key_mask, sm_scale, rate, seed)

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask = ctx.saved_tensors
        sm_scale, rate, seed = ctx.args
        do = do.contiguous()
        if _on_cpu(q):
            grads = fused_attention_backward_reference(q, k, v, key_mask, do, sm_scale=sm_scale,
                                                       dropout_rate=rate, seed=seed)
        else:
            grads = _backward_kernel(q, k, v, key_mask, do, sm_scale, rate, seed)
        return (*grads, None, None, None, None)


def fused_attention(q, k, v, key_mask, *, sm_scale: float, dropout_rate: float = 0.0,
                    seed: int = 0) -> torch.Tensor:
    """q, k, v [B, H, T, Dh] (T % 128 == 0, T <= 1024); key_mask [B, T],
    nonzero = attend. Returns [B, H, T, Dh] in q's dtype, differentiable in
    q, k and v. At dropout_rate > 0, `seed` (64-bit) chooses the mask."""
    bsz, nh, t, dh = q.shape
    if t % 128 or t > 1024:
        raise ValueError(f"T={t} must be a multiple of 128 and <= 1024")
    if k.shape != q.shape or v.shape != q.shape or tuple(key_mask.shape) != (bsz, t):
        raise ValueError(
            f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
            f"key_mask {tuple(key_mask.shape)} do not match [B, H, T, Dh] / [B, T]"
        )
    random.threshold(dropout_rate)  # validates the rate
    return _FusedAttention.apply(q, k, v, key_mask, float(sm_scale), float(dropout_rate),
                                 int(seed))
