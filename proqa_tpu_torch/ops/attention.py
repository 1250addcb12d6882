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

The kernels are built for head dims 16, 32, 64, 128 and 256 (HEAD_DIMS), and
past 256 for every multiple of LOOP_CHUNK (the loop forms, which stream the
operands in 128-column chunks and pass the rounded probabilities, or K3's
ds, ds^T and pd^T, to slice kernels through a scratch array; K3 takes that
form from 256). On the card any other head dim reaches the
next of these zero-padded along Dh (`kernel_head_dim`, `pad_head_dim`): 48
runs as 64, 192 as 256, 320 as 384 (a fifth of the padded columns wasted),
257 as 384 (a third). A zero column adds an exact zero to every q k^T product
and gives zero output columns, which are sliced off, so only the order of
the f32 sums can differ from a kernel built for that dh. `sm_scale` stays
the caller's. No head dim raises. The plain versions take any head dim as it
is.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from proqa_tpu_torch import _build
from proqa_tpu_torch.ops import random
from proqa_tpu_torch.ops.dot import dot_f32

MASK_BIAS = -1e30  # pallas_attention.py:32; -inf would turn all-padding rows into NaN
# the kernels' instantiations: BertConfig.tiny, MiniLM (hidden 384 over 12
# heads), BERT-base and -large, 8 heads over 1,024, and Gemma's head dim
HEAD_DIMS = (16, 32, 64, 128, 256)
LOOP_CHUNK = 128  # past HEAD_DIMS[-1]: the loop forms take multiples of this
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


def kernel_head_dim(dh: int) -> int:
    """The head dim of the kernel form that runs head dim dh: dh itself where
    a form is built for it, else the next larger, reached by zero-padding:
    the next of HEAD_DIMS up to its last, past it the next multiple of
    LOOP_CHUNK. Raises only for a head dim below 1."""
    if dh < 1:
        raise ValueError(f"head dim {dh}: no such head dim")
    for built in HEAD_DIMS:
        if dh <= built:
            return built
    return -(-dh // LOOP_CHUNK) * LOOP_CHUNK


def pad_head_dim(x: torch.Tensor, dh: int) -> torch.Tensor:
    """x [..., d] as a contiguous [..., dh] tensor, zero columns after x's
    own: one copy (none if x is contiguous and d == dh)."""
    if x.shape[-1] == dh:
        return x.contiguous()
    return F.pad(x, (0, dh - x.shape[-1])).contiguous()


def _check_kernel_inputs(tensors):
    q = tensors[0]
    if q.dtype not in (torch.bfloat16, torch.float32) or any(x.dtype != q.dtype for x in tensors):
        raise TypeError(f"q, k, v (and do) must share a dtype of bf16 or f32, got "
                        f"{[x.dtype for x in tensors]}")


def _aligned(name, x, device):
    if x.device != device or not x.is_contiguous() or x.data_ptr() % 32:
        raise ValueError(f"{name} must be a contiguous, 32-byte aligned tensor on {device}")


def _dropout_args(rate: float, seed: int):
    if rate == 0.0:
        return 0, 0, 0, 0, 1.0
    k0, k1 = random.keys(seed, STREAM)
    return 1, k0, k1, random.threshold(rate), 1.0 / (1.0 - rate)


def _loop_scratch(q, arrays: int, first: int):
    """The bf16 loop forms' scratch from head dim `first` on (else None):
    `arrays` arrays of every 64 x 64 tile of the scores as wgmma A fragments,
    8 KB a tile (attention_tiles.cuh:frag_tile)."""
    bsz, nh, t, dh = q.shape
    if q.dtype != torch.bfloat16 or dh < first:
        return None
    return torch.empty(arrays * bsz * nh * (t // 64) ** 2 * 2048, dtype=torch.int32,
                       device=q.device)


def _forward_kernel(q, k, v, key_mask, sm_scale, rate, seed):
    global launches
    bsz, nh, t, dh = q.shape
    built = kernel_head_dim(dh)
    if built != dh:
        out = _forward_kernel(*(pad_head_dim(x, built) for x in (q, k, v)), key_mask, sm_scale,
                              rate, seed)
        return out[..., :dh].contiguous()
    _check_kernel_inputs((q, k, v))
    if key_mask.dtype != torch.int32:
        raise TypeError(f"key_mask must be int32, got {key_mask.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v), ("key_mask", key_mask)):
        _aligned(name, x, q.device)
    out = torch.empty_like(q)
    frags = _loop_scratch(q, 1, HEAD_DIMS[-1] + LOOP_CHUNK)  # p, past the Dh 256 form
    _build.launch("proqa_attention_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  key_mask.data_ptr(), out.data_ptr(), None if frags is None else frags.data_ptr(),
                  bsz, nh, t, dh, float(sm_scale), int(q.dtype == torch.bfloat16),
                  *_dropout_args(rate, seed))
    launches += 1
    return out


def _backward_kernel(q, k, v, key_mask, do, sm_scale, rate, seed):
    global backward_launches
    bsz, nh, t, dh = q.shape
    built = kernel_head_dim(dh)
    if built != dh:
        q, k, v, do = (pad_head_dim(x, built) for x in (q, k, v, do))
        grads = _backward_kernel(q, k, v, key_mask, do, sm_scale, rate, seed)
        return tuple(g[..., :dh].contiguous() for g in grads)
    _check_kernel_inputs((q, k, v, do))
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do), ("key_mask", key_mask)):
        _aligned(name, x, q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    # scratch (attention_bwd.cu): each query row's max logit, sum of exps, its
    # reciprocal and D; with dropout in bf16, the mask as bits, 1 per score
    stats = torch.empty(4, bsz * nh * t, dtype=torch.float32, device=q.device)
    bits, frags = None, _loop_scratch(q, 3, HEAD_DIMS[-1])  # ds, ds^T and pd^T, from 256
    if frags is None and rate > 0.0 and q.dtype == torch.bfloat16:
        bits = torch.empty(bsz * nh * t * t // 64, dtype=torch.int64, device=q.device)
    _build.launch("proqa_attention_bwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  do.data_ptr(), key_mask.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  stats.data_ptr(), None if bits is None else bits.data_ptr(),
                  None if frags is None else frags.data_ptr(), bsz, nh, t, dh,
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
    """q, k, v [B, H, T, Dh] (T % 128 == 0, T <= 1024; any Dh); key_mask
    [B, T], nonzero = attend. Returns [B, H, T, Dh] in q's dtype,
    differentiable in q, k and v. At dropout_rate > 0, `seed` (64-bit)
    chooses the mask."""
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
