"""Rotary positions fused into the q, k and v copy of the decoder's
grouped-query attention (models/mistral.py).

One product makes q, k and v side by side, [B, T, (nq + 2 nkv) hd]. The
attention's products want them head-major, with the g = nq / nkv query
heads of each kv head stacked along the rows of one product (so k and v are
never repeated), and q and k rotated by position: HF Mistral's rotate-half
form, x cos + (-x2, x1) sin, in f32 with f32 tables, rounded once. CUDA
tensors take the hand-written kernel (csrc/rope.cu): one read of the
product and one write of each output. CPU tensors take `rope_qkv_reference`,
the plain chain the kernel equals bit for bit.
"""
from __future__ import annotations

import torch

from proqa_tpu_torch import _build

# the kernel's forms, in the order of its form index: 8 elements of each
# half a thread (head dims a multiple of 16, 16-byte aligned), or one pair
ROPE_FORMS = ("vec", "scalar")

# kernel launches since the last reset (the main path's proof of use)
launches = 0


def rope_tables(t: int, head_dim: int, theta: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 cos and sin [T, head_dim] of positions 0..T-1 (HF Mistral's
    inv_freq = theta^(-2i / head_dim), the frequencies repeated for both
    halves)."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, device=device).float() / head_dim))
    freqs = torch.outer(torch.arange(t, device=device).float(), inv)
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, T, heads, hd] rotated by position in f32 (rotate-half form:
    x cos + (-x2, x1) sin), rounded once to x's dtype."""
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    rotated = torch.cat((-x2, x1), dim=-1)
    return (x32 * cos[:, None] + rotated * sin[:, None]).to(x.dtype)


def rope_qkv_reference(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, nq: int,
                       nkv: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (q [B, nkv, g T, hd], k [B, nkv, T, hd],
    v [B, nkv, T, hd]); row i T + t of q's kv head j is query head j g + i
    at position t."""
    b, t, width = qkv.shape
    hd = width // (nq + 2 * nkv)
    g = nq // nkv
    q, k, v = qkv.split([nq * hd, nkv * hd, nkv * hd], dim=-1)
    q = apply_rope(q.view(b, t, nq, hd), cos, sin)
    q = q.view(b, t, nkv, g, hd).permute(0, 2, 3, 1, 4).reshape(b, nkv, g * t, hd)
    k = apply_rope(k.view(b, t, nkv, hd), cos, sin).permute(0, 2, 1, 3).contiguous()
    v = v.reshape(b, t, nkv, hd).permute(0, 2, 1, 3).contiguous()
    return q, k, v


def rope_form(head_dim: int, aligned: bool) -> str:
    """The form the kernel takes for this head dim and the alignment of its
    pointers (qkv, q, k, v): a name of ROPE_FORMS."""
    return "vec" if aligned and head_dim % 16 == 0 else "scalar"


def _rope_qkv_kernel(qkv, cos, sin, nq, nkv):
    global launches
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"rope_qkv kernel takes bf16 or f32, got {qkv.dtype}")
    b, t, width = qkv.shape
    hd = width // (nq + 2 * nkv)
    if nq % nkv or hd % 2 or width != (nq + 2 * nkv) * hd:
        raise ValueError(f"rope_qkv: width {width} is not {nq} q and 2 x {nkv} kv heads of an "
                         f"even head dim")
    for table in (cos, sin):
        if table.dtype != torch.float32 or table.shape != (t, hd) or table.device != qkv.device:
            raise ValueError(f"rope_qkv: tables must be f32 [{t}, {hd}] on {qkv.device}")
    qkv, cos, sin = qkv.contiguous(), cos.contiguous(), sin.contiguous()
    q = torch.empty(b, nkv, (nq // nkv) * t, hd, dtype=qkv.dtype, device=qkv.device)
    k = torch.empty(b, nkv, t, hd, dtype=qkv.dtype, device=qkv.device)
    v = torch.empty_like(k)
    aligned = all(x.data_ptr() % 16 == 0 for x in (qkv, q, k, v))
    form = rope_form(hd, aligned)
    _build.launch("proqa_rope_qkv", qkv.device, qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), b, t, nq, nkv, hd,
                  int(qkv.dtype == torch.bfloat16), ROPE_FORMS.index(form))
    launches += 1
    return q, k, v


def rope_qkv(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, nq: int,
             nkv: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k and v of the fused projection [B, T, (nq + 2 nkv) hd], q and k
    rotated by position, in the grouped layouts of rope_qkv_reference."""
    if qkv.device.type == "cuda":
        return _rope_qkv_kernel(qkv, cos, sin, nq, nkv)
    return rope_qkv_reference(qkv, cos, sin, nq, nkv)
