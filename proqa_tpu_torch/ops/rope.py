"""Rotary positions fused into the q, k and v copy of the decoder's
grouped-query attention (models/mistral.py).

The decoder runs its projections over a batch's real tokens alone, so one
product makes q, k and v side by side for the B right-padded rows laid end
to end, [N, (nq + 2 nkv) hd], row b's token t at packed row cu_seqlens[b] +
t. The attention's products want them padded and head-major, with the g =
nq / nkv query heads of each kv head stacked along the rows of one product
(so k and v are never repeated), and q and k rotated by position: HF
Mistral's rotate-half form, x cos + (-x2, x1) sin, in f32 with f32 tables,
rounded once, and zeros at every position past a row's length. CUDA tensors
take the hand-written kernel (csrc/rope.cu): one read of the product and one
write of each output. CPU tensors take `rope_qkv_packed_reference`, the
plain chain the kernel equals bit for bit, built on `rope_qkv_reference`,
the plain copy of a padded [B, T, width] product.
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
    """The plain copy of a padded product [B, T, width]: (q [B, nkv, g T,
    hd], k [B, nkv, T, hd], v [B, nkv, T, hd]); row i T + t of q's kv head j
    is query head j g + i at position t."""
    b, t, width = qkv.shape
    hd = width // (nq + 2 * nkv)
    g = nq // nkv
    q, k, v = qkv.split([nq * hd, nkv * hd, nkv * hd], dim=-1)
    q = apply_rope(q.view(b, t, nq, hd), cos, sin)
    q = q.view(b, t, nkv, g, hd).permute(0, 2, 3, 1, 4).reshape(b, nkv, g * t, hd)
    k = apply_rope(k.view(b, t, nkv, hd), cos, sin).permute(0, 2, 1, 3).contiguous()
    v = v.reshape(b, t, nkv, hd).permute(0, 2, 1, 3).contiguous()
    return q, k, v


def rope_qkv_packed_reference(qkv: torch.Tensor, cu_seqlens: torch.Tensor, t: int,
                              cos: torch.Tensor, sin: torch.Tensor, nq: int,
                              nkv: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the packed form: the real rows [N, width]
    placed at their padded positions of [B, T, width], then
    rope_qkv_reference, then zeros at every position past a row's length."""
    lengths = cu_seqlens.diff().to(qkv.device)
    b, width = lengths.numel(), qkv.shape[1]
    real = torch.arange(t, device=qkv.device)[None] < lengths[:, None]  # [B, T]
    padded = qkv.new_zeros(b, t, width)
    padded[real] = qkv
    q, k, v = rope_qkv_reference(padded, cos, sin, nq, nkv)
    pad = ~real[:, None, :, None]  # [B, 1, T, 1]
    q = q.view(b, nkv, nq // nkv, t, k.shape[-1]).masked_fill(pad[:, :, None], 0).view(q.shape)
    return q, k.masked_fill(pad, 0), v.masked_fill(pad, 0)


def rope_form(head_dim: int, aligned: bool) -> str:
    """The form the kernel takes for this head dim and the alignment of its
    pointers (qkv, q, k, v): a name of ROPE_FORMS."""
    return "vec" if aligned and head_dim % 16 == 0 else "scalar"


def _rope_qkv_packed_kernel(qkv, cu_seqlens, t, cos, sin, nq, nkv):
    """Checks the product [N, width], width (nq + 2 nkv) hd, its row offsets
    and the tables [T, hd], allocates q, k and v in the padded grouped
    layouts of B rows of T, and launches the kernel."""
    global launches
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"rope_qkv_packed takes bf16 or f32, got {qkv.dtype}")
    if qkv.dim() != 2 or cu_seqlens.dtype != torch.int64 or cu_seqlens.dim() != 1 or \
            cu_seqlens.device != qkv.device:
        raise ValueError(f"rope_qkv_packed takes [N, width] rows and 1-D int64 cu_seqlens on "
                         f"{qkv.device}")
    width = qkv.shape[-1]
    hd = width // (nq + 2 * nkv)
    if nq % nkv or hd % 2 or width != (nq + 2 * nkv) * hd:
        raise ValueError(f"rope_qkv_packed: width {width} is not {nq} q and 2 x {nkv} kv heads "
                         f"of an even head dim")
    for table in (cos, sin):
        if table.dtype != torch.float32 or table.shape != (t, hd) or table.device != qkv.device:
            raise ValueError(f"rope_qkv_packed: tables must be f32 [{t}, {hd}] on {qkv.device}")
    qkv, cu_seqlens = qkv.contiguous(), cu_seqlens.contiguous()
    cos, sin = cos.contiguous(), sin.contiguous()
    b = cu_seqlens.numel() - 1
    q = torch.empty(b, nkv, (nq // nkv) * t, hd, dtype=qkv.dtype, device=qkv.device)
    k = torch.empty(b, nkv, t, hd, dtype=qkv.dtype, device=qkv.device)
    v = torch.empty_like(k)
    form = rope_form(hd, all(x.data_ptr() % 16 == 0 for x in (qkv, q, k, v)))
    _build.launch("proqa_rope_qkv_packed", qkv.device, qkv.data_ptr(), cu_seqlens.data_ptr(),
                  cos.data_ptr(), sin.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), b, t,
                  nq, nkv, hd, int(qkv.dtype == torch.bfloat16), ROPE_FORMS.index(form))
    launches += 1
    return q, k, v


def rope_qkv_packed(qkv: torch.Tensor, cu_seqlens: torch.Tensor, t: int, cos: torch.Tensor,
                    sin: torch.Tensor, nq: int,
                    nkv: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k and v of the fused projection of a batch's real tokens [N, (nq +
    2 nkv) hd] (row b's token t at packed row cu_seqlens[b] + t; cu_seqlens
    [B + 1] int64 on qkv's device, cu_seqlens[B] = N, no row longer than t),
    q and k rotated at their positions, in the padded grouped layouts of
    rope_qkv_reference with zeros past each row's length."""
    if qkv.device.type == "cuda":
        return _rope_qkv_packed_kernel(qkv, cu_seqlens, t, cos, sin, nq, nkv)
    return rope_qkv_packed_reference(qkv, cu_seqlens, t, cos, sin, nq, nkv)
