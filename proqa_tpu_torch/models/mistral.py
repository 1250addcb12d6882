"""A Mistral-style decoder as a retrieval tower (E5-Mistral-7B), inference only.

E5-Mistral-7B-instruct (Wang et al. 2024, arXiv:2401.00368) is
Mistral-7B-v0.1's decoder used as a dense retriever: queries and passages
run through one shared tower, and the embedding is the last real token's
final hidden state, L2-normalised. Each of the `num_layers` layers is

    h = x + o(attn(rope(q(n1(x))), rope(k(n1(x))), v(n1(x))))
    y = h + down(silu(gate(n2(h))) * up(n2(h)))

with RMSNorm n1, n2 (and a final one), grouped-query attention (query head
j reads kv head j // (num_heads // num_kv_heads); k and v are never repeated
in memory), rotary positions (HF Mistral's rotate-half form, positions 0..T-1
of each row), a causal mask that also hides keys `sliding_window` or more
positions back, a SwiGLU MLP and no biases. Rows are right-padded: the
padding comes after a row's last real token, which is the one pooled.

Numerics, the rounding points in order (activations in `cfg.dtype`, bf16 by
default; weights held in that dtype too, so a 7B tower is 14.5 GB):
- the embedding row, as held;
- n1 and n2 (F2's RMSNorm form, ops/fused_bert.py:add_rms_norm): the
  residual sum x + delta rounded; then (s * rsqrt(mean(s^2) + eps)) * scale
  in f32, rounded once (HF rounds s * rstd before the scale: one rounding
  fewer here);
- each projection (q, k and v as one product, o, gate and up as one
  product, down): a product of bf16 operands with f32 sums, rounded once
  (cuBLAS on the card; on the CPU the f32 product of the up-cast operands,
  then rounded);
- RoPE in f32 on the rounded q and k, with f32 cos and sin, rounded once
  (HF rounds cos, sin and each product to bf16); on the card a kernel does
  it in the copy of q, k and v into the attention's layouts (ops/rope.py);
- the scores q k^T in f32 (bf16 operands), over sqrt(head_dim) and plus the
  additive mask (-1e30) in f32, softmax in f32, the probabilities rounded,
  their product with v in f32, rounded;
- the MLP's epilogue (F1's SwiGLU form, fused_bert.swiglu): silu(gate) * up
  in f32 on the rounded products, rounded once (HF rounds silu(gate) first);
- the final RMSNorm at each row's last real token, as n1; then the L2
  normalisation in f32, which is the f32 embedding.

Attention takes the plain route at every length: K2 (ops/attention.py) has
no causal or grouped-query form, and its rule (T % 128 == 0) would not
admit a query's lengths anyway.

Packed rows: every position-wise step (the embedding rows, n1 and n2, the
qkv, o, gate_up and down products, SwiGLU, the residual stream) runs over a
batch's N real tokens alone, [N, H], the rows laid end to end (row b's token
t at packed row cu_seqlens[b] + t, `Packing`). Only the attention needs the
rows apart: the RoPE copy (ops/rope.py:rope_qkv_packed) writes q, k and v
into the padded grouped layouts, zeros past each row's length, the scores,
mask, softmax and p v run there, and one gather takes the real rows of the
context back to [N, nq hd]. A batch without padding is the case N = B x T.
A real row sees the operands, rounding points, window and mask of a padded
run over every position; only the products' M differs, so cuBLAS may sum in
another order.

The tower opens spans (utils/profiling.py:span) while a profiler collects:
`proqa.tower` around a forward, and inside it `proqa.tower.attention` (n1,
the qkv product, RoPE, attention, o), `proqa.tower.mlp` (n2, gate and up,
SwiGLU, down) and `proqa.tower.pool` (the last tokens, the final norm, the
L2 normalisation); the ids' upload, the packing, the embedding rows, the
RoPE tables and the mask are `proqa.tower`'s own. `positions` and `tokens`
count what the tower was handed since `reset_counters()`: B x T positions,
and the real tokens among them, which are the rows its projections run
over (read from the mask where it arrives: a mask on the card costs a
synchronisation).

Weights are keyed as this module's state dict; models/hf_convert.py maps HF
Mistral names onto them.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from proqa_tpu_torch.ops import rope
from proqa_tpu_torch.ops.attention import MASK_BIAS
from proqa_tpu_torch.ops.dot import dot_f32
from proqa_tpu_torch.ops.fused_bert import add_rms_norm, swiglu
from proqa_tpu_torch.utils.profiling import span

# what the tower was handed since reset_counters(): calls, B x T positions,
# and the real tokens among them
calls = 0
positions = 0
tokens = 0


def reset_counters() -> None:
    global calls, positions, tokens
    calls = positions = tokens = 0


@dataclasses.dataclass(frozen=True)
class MistralConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 14336
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    sliding_window: int | None = 4096  # None: causal only
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.bfloat16  # weights and activations

    def __post_init__(self):
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"{self.num_heads} query heads do not share "
                             f"{self.num_kv_heads} kv heads evenly")
        if self.head_dim % 2:
            raise ValueError(f"head_dim {self.head_dim}: rotary positions take an even width")

    @classmethod
    def from_json(cls, cfg: dict) -> "MistralConfig":
        """The config from HF Mistral's published keys (config.json)."""
        heads = cfg["num_attention_heads"]
        base = dict(vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
                    num_layers=cfg["num_hidden_layers"], num_heads=heads,
                    num_kv_heads=cfg.get("num_key_value_heads", heads),
                    head_dim=cfg.get("head_dim") or cfg["hidden_size"] // heads,
                    intermediate_size=cfg["intermediate_size"],
                    rope_theta=float(cfg.get("rope_theta", 10000.0)),
                    rms_norm_eps=float(cfg.get("rms_norm_eps", 1e-5)),
                    sliding_window=cfg.get("sliding_window"),
                    initializer_range=cfg.get("initializer_range", 0.02))
        if "torch_dtype" in cfg:
            base["dtype"] = getattr(torch, cfg["torch_dtype"])
        return cls(**base)

    @classmethod
    def tiny(cls, **kw) -> "MistralConfig":
        """Small config for tests: 4 query heads over 2 kv heads of 16."""
        base = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                    head_dim=16, intermediate_size=160)
        base.update(kw)
        return cls(**base)

    @property
    def qkv_width(self) -> int:
        return (self.num_heads + 2 * self.num_kv_heads) * self.head_dim


def _linear(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """x @ kernel ([in, out]) with f32 sums, rounded once to x's dtype."""
    if x.device.type == "cuda":
        return torch.matmul(x, kernel)
    return torch.matmul(x.float(), kernel.float()).to(x.dtype)


class Linear(nn.Module):
    """A projection with no bias, its kernel [in, out] in the model's dtype."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(d_in, d_out, dtype=dtype), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(x, self.kernel)


class RMSNorm(nn.Module):
    """RMSNorm(x + residual), F2's RMSNorm form; returns (normalised, sum)."""

    def __init__(self, width: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(width, dtype=dtype), requires_grad=False)
        self.eps = eps

    def forward(self, x, residual=None):
        return add_rms_norm(x, residual, self.scale, self.eps)


def mask_bias(mask: torch.Tensor, window: int | None) -> torch.Tensor:
    """[B, T, T] f32 additive mask: query i sees key j where j <= i, i - j <
    window (when there is one) and key j is a real token."""
    t = mask.shape[1]
    pos = torch.arange(t, device=mask.device)
    seen = pos[None, :] <= pos[:, None]
    if window is not None:
        seen = seen & (pos[:, None] - pos[None, :] < window)
    seen = seen[None] & (mask[:, None, :] != 0)
    return torch.where(seen, 0.0, MASK_BIAS).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class Packing:
    """The real tokens of a right-padded batch [B, T], laid end to end: row
    b's token t is packed row cu_seqlens[b] + t. Tensors on the tower's
    device; `row` and `pos` give each packed row's b and t."""
    cu_seqlens: torch.Tensor  # [B + 1] int64
    row: torch.Tensor  # [N] int64
    pos: torch.Tensor  # [N] int64
    length: int  # T

    @classmethod
    def of(cls, lengths: torch.Tensor, length: int, device) -> "Packing":
        """From the rows' lengths [B] on the host: the offsets uploaded, each
        packed row's b and t derived from them on the device."""
        cu = torch.zeros(lengths.numel() + 1, dtype=torch.int64)
        torch.cumsum(lengths, 0, out=cu[1:])
        n = int(cu[-1])
        cu = cu.to(device)
        row = torch.repeat_interleave(torch.arange(lengths.numel(), device=device), cu.diff(),
                                      output_size=n)
        return cls(cu, row, torch.arange(n, device=device) - cu[row], length)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: MistralConfig):
        super().__init__()
        h, dt = cfg.hidden_size, cfg.dtype
        self.cfg = cfg
        self.attn_norm = RMSNorm(h, cfg.rms_norm_eps, dt)
        self.qkv = Linear(h, cfg.qkv_width, dt)
        self.o = Linear(cfg.num_heads * cfg.head_dim, h, dt)
        self.mlp_norm = RMSNorm(h, cfg.rms_norm_eps, dt)
        self.gate_up = Linear(h, 2 * cfg.intermediate_size, dt)
        self.down = Linear(cfg.intermediate_size, h, dt)

    def attention(self, x: torch.Tensor, cos, sin, bias, packing: Packing) -> torch.Tensor:
        """Grouped-query attention of the normalised packed rows x [N, H]:
        the query heads of each kv head stacked along the rows of one
        product, over the padded rows."""
        cfg = self.cfg
        nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        g = nq // nkv
        # query head j = kv g + i reads kv head j // g: q [B, nkv, g T, hd],
        # k and v [B, nkv, T, hd], q and k rotated (ops/rope.py), zeros past
        # each row's length
        q, k, v = rope.rope_qkv_packed(self.qkv(x), packing.cu_seqlens, packing.length, cos, sin,
                                       nq, nkv)
        b, t = k.shape[0], k.shape[2]
        scores = dot_f32(q, k.transpose(-1, -2)).view(b, nkv, g, t, t)
        scores = scores / math.sqrt(hd) + bias[:, None, None]
        probs = torch.softmax(scores, dim=-1).to(x.dtype).view(b, nkv, g * t, t)
        ctx = dot_f32(probs, v).to(x.dtype)
        # the real rows in one gather from the permuted view, each head's
        # row moved as 8-byte words where they tile it, else 4-byte ones (an
        # even head dim of at least 2-byte elements): the gather's cost is
        # per element
        row_bytes = hd * ctx.element_size()
        word = torch.int64 if row_bytes % 8 == 0 else torch.int32
        ctx = ctx.view(word).view(b, nkv, g, t, row_bytes // word.itemsize).permute(0, 3, 1, 2, 4)
        return self.o(ctx[packing.row, packing.pos].view(x.dtype).view(-1, nq * hd))

    def forward(self, x, residual, cos, sin, bias, packing: Packing):
        """(x, residual) -> (the MLP's output, the residual stream before it):
        the next layer's n1 adds the two. Packed rows [N, H]."""
        with span("proqa.tower.attention"):
            normed, h = self.attn_norm(x, residual)
            attn = self.attention(normed, cos, sin, bias, packing)
        with span("proqa.tower.mlp"):
            normed, h = self.mlp_norm(attn, h)
            return self.down(swiglu(self.gate_up(normed))), h


class MistralModel(nn.Module):
    """The decoder tower: right-padded token ids and mask [B, T] (on the host
    or the tower's device; each row's mask ones, at least one, then zeros, or
    ValueError) -> [B, H] f32 embeddings on the tower's device: the final
    hidden state of each row's last real token, RMS-normalised in cfg.dtype,
    then L2-normalised in f32."""

    def __init__(self, cfg: MistralConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype),
                                  requires_grad=False)
        self.layers = nn.ModuleList(DecoderLayer(cfg) for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype)

    def _layers(self, ids: torch.Tensor, mask: torch.Tensor, packing: Packing):
        """The layers over the packed ids [N] with their packing and the mask
        [B, T], on the tower's device: (the last layer's output, the residual
        stream before it), which the final norm adds; (the embedding rows,
        None) without layers."""
        x, residual = self.embed[ids], None
        cos, sin = rope.rope_tables(mask.shape[1], self.cfg.head_dim, self.cfg.rope_theta,
                                    mask.device)
        bias = mask_bias(mask, self.cfg.sliding_window)
        for layer in self.layers:
            x, residual = layer(x, residual, cos, sin, bias, packing)
        return x, residual

    @torch.no_grad()
    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        global calls, positions, tokens
        with span("proqa.tower"):
            real = attention_mask.to("cpu") != 0
            t = real.shape[1]
            lengths = real.sum(dim=1)
            prefix = torch.equal(real, torch.arange(t) < lengths[:, None])
            if not prefix or bool((lengths < 1).any()):
                raise ValueError("the tower takes right-padded rows of at least one token: each "
                                 "row's mask ones, then zeros")
            calls += 1
            positions += real.numel()
            tokens += int(lengths.sum())
            device = self.embed.device
            ids = input_ids[real.to(input_ids.device)].to(device, torch.int64)  # the real ids
            packing = Packing.of(lengths, t, device)
            mask = torch.arange(t, device=device) < packing.cu_seqlens.diff()[:, None]
            x, residual = self._layers(ids, mask, packing)
            with span("proqa.tower.pool"):
                last = packing.cu_seqlens[1:] - 1  # each row's last token
                pooled = self.norm(x[last], None if residual is None else residual[last])[0]
                return torch.nn.functional.normalize(pooled.float(), dim=-1)


def init_parameters(module: nn.Module, std: float, generator: torch.Generator) -> None:
    """normal(0, std) kernels and embedding rows, RMSNorm scales 1 +
    normal(0, 0.1): random weights for tests and benchmarks, every term of
    the arithmetic non-trivial. Drawn in f32 on the generator's device."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            draw = torch.randn(p.shape, generator=generator, device=generator.device)
            p.copy_(1.0 + 0.1 * draw if name.endswith("scale") else std * draw)


class MistralRetriever(nn.Module):
    """E5-Mistral's retriever: one tower for queries and passages, no
    projection; the embedding is the pooled state, L2-normalised. It has the
    encode methods of models/retriever.py:Retriever, so encode_corpus and
    the retrieve path take it as they take the BERT retriever."""

    def __init__(self, cfg: MistralConfig):
        super().__init__()
        self.cfg = cfg
        self.tower = MistralModel(cfg)

    def reset_parameters(self, seed: int) -> "MistralRetriever":
        init_parameters(self, self.cfg.initializer_range, torch.Generator().manual_seed(seed))
        return self

    @classmethod
    def on_device(cls, cfg: MistralConfig, device, seed: int) -> "MistralRetriever":
        """A retriever with init_parameters' random weights drawn on `device`
        itself from `seed`, never held on the host (at E5's widths 7.1B
        parameters, minutes for a host generator)."""
        with torch.device("meta"):
            model = cls(cfg)
        model = model.to_empty(device=device)
        init_parameters(model, cfg.initializer_range,
                        torch.Generator(device=device).manual_seed(seed))
        return model.eval()

    def encode_query(self, input_ids, attention_mask, *, generator=None,
                     deterministic: bool = False) -> torch.Tensor:
        """[B, T] right-padded ids and mask (on the host or the tower's
        device) -> [B, H] f32 unit-norm embeddings on the tower's device. The
        instruction prefix is part of the ids. generator and deterministic
        are accepted for Retriever's signature; the tower has no dropout."""
        return self.tower(input_ids, attention_mask)

    def encode_context(self, input_ids, attention_mask, *, generator=None,
                       deterministic: bool = False) -> torch.Tensor:
        """As encode_query: passages share the tower (and take no prefix)."""
        return self.tower(input_ids, attention_mask)
