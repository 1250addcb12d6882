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

The tower opens spans (utils/profiling.py:span) while a profiler collects:
`proqa.tower` around a forward, and inside it `proqa.tower.attention` (n1,
the qkv product, RoPE, attention, o), `proqa.tower.mlp` (n2, gate and up,
SwiGLU, down) and `proqa.tower.pool` (the last tokens, the final norm, the
L2 normalisation); the ids' upload, the embedding rows, the RoPE tables and
the mask are `proqa.tower`'s own. `positions` and `tokens` count what the
tower was handed since `reset_counters()`: B x T positions, and the real
tokens among them (read from the mask where it arrives: a mask on the card
costs a synchronisation).

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

    def attention(self, x: torch.Tensor, cos, sin, bias) -> torch.Tensor:
        """Grouped-query attention of the normalised rows x [B, T, H]: the
        query heads of each kv head stacked along the rows of one product."""
        cfg = self.cfg
        b, t, _ = x.shape
        nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        g = nq // nkv
        # query head j = kv g + i reads kv head j // g: q [B, nkv, g T, hd],
        # k and v [B, nkv, T, hd], q and k rotated (ops/rope.py)
        q, k, v = rope.rope_qkv(self.qkv(x), cos, sin, nq, nkv)
        scores = dot_f32(q, k.transpose(-1, -2)).view(b, nkv, g, t, t)
        scores = scores / math.sqrt(hd) + bias[:, None, None]
        probs = torch.softmax(scores, dim=-1).to(x.dtype).view(b, nkv, g * t, t)
        ctx = dot_f32(probs, v).to(x.dtype)
        ctx = ctx.view(b, nkv, g, t, hd).permute(0, 3, 1, 2, 4).reshape(b, t, nq * hd)
        return self.o(ctx)

    def forward(self, x, residual, cos, sin, bias):
        """(x, residual) -> (the MLP's output, the residual stream before it):
        the next layer's n1 adds the two."""
        with span("proqa.tower.attention"):
            normed, h = self.attn_norm(x, residual)
            attn = self.attention(normed, cos, sin, bias)
        with span("proqa.tower.mlp"):
            normed, h = self.mlp_norm(attn, h)
            return self.down(swiglu(self.gate_up(normed))), h


class MistralModel(nn.Module):
    """The decoder tower: right-padded token ids and mask [B, T] (on the host
    or the tower's device) -> [B, H] f32 embeddings on the tower's device:
    the final hidden state of each row's last real token, RMS-normalised in
    cfg.dtype, then L2-normalised in f32."""

    def __init__(self, cfg: MistralConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype),
                                  requires_grad=False)
        self.layers = nn.ModuleList(DecoderLayer(cfg) for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype)

    def _layers(self, ids: torch.Tensor, mask: torch.Tensor):
        """The layers over ids and mask on the tower's device: (the last
        layer's output, the residual stream before it), which the final norm
        adds; (the embedding rows, None) without layers."""
        x, residual = self.embed[ids], None
        cos, sin = rope.rope_tables(ids.shape[1], self.cfg.head_dim, self.cfg.rope_theta,
                                    ids.device)
        bias = mask_bias(mask, self.cfg.sliding_window)
        for layer in self.layers:
            x, residual = layer(x, residual, cos, sin, bias)
        return x, residual

    @torch.no_grad()
    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        global calls, positions, tokens
        with span("proqa.tower"):
            calls += 1
            positions += attention_mask.numel()
            tokens += int(attention_mask.sum())
            device = self.embed.device
            ids = input_ids.to(device, torch.int64)
            mask = attention_mask.to(device)
            x, residual = self._layers(ids, mask)
            with span("proqa.tower.pool"):
                rows = torch.arange(ids.shape[0], device=device)
                last = mask.sum(dim=1).long() - 1  # right padding: the last real token
                pooled = self.norm(x[rows, last],
                                   None if residual is None else residual[rows, last])[0]
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
