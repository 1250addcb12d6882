"""BERT encoder in PyTorch, for inference and training.

Counterpart of proqa_tpu/models/bert.py, with the same numerics policy:
f32 parameters, activations in `cfg.dtype` (bf16 by default), each dense
layer a product of bf16 operands accumulated in f32 plus an f32 bias and then
rounded, LayerNorm in f32 (eps 1e-12), exact GELU in f32, softmax in f32,
the pooler's tanh in f32, and an additive key mask of -1e30.

Training adds dropout at the sites and in the order of bert.py:247-296: the
embedding output, the attention probabilities (kernel K2 in the fused path,
K4 in the vanilla one), the attention output and the MLP output, each with
its own seed drawn from the caller's torch.Generator (one per site and
layer; this replaces JAX's key splits, so the bits differ by design). Every
dropout regenerates its mask from its seed, so rematerialisation
(torch.utils.checkpoint over a layer or its MLP block) recomputes the same
masks.

Weights keep the JAX layout: dense kernels are [in, out], so
models/convert.py maps a JAX parameter tree onto this module by unstacking the
per-layer leaves.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from proqa_tpu_torch.ops.attention import MASK_BIAS, fused_attention
from proqa_tpu_torch.ops.dot import dot_f32
from proqa_tpu_torch.ops.dropout import dropout

SEED_RANGE = 1 << 62  # dropout seeds are drawn uniformly below this


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.bfloat16  # activation / compute dtype
    remat: bool = False  # recompute activations in backward (torch.utils.checkpoint)
    remat_scope: str = "layer"  # "layer": the whole layer; "mlp": only the MLP block
    flash_attention: bool = False  # kernels K2/K3 for T % 128 == 0, T <= 1024

    def __post_init__(self):
        if self.remat_scope not in ("layer", "mlp"):
            raise ValueError(f"remat_scope={self.remat_scope!r}: must be 'layer' or 'mlp'")

    @property
    def head_dim(self) -> int:
        assert self.hidden_size % self.num_heads == 0
        return self.hidden_size // self.num_heads

    @classmethod
    def tiny(cls, **kw) -> "BertConfig":
        """Small config for tests (the JAX package's BertConfig.tiny)."""
        base = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
                    intermediate_size=64, max_position_embeddings=64)
        base.update(kw)
        return cls(**base)


class Dense(nn.Module):
    """y = x @ kernel + bias with kernel [in, out]. The product takes the
    kernel in x's dtype and accumulates in f32; the f32 bias is added before
    the result is rounded to `out_dtype` (x's dtype unless given)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(d_in, d_out))
        self.bias = nn.Parameter(torch.zeros(d_out))

    def forward(self, x: torch.Tensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
        y = dot_f32(x, self.kernel.to(x.dtype)) + self.bias
        return y.to(out_dtype or x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm in f32 whatever the activation dtype; returns x's dtype."""

    def __init__(self, width: int, eps: float):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.scale + self.bias).to(x.dtype)


class Embeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        h = cfg.hidden_size
        self.word = nn.Parameter(torch.zeros(cfg.vocab_size, h))
        self.position = nn.Parameter(torch.zeros(cfg.max_position_embeddings, h))
        self.token_type = nn.Parameter(torch.zeros(cfg.type_vocab_size, h))
        self.ln = LayerNorm(h, cfg.layer_norm_eps)

    def forward(self, input_ids, token_type_ids, dtype: torch.dtype) -> torch.Tensor:
        t = input_ids.shape[1]
        x = self.word[input_ids] + self.position[None, :t] + self.token_type[token_type_ids]
        return self.ln(x.to(dtype))  # summed in f32, rounded before the LayerNorm


class BertLayer(nn.Module):
    """Post-LN transformer layer: attention, then MLP, each with a residual."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        h, i = cfg.hidden_size, cfg.intermediate_size
        self.cfg = cfg
        self.q, self.k, self.v, self.attn_out = (Dense(h, h) for _ in range(4))
        self.attn_ln = LayerNorm(h, cfg.layer_norm_eps)
        self.mlp_in = Dense(h, i)
        self.mlp_out = Dense(i, h)
        self.mlp_ln = LayerNorm(h, cfg.layer_norm_eps)

    def attention(self, x, mask_bias, key_mask, seed) -> torch.Tensor:
        """Self-attention; `seed` is None in eval (no dropout)."""
        cfg = self.cfg
        b, t, h = x.shape
        nh, hd = cfg.num_heads, cfg.head_dim

        def heads(y):  # [B, T, H] -> [B, nh, T, hd]
            return y.view(b, t, nh, hd).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        # same rule as bert.py:190: the fused kernel takes block-divisible lengths
        if cfg.flash_attention and t % 128 == 0 and t <= 1024:
            ctx = fused_attention(q.contiguous(), k.contiguous(), v.contiguous(), key_mask,
                                  sm_scale=1.0 / math.sqrt(hd),
                                  dropout_rate=0.0 if seed is None else cfg.attention_dropout,
                                  seed=seed or 0)
        else:
            scores = dot_f32(q, k.transpose(-1, -2)) / math.sqrt(hd) + mask_bias
            probs = _drop(torch.softmax(scores, dim=-1), cfg.attention_dropout, seed)
            ctx = dot_f32(probs.to(x.dtype), v).to(x.dtype)
        return self.attn_out(ctx.transpose(1, 2).reshape(b, t, h))

    def mlp(self, x, seed) -> torch.Tensor:
        mlp = self.mlp_in(x)
        mlp = nn.functional.gelu(mlp.float(), approximate="none").to(x.dtype)
        mlp = _drop(self.mlp_out(mlp), self.cfg.hidden_dropout, seed)
        return self.mlp_ln(x + mlp)

    def forward(self, x, mask_bias, key_mask, seeds=None) -> torch.Tensor:
        """seeds: (attention probabilities, attention output, MLP output), or
        None in eval."""
        s_probs, s_attn, s_mlp = seeds if seeds is not None else (None, None, None)
        attn = self.attention(x, mask_bias, key_mask, s_probs)
        attn = _drop(attn, self.cfg.hidden_dropout, s_attn)
        x = self.attn_ln(x + attn)
        if self.cfg.remat and self.cfg.remat_scope == "mlp" and torch.is_grad_enabled():
            return checkpoint(self.mlp, x, s_mlp, use_reentrant=False)
        return self.mlp(x, s_mlp)


def _drop(x: torch.Tensor, rate: float, seed: int | None) -> torch.Tensor:
    """Dropout under `seed`, or the identity when seed is None (eval)."""
    return x if seed is None else dropout(x, rate, seed)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg)
        self.layers = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_layers))
        self.pooler = Dense(cfg.hidden_size, cfg.hidden_size)

    def dropout_seeds(self, generator: torch.Generator | None) -> list | None:
        """One seed per dropout site and layer (embedding output, then
        (probabilities, attention output, MLP output) per layer), drawn from
        `generator` in training mode; None in eval or at dropout rate 0."""
        cfg = self.cfg
        if not self.training or (cfg.hidden_dropout == 0 and cfg.attention_dropout == 0):
            return None
        if generator is None:
            # a fixed default would replay identical masks every step
            raise ValueError("training-mode BertEncoder with dropout needs a torch.Generator "
                             "(call .eval() for inference)")
        return torch.randint(0, SEED_RANGE, (1 + 3 * cfg.num_layers,),
                             generator=generator).tolist()

    def forward(self, input_ids, attention_mask, token_type_ids=None, *,
                generator: torch.Generator | None = None):
        """Returns (sequence_output [B, T, H], pooled_output [B, H]) in
        cfg.dtype; pooled = tanh(W h_CLS + b), the embedding both retriever
        towers consume. In training mode dropout draws its seeds from
        `generator`."""
        cfg = self.cfg
        seeds = self.dropout_seeds(generator)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.embeddings(input_ids, token_type_ids, cfg.dtype)
        x = _drop(x, cfg.hidden_dropout, None if seeds is None else seeds[0])
        mask_bias = torch.where(attention_mask[:, None, None, :] != 0, 0.0, MASK_BIAS)
        mask_bias = mask_bias.to(torch.float32)
        key_mask = attention_mask.to(torch.int32).contiguous()
        remat_layer = cfg.remat and cfg.remat_scope == "layer" and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            layer_seeds = None if seeds is None else tuple(seeds[1 + 3 * i: 4 + 3 * i])
            if remat_layer:
                x = checkpoint(layer, x, mask_bias, key_mask, layer_seeds, use_reentrant=False)
            else:
                x = layer(x, mask_bias, key_mask, layer_seeds)
        pooled = torch.tanh(self.pooler(x[:, 0]).float()).to(cfg.dtype)
        return x, pooled


def init_parameters(module: nn.Module, std: float, generator: torch.Generator) -> None:
    """The JAX package's initialisation: normal(0, std) for dense kernels and
    embedding tables, zeros for biases, ones/zeros for LayerNorm."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Dense):
                m.kernel.normal_(0.0, std, generator=generator)
                m.bias.zero_()
            elif isinstance(m, Embeddings):
                for p in (m.word, m.position, m.token_type):
                    p.normal_(0.0, std, generator=generator)
            elif isinstance(m, LayerNorm):
                m.scale.fill_(1.0)
                m.bias.zero_()
