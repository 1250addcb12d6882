"""Plain E5-Mistral decoder tower, the E5 search cell's reference.

The published model (intfloat/e5-mistral-7b-instruct; Wang et al. 2024,
arXiv:2401.00368) is Mistral-7B-v0.1's decoder with no LM head: token
embeddings; per layer an RMSNorm, q, k and v projections (32 query heads,
8 kv heads of 128, query head j reading kv head j // 4), rotary positions
(rotate-half, theta from the configuration), causal attention over the
keys fewer than `sliding_window` positions back, the o projection and the
residual add; an RMSNorm, a SwiGLU MLP (down(silu(gate(x)) * up(x))) and
the residual add; a final RMSNorm. The embedding is the final hidden state
of the row's last token (EOS), L2-normalised.

The configuration states bf16, and the program documents where it rounds
(proqa_tpu_torch/models/mistral.py): the embedding row; each residual sum;
each RMSNorm's output (s * rsqrt(mean(s^2) + eps) * scale in f32); each
projection's output (bf16 operands, f32 sums); q and k after RoPE (f32
cos and sin); the softmax's probabilities (scores and softmax in f32); the
attention's output; the SwiGLU output (silu(gate) * up in f32); then the
L2 normalisation in f32. This file does the same arithmetic in f32 (TF32
off) with `rnd` at those points, each row at its own length: the
projections, norms and MLP take every row's tokens side by side (they act
on each token alone), and attention runs one row at a time over that row's
keys, so no padding, padding mask or cache enters. `rnd` is bf16 rounding
for the reference and, for the control, e4m3 rounding with one scale a
tensor (reference/bert.py:fp8), the precision one step below the
configuration's; the control also rounds the weights so.

Departures from the published model, each where the program departs too:
- HF rounds s * rstd to bf16 before the scale, and silu(gate) before the
  product with up; here each is one rounding;
- HF rounds cos and sin, and each product of RoPE, to bf16; here f32;
- HF's attention runs in the model's dtype (SDPA); here f32 scores and
  softmax with the probabilities rounded;
- the weights are random (benchmark/decoder_weights.py), not the released
  checkpoint, and the ids come from the traffic generator, not the
  SentencePiece tokenizer.
"""
from __future__ import annotations

import math

import torch

# the roundings and the comparison of reference/bert.py, shared by the cell
from benchmark.reference.bert import bf16, fp8, worst_gap  # noqa: F401


def _rms(s: torch.Tensor, scale: torch.Tensor, eps: float, rnd) -> torch.Tensor:
    return rnd(s * torch.rsqrt(s.square().mean(-1, keepdim=True) + eps) * scale)


def _rope_tables(positions: torch.Tensor, hd: int, theta: float):
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, device=positions.device).float() / hd))
    freqs = positions.float()[:, None] * inv[None]
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos(), emb.sin()


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [N, heads, hd]; cos, sin [N, hd] of each token's position."""
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos[:, None] + torch.cat((-x2, x1), dim=-1) * sin[:, None]


def _attention(q, k, v, window, rnd):
    """One row: q [n, nq, hd], k and v [n, nkv, hd] -> [n, nq hd]; query
    position i sees keys j <= i with i - j < window."""
    n, nq, hd = q.shape
    rep = nq // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)                  # [nq, n, hd]
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    scores = q.transpose(0, 1) @ k.transpose(1, 2) / math.sqrt(hd)       # [nq, n, n]
    i = torch.arange(n, device=q.device)
    hidden = i[None, :] > i[:, None]
    if window is not None:
        hidden = hidden | (i[:, None] - i[None, :] >= window)
    probs = torch.softmax(scores.masked_fill(hidden, -math.inf), dim=-1)
    return rnd(rnd(probs) @ v).transpose(0, 1).reshape(n, nq * hd)


@torch.no_grad()
def embed_rows(rows: list[list[int]], w: dict, cfg: dict, device, *, rnd=bf16,
               prefix: str = "tower.") -> list[torch.Tensor]:
    """Each token row's [H] f32 unit-norm embedding, every position real,
    with the weights w keyed as the program's state dict
    (benchmark/decoder_weights.py)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    h, nq, nkv = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, inter = cfg["head_dim"], cfg["intermediate_size"]
    eps, window = cfg["rms_norm_eps"], cfg.get("sliding_window")
    lengths = [len(r) for r in rows]
    starts = [sum(lengths[:i]) for i in range(len(rows))]
    ids = torch.tensor([t for r in rows for t in r], device=device)
    cos, sin = _rope_tables(torch.cat([torch.arange(n, device=device) for n in lengths]), hd,
                            cfg["rope_theta"])

    def weight(name: str) -> torch.Tensor:
        return rnd(w[prefix + name].float())

    res = rnd(w[prefix + "embed"][ids].float())   # the residual stream [N, H]
    delta = None                                  # the last block's output
    for layer in range(cfg["num_hidden_layers"]):
        p = f"layers.{layer}."
        if delta is not None:
            res = rnd(res + delta)
        x = _rms(res, weight(p + "attn_norm.scale"), eps, rnd)
        wq, wk, wv = weight(p + "qkv.kernel").split([nq * hd, nkv * hd, nkv * hd], dim=1)
        q = rnd(_rope(rnd(x @ wq).view(-1, nq, hd), cos, sin))
        k = rnd(_rope(rnd(x @ wk).view(-1, nkv, hd), cos, sin))
        v = rnd(x @ wv).view(-1, nkv, hd)
        ctx = torch.cat([_attention(q[s:s + n], k[s:s + n], v[s:s + n], window, rnd)
                         for s, n in zip(starts, lengths)])
        res = rnd(res + rnd(ctx @ weight(p + "o.kernel")))
        x = _rms(res, weight(p + "mlp_norm.scale"), eps, rnd)
        wg, wu = weight(p + "gate_up.kernel").split([inter, inter], dim=1)
        act = rnd(torch.nn.functional.silu(rnd(x @ wg)) * rnd(x @ wu))
        delta = rnd(act @ weight(p + "down.kernel"))
    last = torch.tensor([s + n - 1 for s, n in zip(starts, lengths)], device=device)
    final = res[last] if delta is None else rnd(res[last] + delta[last])
    out = torch.nn.functional.normalize(_rms(final, weight("norm.scale"), eps, rnd), dim=-1)
    return list(out)
