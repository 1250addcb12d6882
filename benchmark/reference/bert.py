"""Plain BERT tower with its projection, the encode cell's reference.

The configuration states bf16 activations, and the program documents where
it rounds (proqa_tpu_torch/models/bert.py): each dense layer multiplies
bf16 operands with f32 sums, adds the f32 bias and rounds; GELU is exact,
in f32, on the rounded value, rounded again; a residual sum is rounded
before its LayerNorm, which runs in f32 (eps from the configuration) and is
rounded; softmax runs in f32 and its probabilities are rounded before they
multiply the values; the pooler's tanh runs in f32 and is rounded; the
projection returns f32. This file does the same arithmetic in f32 (TF32
off) with `rnd` at those points, one row at a time at its own length, so
no padding and no mask enter. `rnd` is bf16 rounding for the reference and,
for the control, fp8 (e4m3) rounding with one scale a tensor: the
precision one step below the configuration's.
"""
from __future__ import annotations

import math

import torch


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """e4m3 rounding with one scale for the tensor (its largest magnitude
    maps to 448, e4m3's largest finite value)."""
    amax = x.abs().max()
    if amax == 0:
        return x
    s = 448.0 / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


def _dense(x, w: dict, name: str, rnd, out_round=True):
    y = x @ rnd(w[f"{name}.kernel"]) + w[f"{name}.bias"]
    return rnd(y) if out_round else y


def _layer_norm(x, w: dict, name: str, eps: float, rnd):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return rnd((x - mean) * torch.rsqrt(var + eps) * w[f"{name}.scale"] + w[f"{name}.bias"])


def tower(ids: torch.Tensor, w: dict, cfg: dict, *, prefix: str, proj: str, rnd=bf16):
    """[B, T] token ids, every position real (no padding) -> [B, E] f32
    embeddings: the tower `prefix` ("bert_c.") and the projection `proj`
    ("proj_c"), with the weights w keyed as benchmark/weights.py keys them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    w = {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in w.items()}
    b, t = ids.shape
    h, nh, eps = cfg["hidden_size"], cfg["num_attention_heads"], cfg["layer_norm_eps"]
    hd = h // nh
    x = w["embeddings.word"][ids] + w["embeddings.position"][:t] + w["embeddings.token_type"][0]
    x = _layer_norm(rnd(x), w, "embeddings.ln", eps, rnd)
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."

        def heads(y):
            return y.view(b, t, nh, hd).transpose(1, 2)

        q, k, v = (heads(_dense(x, w, p + n, rnd)) for n in ("q", "k", "v"))
        probs = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
        ctx = rnd(rnd(probs) @ v).transpose(1, 2).reshape(b, t, h)
        attn = _dense(ctx, w, p + "attn_out", rnd)
        x = _layer_norm(rnd(x + attn), w, p + "attn_ln", eps, rnd)
        mlp = rnd(torch.nn.functional.gelu(_dense(x, w, p + "mlp_in", rnd)))
        mlp = _dense(mlp, w, p + "mlp_out", rnd)
        x = _layer_norm(rnd(x + mlp), w, p + "mlp_ln", eps, rnd)
    pooled = rnd(torch.tanh(_dense(x[:, 0], w, "pooler", rnd)))
    return _dense(pooled, w, proj, rnd, out_round=False)


def embed_rows(rows: list[list[int]], w: dict, cfg: dict, device, *, rnd=bf16,
               prefix: str = "bert_c.", proj: str = "proj_c") -> list[torch.Tensor]:
    """Each token row's [E] f32 embedding, rows of one length batched
    together."""
    out: list = [None] * len(rows)
    by_len: dict = {}
    for i, r in enumerate(rows):
        by_len.setdefault(len(r), []).append(i)
    with torch.no_grad():
        for idx in by_len.values():
            ids = torch.tensor([rows[i] for i in idx], device=device)
            emb = tower(ids, w, cfg, prefix=prefix, proj=proj, rnd=rnd)
            for j, i in enumerate(idx):
                out[i] = emb[j]
    return out


def spread(want: list[torch.Tensor]) -> float:
    """The root mean square distance of the embeddings from their mean: the
    scale at which a search tells rows apart (every row shares a large
    common part that no ranking sees)."""
    x = torch.stack(want)
    return float((x - x.mean(0)).square().sum(1).mean().sqrt())


def worst_gap(got: list[torch.Tensor], want: list[torch.Tensor]) -> float:
    """The largest ||got - want|| of a row, over the spread of `want`."""
    return max(float((g - w).norm()) for g, w in zip(got, want)) / spread(want)
