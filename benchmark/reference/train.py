"""Plain retriever pretraining steps, the pretrain cell's reference.

What the configuration states, written out in plain torch: two BERT towers
in training mode (dropout 0.1 at the embedding output, the attention
probabilities, the attention output and the MLP output), the [CLS]
projections, the in-batch contrastive loss over f32 q c^T, gradients
summed over the microbatches and divided by their number, the global-norm
clip, and AdamW (optax's scale_by_adam with bias correction, no decay).

Precision, as the configuration states it (bf16 activations, f32 weights
and optimizer): the forward rounds where the encode reference does
(reference/bert.py); every matrix product multiplies bf16 values with f32
sums, and its backward rounds the cotangent to bf16 before each product
and the product's result after (the rule the JAX package's DEFAULT
precision gives, which the port follows); the rest of the backward is f32.
`rnd` sets the rounding: bf16 for the reference, fp8 (e4m3) for the
control. Each layer is recomputed in the backward (torch.utils.checkpoint)
to bound memory; its dropout masks are drawn again from their seeds
(reference/dropout_bits.py), as the program's are. The dropout seeds come
from the trainer's generator in the program's order: for each microbatch
the question tower's 1 + 3 L seeds, then the paragraph tower's.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from benchmark.reference import dropout_bits as bits
from benchmark.reference.bert import bf16

SEED_RANGE = 1 << 62
MASK_BIAS = -1e30


def _st(rnd):
    """rnd with an identity gradient (rounding passes the cotangent on)."""
    return lambda x: x + (rnd(x) - x).detach()


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of tensors holding bf16 (or coarser) values, with f32 sums:
    [..., K] @ [K, N], or batched [B, M, K] @ [B, K, N]."""
    if a.is_cuda:
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        if b.dim() == 2:
            out = torch.mm(a16.reshape(-1, a.shape[-1]), b16, out_dtype=torch.float32)
            return out.view(*a.shape[:-1], b.shape[-1])
        return torch.bmm(a16, b16, out_dtype=torch.float32)
    return a @ b


class _Dot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, rnd):
        ctx.save_for_backward(a, b)
        ctx.rnd = rnd
        return _mm(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        rnd = ctx.rnd
        g = rnd(g)
        if b.dim() == 2:
            ga = _mm(g, b.T)
            gb = _mm(a.reshape(-1, a.shape[-1]).T.contiguous(), g.reshape(-1, g.shape[-1]))
        else:
            ga = _mm(g, b.transpose(1, 2).contiguous())
            gb = _mm(a.transpose(1, 2).contiguous(), g)
        return rnd(ga), rnd(gb), None


def dot(a, b, rnd):
    """a @ b, batched over a leading [B, H] pair of dims when b has four."""
    if b.dim() == 4:
        lead = a.shape[:2]
        out = _Dot.apply(a.reshape(-1, *a.shape[2:]), b.reshape(-1, *b.shape[2:]), rnd)
        return out.view(*lead, *out.shape[1:])
    return _Dot.apply(a, b, rnd)


class Tower:
    """One BERT tower and its projection, in training mode."""

    def __init__(self, w: dict, cfg: dict, prefix: str, proj: str, rnd):
        self.w = {k[len(prefix):]: v for k, v in w.items() if k.startswith(prefix)}
        self.w.update({k: v for k, v in w.items() if k.startswith(proj)})
        self.cfg, self.proj, self.rnd, self.r = cfg, proj, rnd, _st(rnd)
        self.rate_h, self.rate_a = cfg["hidden_dropout_prob"], cfg["attention_probs_dropout_prob"]

    def dense(self, x, name, out_round=True):
        y = dot(x, self.r(self.w[f"{name}.kernel"]), self.rnd) + self.w[f"{name}.bias"]
        return self.r(y) if out_round else y

    def ln(self, x, name):
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.cfg["layer_norm_eps"])
        return self.r(y * self.w[f"{name}.scale"] + self.w[f"{name}.bias"])

    def drop(self, x, seed, stream=bits.ACTIVATIONS, rate=None):
        rate = self.rate_h if rate is None else rate
        keep = bits.keep(seed, stream, rate, x.shape, x.device)
        return torch.where(keep, x * (1.0 / (1.0 - rate)), 0.0)

    def layer(self, x, bias, i: int, seeds):
        s_probs, s_attn, s_mlp = seeds
        b, t, h = x.shape
        nh = self.cfg["num_attention_heads"]
        hd = h // nh
        p = f"layers.{i}."

        def heads(y):
            return y.view(b, t, nh, hd).transpose(1, 2)

        q, k, v = (heads(self.dense(x, p + n)) for n in ("q", "k", "v"))
        s = dot(q, k.transpose(-1, -2).contiguous(), self.rnd) * (1.0 / math.sqrt(hd))
        probs = torch.softmax(s + bias, dim=-1)
        probs = self.drop(probs, s_probs, bits.PROBABILITIES, self.rate_a)
        ctx = self.r(dot(self.r(probs), v.contiguous(), self.rnd))
        attn = self.dense(ctx.transpose(1, 2).reshape(b, t, h), p + "attn_out")
        attn = self.r(self.drop(attn, s_attn))
        x = self.ln(self.r(x + attn), p + "attn_ln")
        mlp = self.r(torch.nn.functional.gelu(self.dense(x, p + "mlp_in")))
        mlp = self.r(self.drop(self.dense(mlp, p + "mlp_out"), s_mlp))
        return self.ln(self.r(x + mlp), p + "mlp_ln")

    def __call__(self, ids, mask, seeds):
        w, t = self.w, ids.shape[1]
        x = w["embeddings.word"][ids] + w["embeddings.position"][:t] + w["embeddings.token_type"][0]
        x = self.ln(self.r(x), "embeddings.ln")
        x = self.r(self.drop(x, seeds[0]))
        bias = torch.where(mask[:, None, None, :] != 0, 0.0, MASK_BIAS).to(torch.float32)
        for i in range(self.cfg["num_hidden_layers"]):
            x = checkpoint(self.layer, x, bias, i, seeds[1 + 3 * i:4 + 3 * i],
                           use_reentrant=False)
        pooled = self.r(torch.tanh(self.dense(x[:, 0], "pooler")))
        return self.dense(pooled, self.proj, out_round=False)


def in_batch_loss(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return -torch.diagonal(torch.log_softmax(q @ c.T, dim=-1)).mean()


def train(w0: dict, cfg: dict, opt: dict, batches: list, seed: int, device, *, rnd=bf16,
          keep_rows: float = 1.0) -> dict:
    """len(batches) optimizer steps from the weights w0 (f32, left as they
    are). batches: dicts of host arrays input_ids_q/input_mask_q/
    input_ids_c/input_mask_c, each opt["accumulate"] microbatches long; seed:
    the dropout generator's. keep_rows < 1 plants a fault: each microbatch
    loses its last rows and the mean is taken over the rest.

    Returns {"losses": [per step], "grad_norms": {leaf: norm of step 1's
    clipped gradient}, "update_norms": {leaf: norm of the change after the
    last step}}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    params = {k: v.detach().clone().requires_grad_(True) for k, v in w0.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    gen = torch.Generator().manual_seed(seed)
    layers = cfg["num_hidden_layers"]
    towers = (Tower(params, cfg, "bert_q.", "proj_q", rnd),
              Tower(params, cfg, "bert_c.", "proj_c", rnd))
    out = {"losses": []}
    accum, b1, b2 = opt["accumulate"], opt["b1"], opt["b2"]
    for step, batch in enumerate(batches, start=1):
        for p in params.values():
            p.grad = None
        rows = batch["input_ids_q"].shape[0]
        micro = rows // accum
        total = 0.0
        for m in range(accum):
            part = {k: torch.from_numpy(v[m * micro:(m + 1) * micro]).to(device)
                    for k, v in batch.items()}
            seeds = [torch.randint(0, SEED_RANGE, (1 + 3 * layers,), generator=gen).tolist()
                     for _ in towers]
            keep = max(1, int(micro * keep_rows))
            q = towers[0](part["input_ids_q"], part["input_mask_q"], seeds[0])[:keep]
            c = towers[1](part["input_ids_c"], part["input_mask_c"], seeds[1])[:keep]
            loss = in_batch_loss(q, c)
            loss.backward()
            total += float(loss.detach())
        out["losses"].append(total / accum)
        with torch.no_grad():
            grads = {k: p.grad / accum if p.grad is not None else torch.zeros_like(p)
                     for k, p in params.items()}
            norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
            scale = 1.0 if norm < opt["max_grad_norm"] else opt["max_grad_norm"] / norm
            if step == 1:
                out["grad_norms"] = {k: float(g.norm() * scale) for k, g in grads.items()}
            c1, c2 = 1 - b1 ** step, 1 - b2 ** step
            for k, p in params.items():
                g = grads[k] * scale
                mu[k].mul_(b1).add_((1 - b1) * g)
                nu[k].mul_(b2).add_((1 - b2) * g.square())
                p.sub_(opt["lr"] * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + opt["eps"]))
    with torch.no_grad():
        out["update_norms"] = {k: float((p - w0[k]).norm()) for k, p in params.items()}
    return out
