"""Random weights of the two-tower retriever, made on the device from the
seed in one draw, keyed as the retriever's state dict (the JAX layout:
dense kernels [in, out]). The program loads them; the reference draws
them again after the program's state is freed.

Every parameter is random, biases and LayerNorm included, so that the
comparison sees every term: kernels and embedding tables N(0, 0.02^2)
(BERT's initializer range), biases N(0, 0.02^2), LayerNorm scales
1 + N(0, 0.1^2) and offsets N(0, 0.02^2).
"""
from __future__ import annotations

import torch

from benchmark.traffic import device_generator


def bert_shapes(cfg: dict, prefix: str) -> list[tuple[str, tuple]]:
    """(name, shape) of one BERT tower's parameters, in a fixed order."""
    h, i = cfg["hidden_size"], cfg["intermediate_size"]
    out = [(f"{prefix}embeddings.word", (cfg["vocab_size"], h)),
           (f"{prefix}embeddings.position", (cfg["max_position_embeddings"], h)),
           (f"{prefix}embeddings.token_type", (cfg["type_vocab_size"], h)),
           (f"{prefix}embeddings.ln.scale", (h,)), (f"{prefix}embeddings.ln.bias", (h,))]
    for layer in range(cfg["num_hidden_layers"]):
        p = f"{prefix}layers.{layer}."
        for dense in ("q", "k", "v", "attn_out"):
            out += [(f"{p}{dense}.kernel", (h, h)), (f"{p}{dense}.bias", (h,))]
        out += [(f"{p}attn_ln.scale", (h,)), (f"{p}attn_ln.bias", (h,)),
                (f"{p}mlp_in.kernel", (h, i)), (f"{p}mlp_in.bias", (i,)),
                (f"{p}mlp_out.kernel", (i, h)), (f"{p}mlp_out.bias", (h,)),
                (f"{p}mlp_ln.scale", (h,)), (f"{p}mlp_ln.bias", (h,))]
    return out + [(f"{prefix}pooler.kernel", (h, h)), (f"{prefix}pooler.bias", (h,))]


def retriever_shapes(cfg: dict) -> list[tuple[str, tuple]]:
    h, e = cfg["hidden_size"], cfg["projection_dim"]
    return (bert_shapes(cfg, "bert_q.") + bert_shapes(cfg, "bert_c.")
            + [("proj_q.kernel", (h, e)), ("proj_q.bias", (e,)),
               ("proj_c.kernel", (h, e)), ("proj_c.bias", (e,))])


def retriever_weights(seed: int, cfg: dict, device) -> dict[str, torch.Tensor]:
    """f32 weights of both towers and projections, drawn in one call."""
    shapes = retriever_shapes(cfg)
    total = sum(torch.Size(s).numel() for _, s in shapes)
    flat = torch.randn(total, generator=device_generator(seed, 4, device=device),
                       device=device)
    out, at = {}, 0
    std = cfg["initializer_range"]
    for name, shape in shapes:
        n = torch.Size(shape).numel()
        x = flat[at:at + n].view(shape)
        at += n
        if name.endswith("ln.scale"):
            out[name] = 1.0 + 0.1 * x
        else:
            out[name] = std * x
    return out
