"""Random weights of a Mistral-style decoder tower, made on the device from
the seed, keyed as the program's state dict (proqa_tpu_torch/models/mistral.py:
MistralRetriever; kernels [in, out], q, k and v as one `qkv` kernel, gate
and up as one `gate_up`). The program loads them without a copy; the
reference draws them again after the program's state is freed.

Every entry is random, in the configuration's weight dtype (bf16): kernels
and embedding rows N(0, 0.02^2) (the initializer range), RMSNorm scales
1 + N(0, 0.1^2). One generator fills one flat buffer in slices of 2^28, in a
fixed order, so the same seed on the same card gives the same bits.
"""
from __future__ import annotations

import torch

from benchmark.traffic import device_generator

SLICE = 1 << 28  # elements drawn per call


def decoder_shapes(cfg: dict, prefix: str = "tower.") -> list[tuple[str, tuple]]:
    """(name, shape) of the tower's parameters, in a fixed order."""
    h, inter = cfg["hidden_size"], cfg["intermediate_size"]
    nq, nkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    out = [(f"{prefix}embed", (cfg["vocab_size"], h))]
    for layer in range(cfg["num_hidden_layers"]):
        p = f"{prefix}layers.{layer}."
        out += [(f"{p}attn_norm.scale", (h,)), (f"{p}qkv.kernel", (h, (nq + 2 * nkv) * hd)),
                (f"{p}o.kernel", (nq * hd, h)), (f"{p}mlp_norm.scale", (h,)),
                (f"{p}gate_up.kernel", (h, 2 * inter)), (f"{p}down.kernel", (inter, h))]
    return out + [(f"{prefix}norm.scale", (h,))]


def decoder_weights(seed: int, cfg: dict, device) -> dict[str, torch.Tensor]:
    """The tower's weights, views of one flat buffer in the weight dtype."""
    shapes = decoder_shapes(cfg)
    total = sum(torch.Size(s).numel() for _, s in shapes)
    flat = torch.empty(total, dtype=getattr(torch, cfg["torch_dtype"]), device=device)
    g = device_generator(seed, 11, device=device)
    for lo in range(0, total, SLICE):
        flat[lo:lo + SLICE].normal_(generator=g)
    out, at = {}, 0
    for name, shape in shapes:
        n = torch.Size(shape).numel()
        x = flat[at:at + n].view(shape)
        at += n
        if name.endswith("scale"):
            out[name] = x.mul_(0.1).add_(1.0)
        else:
            out[name] = x.mul_(cfg["initializer_range"])
    return out
