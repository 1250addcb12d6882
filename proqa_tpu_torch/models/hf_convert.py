"""HuggingFace / reference torch BERT checkpoints into the port's parameters.

Counterpart of proqa_tpu/models/hf_convert.py. The reference's recipes start
from `bert-base-uncased`, and its released retriever checkpoints are torch
state dicts of `BertForRetriever` (`bert_q.*`, `bert_c.*`, `proj_q`,
`proj_c`), possibly saved under DistributedDataParallel with a `module.`
prefix. The key map builds the JAX package's layer-stacked tree (torch
Linear weights [out, in] transposed to [in, out] kernels), and
models/convert.py:params_from_jax turns that tree into the port's state dict,
so one mapping serves both packages. HF Mistral state dicts (E5-Mistral's
tower) map straight onto models/mistral.py's state dict, which the JAX
package has no counterpart of. Imports neither `transformers` nor the JAX
package.
"""
from __future__ import annotations

import warnings
from typing import Mapping

import numpy as np
import torch

from proqa_tpu_torch.models.bert import BertConfig
from proqa_tpu_torch.models.convert import params_from_jax
from proqa_tpu_torch.models.mistral import MistralConfig


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def strip_ddp_prefix(state: Mapping[str, object]) -> dict:
    """Drop DistributedDataParallel's `module.` key prefix."""
    return {(k[7:] if k.startswith("module.") else k): v for k, v in state.items()}


def bert_tree_from_state_dict(state: Mapping[str, object], cfg: BertConfig,
                              prefix: str = "") -> dict:
    """HF `BertModel` state dict -> the JAX layout's BERT tree (per-layer
    leaves stacked on a leading [num_layers] axis, kernels [in, out])."""

    def g(name: str) -> np.ndarray:
        return _np(state[prefix + name])

    def stack(fmt: str, transpose: bool = False) -> np.ndarray:
        mats = [g(fmt.format(i)) for i in range(cfg.num_layers)]
        return np.stack([m.T for m in mats] if transpose else mats)

    def dense(base: str) -> dict:
        return {"kernel": stack(base + ".weight", transpose=True), "bias": stack(base + ".bias")}

    def norm(base: str) -> dict:
        return {"scale": stack(base + ".weight"), "bias": stack(base + ".bias")}

    layer = "encoder.layer.{0}."
    return {
        "embeddings": {
            "word": g("embeddings.word_embeddings.weight"),
            "position": g("embeddings.position_embeddings.weight"),
            "token_type": g("embeddings.token_type_embeddings.weight"),
            "ln": {"scale": g("embeddings.LayerNorm.weight"),
                   "bias": g("embeddings.LayerNorm.bias")},
        },
        "layers": {
            "q": dense(layer + "attention.self.query"),
            "k": dense(layer + "attention.self.key"),
            "v": dense(layer + "attention.self.value"),
            "attn_out": dense(layer + "attention.output.dense"),
            "attn_ln": norm(layer + "attention.output.LayerNorm"),
            "mlp_in": dense(layer + "intermediate.dense"),
            "mlp_out": dense(layer + "output.dense"),
            "mlp_ln": norm(layer + "output.LayerNorm"),
        },
        "pooler": {"kernel": g("pooler.dense.weight").T, "bias": g("pooler.dense.bias")},
    }


def retriever_tree_from_state_dict(state: Mapping[str, object], cfg: BertConfig) -> dict:
    """Reference `BertForRetriever` state dict (a `module.` prefix allowed)
    -> the JAX layout's retriever tree."""
    state = strip_ddp_prefix(state)
    return {
        "bert_q": bert_tree_from_state_dict(state, cfg, prefix="bert_q."),
        "bert_c": bert_tree_from_state_dict(state, cfg, prefix="bert_c."),
        "proj_q": {"kernel": _np(state["proj_q.weight"]).T, "bias": _np(state["proj_q.bias"])},
        "proj_c": {"kernel": _np(state["proj_c.weight"]).T, "bias": _np(state["proj_c.bias"])},
    }


def bert_params_from_state_dict(state: Mapping[str, object], cfg: BertConfig,
                                prefix: str = "") -> dict[str, torch.Tensor]:
    """HF `BertModel` state dict -> a state dict of the port's BertEncoder."""
    return params_from_jax(bert_tree_from_state_dict(state, cfg, prefix))


def retriever_params_from_state_dict(state: Mapping[str, object],
                                     cfg: BertConfig) -> dict[str, torch.Tensor]:
    """Reference `BertForRetriever` state dict -> a state dict of the port's
    Retriever."""
    return params_from_jax(retriever_tree_from_state_dict(state, cfg))


def mistral_params_from_state_dict(state: Mapping[str, object],
                                   cfg: MistralConfig) -> dict[str, torch.Tensor]:
    """An HF Mistral state dict (`MistralModel`'s keys, as E5-Mistral's
    checkpoint holds them, or `MistralForCausalLM`'s under `model.`; a
    `module.` prefix allowed; the LM head, if any, is dropped) -> a state
    dict of the port's MistralRetriever, in cfg.dtype: torch Linear weights
    [out, in] transposed to [in, out] kernels, q_proj, k_proj and v_proj
    side by side in `qkv`, gate_proj and up_proj in `gate_up`."""
    state = strip_ddp_prefix(state)
    base = "model." if "model.embed_tokens.weight" in state else ""

    def g(name: str) -> torch.Tensor:
        x = state[base + name]
        return torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x.detach()

    def kernels(*names: str) -> torch.Tensor:
        return torch.cat([g(n).t() for n in names], dim=1)

    out = {"tower.embed": g("embed_tokens.weight"), "tower.norm.scale": g("norm.weight")}
    for i in range(cfg.num_layers):
        hf, port = f"layers.{i}.", f"tower.layers.{i}."
        out[port + "attn_norm.scale"] = g(hf + "input_layernorm.weight")
        out[port + "qkv.kernel"] = kernels(*(f"{hf}self_attn.{n}_proj.weight" for n in "qkv"))
        out[port + "o.kernel"] = g(hf + "self_attn.o_proj.weight").t()
        out[port + "mlp_norm.scale"] = g(hf + "post_attention_layernorm.weight")
        out[port + "gate_up.kernel"] = kernels(hf + "mlp.gate_proj.weight",
                                               hf + "mlp.up_proj.weight")
        out[port + "down.kernel"] = g(hf + "mlp.down_proj.weight").t()
    return {k: v.to(cfg.dtype).contiguous() for k, v in out.items()}


def load_torch_checkpoint(path: str, *, allow_pickle: bool = False) -> dict:
    """A torch `.pt` state dict, loaded on the CPU with `weights_only=True`,
    which runs no pickled code; plain state dicts (the released checkpoints)
    need none. Full unpickling only on an explicit opt-in (the CLI's
    --allow-pickle), for trusted legacy files that fail the safe load."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        if not allow_pickle:
            raise
        warnings.warn(f"{path}: weights-only load failed; falling back to full unpickling "
                      "(--allow-pickle). Only do this for trusted files.", stacklevel=2)
        return torch.load(path, map_location="cpu", weights_only=False)
