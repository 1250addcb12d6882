"""Parameters between the JAX package's layout and the port's modules.

The JAX package keeps parameters as a nested dict with the per-layer leaves
stacked on a leading [num_layers] axis (proqa_tpu/models/bert.py:93-134,
retriever.py:22). The port's modules use the same names and the same [in, out]
kernel orientation, one module per layer, so the mapping is mechanical:

    bert_q/layers/q/kernel [L, H, H]  <->  bert_q.layers.{i}.q.kernel [H, H]
    bert_q/embeddings/ln/scale        <->  bert_q.embeddings.ln.scale

The port reads no flax msgpack (no JAX on the GPU machine): checkpoints reach
it as a `.npz` whose keys are the "/"-joined JAX paths, converted where JAX is
installed, or as a `.pt` file the port saved: a state dict, or a train
checkpoint (train/checkpoint.py), which is unwrapped to its parameters.
"""
from __future__ import annotations

import numpy as np
import torch

_STACKED = "layers"
_TRAIN_STATE = {"step", "params", "opt_state"}


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Nested dict of arrays in the JAX layout -> the port's state_dict (f32).
    A TrainState ({"step", "params", "opt_state"}) is unwrapped to its params,
    as the JAX CLI does (cli/main.py:69). In a .npz an empty optimizer state
    leaves no key, so "opt_state" may be missing."""
    if "params" in tree and set(tree) <= _TRAIN_STATE:
        tree = tree["params"]
    state = {}
    for path, value in _flatten(tree):
        arr = torch.from_numpy(np.asarray(value, np.float32).copy())
        if _STACKED in path:
            at = path.index(_STACKED) + 1
            for i in range(arr.shape[0]):
                state[".".join(path[:at] + (str(i),) + path[at:])] = arr[i].clone()
        else:
            state[".".join(path)] = arr
    return state


def params_to_jax(state: dict[str, torch.Tensor]) -> dict:
    """The port's state_dict -> nested dict of f32 numpy arrays in the JAX
    layout, per-layer leaves stacked again (inverse of params_from_jax)."""
    stacked: dict[tuple, dict[int, np.ndarray]] = {}
    tree: dict = {}

    def put(path, value):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value

    for name, tensor in state.items():
        path = tuple(name.split("."))
        value = tensor.detach().float().cpu().numpy()
        if _STACKED in path:
            at = path.index(_STACKED) + 1
            stacked.setdefault(path[:at] + path[at + 1:], {})[int(path[at])] = value
        else:
            put(path, value)
    for path, layers in stacked.items():
        put(path, np.stack([layers[i] for i in range(len(layers))]))
    return tree


def save_npz(path: str, tree: dict) -> None:
    """Write a JAX-layout tree as a .npz with "/"-joined keys."""
    np.savez(path, **{"/".join(p): np.asarray(v) for p, v in _flatten(tree)})


def load_npz(path: str) -> dict:
    """Read a .npz with "/"-joined keys back into a nested dict."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree


def _load_pt(path: str) -> dict[str, torch.Tensor]:
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "params" in state and set(state) <= _TRAIN_STATE:
        return state["params"]
    return state


def load_params(path: str) -> dict[str, torch.Tensor]:
    """Retriever weights for Retriever.load_state_dict. `path` is a `.npz`
    (JAX layout), or a `.pt` state dict or train checkpoint; a ';'-joined list
    loads the uniform parameter average of the checkpoints (the JAX CLI's
    model soup)."""
    paths = [p for p in path.split(";") if p]
    states = [_load_pt(p) if p.endswith(".pt") else params_from_jax(load_npz(p))
              for p in paths]
    if len(states) == 1:
        return states[0]
    return {k: torch.stack([s[k].float() for s in states]).mean(0) for k in states[0]}
