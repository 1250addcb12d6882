"""Checkpoints with true resume.

Counterpart of proqa_tpu/train/checkpoint.py: the whole TrainState (step,
parameters, Adam's moments) round-trips through one file, written
atomically (a temporary file in the same directory, then os.replace), with
the reference's checkpoint_{step} / checkpoint_best / checkpoint_last names.
The file is a `torch.save` of plain tensors ({"step", "params", "opt_state"})
with a `.pt` suffix, in place of the JAX package's flax msgpack: the GPU
machine has no flax. `models/convert.load_params` unwraps such a file to its
parameters.
"""
from __future__ import annotations

import os
import tempfile

import torch

from proqa_tpu_torch.train.optim import TrainState

SUFFIX = ".pt"


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def save_checkpoint(path: str, state: TrainState) -> None:
    """Atomic write of a TrainState."""
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    tree = {"step": state.step, "params": _host(state.params),
            "opt_state": _host(state.opt_state)}
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(tree, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path: str) -> TrainState:
    """The TrainState saved at `path`, its tensors on the CPU."""
    tree = torch.load(path, map_location="cpu", weights_only=True)
    return TrainState(step=int(tree["step"]), params=tree["params"],
                      opt_state=tree["opt_state"])


def latest_checkpoint(ckpt_dir: str, prefix: str = "checkpoint_") -> str | None:
    """Highest-step `<prefix><step>.pt` in the directory, if any."""
    if not os.path.isdir(ckpt_dir):
        return None
    best_step, best_path = -1, None
    for fname in os.listdir(ckpt_dir):
        if not fname.startswith(prefix) or not fname.endswith(SUFFIX):
            continue
        stem = fname[len(prefix):-len(SUFFIX)]
        if stem.isdigit() and int(stem) > best_step:
            best_step, best_path = int(stem), os.path.join(ckpt_dir, fname)
    return best_path
