"""Loop-progress sidecar shared by both trainers.

Copy of proqa_tpu/train/meta.py (pure Python): the port imports nothing of the JAX
package.

`trainer_meta.json` lives next to the checkpoints and records the pieces of
loop state a resumed run needs but the weight checkpoint cannot carry: the
best-metric race (so a resume can't overwrite checkpoint_best with a worse
model), the early-stopping countdown, and the epoch pointer. The pairing
rule both trainers follow: a meta written with `epoch = E` means "resume by
STARTING epoch E" — so epoch-end writes record `epoch + 1` (the completed
run resumes as a no-op), while mid-epoch eval writes record the in-progress
epoch (the resumed run re-trains that epoch from its first batch; batch-level
positions are not tracked, and re-training is safer than skipping unseen
batches).

The reference has no resume at all (save-only checkpoints,
train_retriever.py:233-257, train_retrieve_qa.py:227-260) — these semantics
are ours to define.
"""
from __future__ import annotations

import json
import os

META_NAME = "trainer_meta.json"


def write_trainer_meta(output_dir: str, metric_key: str, best: float,
                       wait: int, epoch: int) -> None:
    """Atomic write (temp + rename) of {metric_key, wait, epoch}."""
    path = os.path.join(output_dir, META_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({metric_key: best, "wait": wait, "epoch": epoch}, f)
    os.replace(tmp, path)


def read_trainer_meta(checkpoint_path: str) -> dict:
    """Meta next to a checkpoint file; {} when absent (pre-meta runs) or
    unreadable (a crash can leave a truncated file from pre-atomic writers;
    resuming with default loop state is safe — it only risks re-evaluating,
    never losing weights)."""
    path = os.path.join(os.path.dirname(checkpoint_path) or ".", META_NAME)
    if not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError):
        return {}
