"""Static-shape collation.

Copy of proqa_tpu/data/collate.py: the port keeps its own host code and imports
nothing of the JAX package.

The reference pads to the max length *within* each batch
(collate_tokens, upstream retrieval/datasets.py:29-45) — fine for
eager torch, but dynamic shapes force XLA recompilation. Here every batch is
padded to a fixed length (optionally from a small bucket ladder), so each
(batch, length) signature compiles once.
"""
from __future__ import annotations

import numpy as np


def pad_to(seqs, length: int, pad_value: int = 0, dtype=np.int32) -> np.ndarray:
    """List of int lists -> [B, length] array, truncating overlong rows."""
    out = np.full((len(seqs), length), pad_value, dtype=dtype)
    for i, s in enumerate(seqs):
        s = s[:length]
        out[i, : len(s)] = s
    return out


def collate_tokens(seqs, pad_value: int = 0, *, length: int | None = None,
                   buckets=None, dtype=np.int32) -> np.ndarray:
    """Pad a list of sequences to a static shape.

    length: explicit target (preferred, fully static);
    buckets: ascending lengths; the smallest bucket fitting the batch is used
             (bounded number of compiled signatures);
    neither: pads to batch max (reference behavior; avoid under jit).
    """
    maxlen = max((len(s) for s in seqs), default=0)
    if length is None:
        if buckets:
            length = next((b for b in buckets if b >= maxlen), buckets[-1])
        else:
            length = maxlen
    return pad_to(seqs, length, pad_value, dtype)


def pad_bucket(n: int, cap: int) -> int:
    """Smallest power-of-two >= n, capped at `cap` (the configured batch).

    The serving path pads question batches to these buckets instead of always
    to the full batch (log2(cap) compiled signatures instead of 1): a lone
    /answer request rides a 1-row dispatch while a MicroBatcher drain of 13
    rides a 16-row one, rather than every request paying the cap-row reader
    forward. `proqa serve --warmup` pre-pays each bucket's compile."""
    if n >= cap:
        return cap
    return min(1 << max(0, (n - 1).bit_length()), cap)


def batch_pad(batch: dict, batch_size: int) -> tuple[dict, int]:
    """Pad the batch dim of every array to `batch_size` by repeating row 0;
    returns (padded batch, true row count). Keeps trailing partial batches on
    the same compiled signature."""
    n = next(iter(batch.values())).shape[0]
    if n == batch_size:
        return batch, n
    pad = batch_size - n
    assert pad > 0, f"batch of {n} larger than target {batch_size}"
    out = {
        k: np.concatenate([v, np.repeat(v[:1], pad, axis=0)]) for k, v in batch.items()
    }
    return out, n
