"""The one traffic generator: every input a run hands the program, made
from `--seed`. The same seed gives the same inputs; every seed gives the
same sizes (lengths come from a fixed quantile grid, which the seed only
permutes), so seeds change the data and never the amount of work.

Device data (index rows) is drawn on the card by a torch.Generator in a
few large calls, chunk by chunk, so that the reference can draw the same
chunks again after the program's state is freed.
"""
from __future__ import annotations

import statistics

import numpy as np
import torch

CHUNK_ROWS = 1 << 21  # index rows drawn per call


def stream_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one named stream of a run's seed (any integer)."""
    ss = np.random.SeedSequence([seed % (1 << 64), *stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, *stream))


def device_generator(seed: int, *stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, *stream))


def index_chunks(seed: int, n: int, d: int, *, device, dtype=torch.bfloat16,
                 chunk_rows: int = CHUNK_ROWS):
    """Yields (first row, [rows, d] tensor) covering the n index rows, each
    entry N(0, 1/d), in `dtype` on `device`."""
    g = device_generator(seed, 1, device=device)
    for lo in range(0, n, chunk_rows):
        rows = min(chunk_rows, n - lo)
        x = torch.randn(rows, d, generator=g, device=device, dtype=dtype)
        yield lo, x.mul_(d ** -0.5)


def query_pool(seed: int, batches: int, q: int, d: int) -> np.ndarray:
    """[batches, q, d] f32 host query embeddings, N(0, 1/d)."""
    return (rng(seed, 2).standard_normal((batches, q, d), dtype=np.float32)
            * np.float32(d ** -0.5))


def lognormal_lengths(count: int, median: float, sigma: float, lo: int, hi: int) -> np.ndarray:
    """`count` lengths at the quantiles (i + 1/2) / count of a log-normal of
    this median and sigma, rounded and clipped to [lo, hi], ascending."""
    z = np.array([statistics.NormalDist().inv_cdf((i + 0.5) / count) for i in range(count)])
    return np.clip(np.rint(median * np.exp(sigma * z)), lo, hi).astype(np.int64)


def token_rows(r: np.random.Generator, lengths: np.ndarray, vocab: int, *, cls: int, sep: int,
               first_word: int) -> list[list[int]]:
    """Pre-tokenized rows of the given lengths, in the given order: [CLS],
    ids uniform in [first_word, vocab), [SEP]."""
    total = int(lengths.sum())
    words = r.integers(first_word, vocab, total, dtype=np.int64)
    rows, at = [], 0
    for n in lengths.tolist():
        row = words[at:at + n]
        row[0], row[-1] = cls, sep
        rows.append(row.tolist())
        at += n
    return rows


def paragraph_shards(seed: int, traffic: dict, vocab: int) -> list[list[list[int]]]:
    """traffic["pool"] shards of traffic["shard_rows"] paragraphs each, their
    lengths the log-normal grid of traffic["lengths"] in the seed's order."""
    spec = traffic["lengths"]
    lengths = lognormal_lengths(traffic["shard_rows"], spec["median"], spec["sigma"],
                                spec["min"], spec["max"])
    shards = []
    for s in range(traffic["pool"]):
        r = rng(seed, 3, s)
        shards.append(token_rows(r, r.permutation(lengths), vocab, **traffic["tokens"]))
    return shards


def _padded(rows: list[list[int]], width: int) -> tuple[np.ndarray, np.ndarray]:
    ids = np.zeros((len(rows), width), np.int64)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
    return ids, (ids != 0).astype(np.int32)


def pair_batches(seed: int, traffic: dict, vocab: int, count: int) -> list[dict]:
    """`count` optimizer steps' batches of (question, paragraph) pairs, every
    row distinct: traffic["micro"] * traffic["accumulate"] pairs a step,
    questions padded to traffic["query_width"] and paragraphs to
    traffic["max_length"]. Question lengths are spread evenly over
    traffic["query_lengths"] [lo, hi] and paragraph lengths are the
    log-normal grid of traffic["lengths"], both permuted by the seed."""
    rows = traffic["micro"] * traffic["accumulate"]
    lo, hi = traffic["query_lengths"]
    q_lengths = lo + (np.arange(rows) * (hi - lo + 1)) // rows
    spec = traffic["lengths"]
    c_lengths = lognormal_lengths(rows, spec["median"], spec["sigma"], spec["min"], spec["max"])
    out = []
    for s in range(count):
        r = rng(seed, 8, s)
        q_ids, q_mask = _padded(token_rows(r, r.permutation(q_lengths), vocab, **traffic["tokens"]),
                                traffic["query_width"])
        c_ids, c_mask = _padded(token_rows(r, r.permutation(c_lengths), vocab, **traffic["tokens"]),
                                traffic["max_length"])
        out.append({"input_ids_q": q_ids, "input_mask_q": q_mask,
                    "input_ids_c": c_ids, "input_mask_c": c_mask})
    return out
