"""Exact top-k search over a Wikipedia-scale index: DenseIndex.search, a
closed loop of one client sending back-to-back batches.

Set-up draws the index on the card from the seed (traffic.index_chunks,
into the program's padded row buffer) and a pool of distinct host query
batches, then warms the one batch shape up. The window searches the pool's
batches in turn for `seconds`; each call is timed from DenseIndex.search's
call to its scores and rows on the host.

Correctness: a few rows of every call's answer, drawn from the seed, are
kept; once the window has closed and the index is freed, up to
traffic["check_queries"] of them are searched again by the plain reference
(reference/search.py) over the same rows drawn again, and compared.

A traced run also counts, after the check, the index rows that the rescore
(K6) of each traced batch must read: the blocks its queries select, each
once (candidate_rows), for the k6_roofline reader.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark import traffic as gen
from benchmark.harness import Outcome
from benchmark.reference import search as ref
from benchmark.trace import traced

PAD_MULTIPLE = 1024  # DenseIndex's row padding


def build_index(seed: int, n: int, d: int, device):
    """The program's DenseIndex over n rows drawn from the seed."""
    from proqa_tpu_torch.index.dense import DenseIndex

    rows = torch.zeros(n + (-n) % PAD_MULTIPLE, d, dtype=torch.bfloat16, device=device)
    for lo, chunk in gen.index_chunks(seed, n, d, device=device):
        rows[lo:lo + chunk.shape[0]] = chunk
        del chunk
    return DenseIndex(embeddings=rows, n=n)


def _call(index, queries: np.ndarray, k: int):
    t0 = time.perf_counter()
    vals, ids = index.search(queries, k)
    return vals, ids, time.perf_counter() - t0


def run(cell, *, seed: int, seconds: float, trace: bool, device, clock) -> Outcome:
    from proqa_tpu_torch.ops.mips import envelope_block

    cfg, tr = cell.config, cell.traffic
    n, d = cfg["corpus_rows"], cfg["embed_dim"]
    q, k, keep = tr["batch"], tr["topk"], tr["kept_rows_per_call"]
    pool = gen.query_pool(seed, tr["pool"], q, d)
    index = build_index(seed, n, d, device)
    for b in range(min(2, tr["pool"])):  # the one shape, twice: library load, then warm
        index.search(pool[b], k)
    pick = gen.rng(seed, 5)
    kept = []  # (pool batch, row, values, ids)

    def one(i: int):
        b = i % tr["pool"]
        vals, ids, dt = _call(index, pool[b], k)
        for r in pick.choice(q, keep, replace=False):
            kept.append((b, int(r), vals[r], ids[r]))
        return dt

    window_start = time.perf_counter()
    summary, times = None, []
    if trace:
        summary, times = traced(lambda: [one(i) for i in range(tr["trace_calls"])])
        calls = len(times)
    else:
        calls = 0
        while time.perf_counter() - window_start < seconds:
            times.append(one(calls))
            calls += 1
    window_s = time.perf_counter() - window_start
    print(call_times(times), file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    block = envelope_block(index.capacity, q)
    del index

    checks = check(cell, seed, pool, kept, device)
    work = {"calls": calls, "n": n, "d": d, "q": q, "k": k, "block": block}
    if trace:
        work["k6_rows"] = candidate_rows(cell, seed, pool, calls, block, device)
    return Outcome(
        attempted=calls * q, failed=0,
        end_to_end={"setup_s": window_start - clock.start,
                    "search_qps": calls * q / window_s,
                    "search_p95_ms": float(np.percentile(np.array(times) * 1e3, 95))},
        checks=checks, memory_peak_bytes=peak, trace=summary, work=work)


def call_times(seconds: list) -> str:
    """One line on the window's calls: count and ms quantiles."""
    ms = np.array(seconds) * 1e3
    q = np.percentile(ms, [0, 5, 25, 50, 75, 95, 100])
    return f"calls: {len(ms)}, ms at 0/5/25/50/75/95/100%: " + " ".join(f"{v:.3f}" for v in q)


def sample(seed: int, kept: list, count: int) -> list:
    """Up to `count` of the kept answers, drawn from the seed."""
    r = gen.rng(seed, 6)
    chosen = r.choice(len(kept), min(count, len(kept)), replace=False)
    return [kept[i] for i in sorted(chosen)]


def sample_queries(pool: np.ndarray, chosen: list, device) -> torch.Tensor:
    """The chosen queries as the program scores them: rounded to bf16."""
    x = np.stack([pool[b, r] for b, r, *_ in chosen])
    return torch.from_numpy(x).to(device).to(torch.bfloat16).to(torch.float32)


def check(cell, seed: int, pool: np.ndarray, kept: list, device) -> dict:
    cfg, tr = cell.config, cell.traffic
    n, d, k = cfg["corpus_rows"], cfg["embed_dim"], tr["topk"]
    chosen = sample(seed, kept, tr["check_queries"])
    queries = sample_queries(pool, chosen, device)
    prog_vals = np.stack([v for *_, v, _ in chosen])
    prog_ids = np.stack([i for *_, i in chosen]).astype(np.int64)
    ids = torch.from_numpy(prog_ids).to(device)
    ref_vals, _, scores = ref.topk_and_scores(
        queries, gen.index_chunks(seed, n, d, device=device), k, ids)
    got = ref.compare(prog_vals, prog_ids, ref_vals, scores, n)
    return {name: (got[name], cell.limits[name]) for name in cell.limits}


def candidate_rows(cell, seed: int, pool: np.ndarray, calls: int, block: int, device) -> float:
    """The index rows the rescore of a traced batch must read, on average
    over the traced calls: each block that the batch's queries select
    counted once (reference/search.py:distinct_blocks), times the block."""
    cfg, tr = cell.config, cell.traffic
    n, d = cfg["corpus_rows"], cfg["embed_dim"]
    used = sorted({i % tr["pool"] for i in range(calls)})
    queries = torch.from_numpy(pool[used]).to(device).to(torch.bfloat16).to(torch.float32)
    counts = dict(zip(used, ref.distinct_blocks(
        queries, gen.index_chunks(seed, n, d, device=device), tr["topk"], block)))
    print(f"distinct candidate blocks a batch: {[counts[b] for b in used]} "
          f"of {tr['batch'] * tr['topk']} selections", file=sys.stderr)
    return float(np.mean([counts[i % tr["pool"]] for i in range(calls)])) * block


def control(cell, seed: int, device) -> dict:
    """The control's readings: the reference searching int8 rows in the
    program's place (the program's own int8 index has the same scheme, one
    scale a block of envelope_block rows), compared with the bf16 reference
    as a run's answers are."""
    from proqa_tpu_torch.ops.mips import envelope_block

    cfg, tr = cell.config, cell.traffic
    n, d, k = cfg["corpus_rows"], cfg["embed_dim"], tr["topk"]
    pool = gen.query_pool(seed, tr["pool"], tr["batch"], d)
    r = gen.rng(seed, 7)
    chosen = [(int(b), int(i)) for b, i in zip(r.integers(0, tr["pool"], tr["check_queries"]),
                                                r.integers(0, tr["batch"], tr["check_queries"]))]
    queries = sample_queries(pool, chosen, device)
    vals, ids = ref.int8_topk(queries, gen.index_chunks(seed, n, d, device=device), k,
                              envelope_block(n + (-n) % PAD_MULTIPLE, tr["batch"]))
    ref_vals, _, scores = ref.topk_and_scores(
        queries, gen.index_chunks(seed, n, d, device=device), k, ids)
    return ref.compare(vals.cpu().numpy(), ids.cpu().numpy(), ref_vals, scores, n)
