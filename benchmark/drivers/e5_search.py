"""E5-Mistral-7B on the retrieve path: token ids through the decoder tower's
encode_query, its f32 embeddings into DenseIndex.search, a closed loop of
one client sending back-to-back batches.

Set-up draws the tower's weights on the card from the seed
(decoder_weights.py; the program takes them without a copy), then the
index (traffic.index_chunks, into the program's padded row buffer), and a
pool of batches on the host: each row BOS, the instruction's ids (drawn
once a seed), question ids uniform in [first_word, vocab) at log-normal
lengths on a fixed grid (every batch the same lengths, permuted by the
seed), EOS, right-padded by the program's collate to the batch's longest.
It warms the one shape up. The window runs the pool's batches in turn for
`seconds`; each batch is timed from encode_query's call (the ids still on
the host) to the scores and rows on the host. A traced run opens a BATCH
span around encode_query alone, and reads the tower's position and token
counters over its window.

Correctness, once the window has closed and the program's state is freed:
a few rows of every call, drawn from the seed, are kept with their
embeddings and answers; up to traffic["tower_check_rows"] of them are
encoded again by the plain tower (reference/mistral.py) at their own
lengths (embed_gap: reference/bert.py:worst_gap), and up to
traffic["check_queries"] of the program's own embeddings, rounded to bf16
as the search rounds them, are searched again by the plain search
(reference/search.py) over the rows drawn again.

A traced run also counts, after the check, the index rows that the rescore
(K6) of each traced batch must read: the blocks that the program's own
embeddings of the batch select, each once (search.candidate_rows), for the
k6_roofline reader; the window keeps each pool batch's embeddings on the
card for it, with no copy.
"""
from __future__ import annotations

import contextlib
import sys
import time

# first: a program without the decoder tower fails here, at once
from proqa_tpu_torch.models import mistral  # isort: skip

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import record_function  # noqa: E402

from benchmark import decoder_weights as dw  # noqa: E402
from benchmark import traffic as gen  # noqa: E402
from benchmark.drivers import search  # noqa: E402
from benchmark.harness import Outcome  # noqa: E402
from benchmark.reference import mistral as ref_tower  # noqa: E402
from benchmark.reference import search as ref  # noqa: E402
from benchmark.trace import BATCH, traced  # noqa: E402

SLICE_ROWS = 1 << 18  # index rows the plain search takes at a time


def build_model(seed: int, cfg: dict, device):
    """The program's E5 retriever holding the seed's weights (no copy)."""
    with torch.device("meta"):
        model = mistral.MistralRetriever(mistral.MistralConfig.from_json(cfg))
    model.load_state_dict(dw.decoder_weights(seed, cfg, device), assign=True)
    return model.eval()


def query_rows(seed: int, cfg: dict, tr: dict) -> list[list[list[int]]]:
    """traffic["pool"] batches of traffic["batch"] token rows."""
    tok, spec = tr["tokens"], tr["question_lengths"]
    vocab = cfg["vocab_size"]
    prefix = gen.rng(seed, 9).integers(tok["first_word"], vocab, tr["instruction_ids"]).tolist()
    lengths = gen.lognormal_lengths(tr["batch"], spec["median"], spec["sigma"], spec["min"],
                                    spec["max"])
    batches = []
    for b in range(tr["pool"]):
        r = gen.rng(seed, 10, b)
        batches.append([[tok["bos"], *prefix,
                         *r.integers(tok["first_word"], vocab, int(n)).tolist(), tok["eos"]]
                        for n in r.permutation(lengths)])
    return batches


def index_slices(seed: int, n: int, d: int, device):
    """The index rows drawn again (traffic.index_chunks), handed to the
    plain search SLICE_ROWS at a time: at 4,096-d a drawn chunk is 17 GB,
    and the search reference's f32 copy of it, twice over for the int8
    control's padding, would not fit beside it. Slices start on multiples
    of SLICE_ROWS, so every block of the int8 control's scheme lies in one."""
    for lo, chunk in gen.index_chunks(seed, n, d, device=device):
        for at in range(0, chunk.shape[0], SLICE_ROWS):
            yield lo + at, chunk[at:at + SLICE_ROWS]


def padded(rows: list[list[int]]) -> tuple[torch.Tensor, torch.Tensor]:
    """Host ids and mask, right-padded to the longest row by the program."""
    from proqa_tpu_torch.data.collate import collate_tokens

    ids = torch.from_numpy(collate_tokens(rows)).long()
    return ids, (ids != 0).to(torch.int32)


def run(cell, *, seed: int, seconds: float, trace: bool, device, clock) -> Outcome:
    from proqa_tpu_torch.ops.mips import envelope_block

    cfg, tr = cell.config, cell.traffic
    n, d = cfg["corpus_rows"], cfg["embed_dim"]
    q, k, keep = tr["batch"], tr["topk"], tr["kept_rows_per_call"]
    model = build_model(seed, cfg, device)
    index = search.build_index(seed, n, d, device)
    rows = query_rows(seed, cfg, tr)
    batches = [padded(b) for b in rows]
    for b in range(min(2, tr["pool"])):  # the one shape, twice: library load and build, then warm
        index.search(model.encode_query(*batches[b]), k)
    pick = gen.rng(seed, 5)
    kept = []  # (pool batch, row, embedding, values, ids)
    searched = {}  # pool batch -> its embeddings on the card (traced runs)

    def one(i: int) -> float:
        b = i % tr["pool"]
        t0 = time.perf_counter()
        with record_function(BATCH) if trace else contextlib.nullcontext():
            emb = model.encode_query(*batches[b])
        vals, ids = index.search(emb, k)
        dt = time.perf_counter() - t0
        if trace:
            searched.setdefault(b, emb)
        chosen = pick.choice(q, keep, replace=False)
        picked = emb[torch.from_numpy(chosen).to(device)].cpu().numpy()
        for j, r in enumerate(chosen):
            kept.append((b, int(r), picked[j], vals[r], ids[r]))
        return dt

    window_start = time.perf_counter()
    summary, times = None, []
    if trace:
        def window():
            mistral.reset_counters()
            return [one(i) for i in range(tr["trace_calls"])]

        summary, times = traced(window)
    else:
        while time.perf_counter() - window_start < seconds:
            times.append(one(len(times)))
    calls = len(times)
    window_s = time.perf_counter() - window_start
    print(search.call_times(times), file=sys.stderr)
    block = envelope_block(index.capacity, q)
    work = {"calls": calls, "n": n, "d": d, "q": q, "k": k, "block": block,
            "batch_lengths": [[len(r) for r in rows[i % tr["pool"]]] for i in range(calls)],
            "tower_positions": mistral.positions, "tower_tokens": mistral.tokens}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del index, model
    torch.cuda.empty_cache()

    checks = check(cell, seed, rows, kept, device)
    if trace:  # trace_calls >= pool: every pool batch ran in the traced window
        pool = np.stack([searched[b].cpu().numpy() for b in range(tr["pool"])])
        work["k6_rows"] = search.candidate_rows(cell, seed, pool, calls, block, device)
    return Outcome(
        attempted=calls * q, failed=0,
        end_to_end={"setup_s": window_start - clock.start,
                    "search_qps": calls * q / window_s,
                    "search_p95_ms": float(np.percentile(np.array(times) * 1e3, 95))},
        checks=checks, memory_peak_bytes=peak, trace=summary, work=work)


def check(cell, seed: int, rows: list, kept: list, device) -> dict:
    cfg, tr = cell.config, cell.traffic
    n, d, k = cfg["corpus_rows"], cfg["embed_dim"], tr["topk"]
    chosen = search.sample(seed, kept, tr["check_queries"])
    tower = search.sample(seed + 1, chosen, tr["tower_check_rows"])
    w = dw.decoder_weights(seed, cfg, device)
    want = ref_tower.embed_rows([rows[b][r] for b, r, *_ in tower], w, cfg, device)
    del w
    torch.cuda.empty_cache()
    got = {"embed_gap": ref_tower.worst_gap(
        [torch.from_numpy(e).to(device) for _, _, e, *_ in tower], want)}
    queries = torch.from_numpy(np.stack([e for _, _, e, *_ in chosen])).to(device)
    queries = queries.to(torch.bfloat16).to(torch.float32)
    prog_vals = np.stack([v for *_, v, _ in chosen])
    prog_ids = np.stack([i for *_, i in chosen]).astype(np.int64)
    ref_vals, _, scores = ref.topk_and_scores(
        queries, index_slices(seed, n, d, device), k, torch.from_numpy(prog_ids).to(device))
    got.update(ref.compare(prog_vals, prog_ids, ref_vals, scores, n))
    return {name: (got[name], cell.limits[name]) for name in cell.limits}


def control(cell, seed: int, device) -> dict:
    """The control's readings: the plain tower rounded to e4m3 in the
    program's place over as many rows as a run's tower check takes, drawn
    from the pool (embed_gap, against the bf16 plain tower); and for the
    search numbers, those rows' bf16 reference embeddings searched over the
    rows quantized to int8 as drivers/search.py:control searches them."""
    from proqa_tpu_torch.ops.mips import envelope_block

    cfg, tr = cell.config, cell.traffic
    n, d, k = cfg["corpus_rows"], cfg["embed_dim"], tr["topk"]
    pool = query_rows(seed, cfg, tr)
    r = gen.rng(seed, 7)
    count = tr["tower_check_rows"]
    rows = [pool[int(b)][int(i)] for b, i in zip(r.integers(0, tr["pool"], count),
                                                  r.integers(0, tr["batch"], count))]
    w = dw.decoder_weights(seed, cfg, device)
    want = ref_tower.embed_rows(rows, w, cfg, device)
    e4m3 = ref_tower.embed_rows(rows, w, cfg, device, rnd=ref_tower.fp8)
    del w
    torch.cuda.empty_cache()
    out = {"embed_gap": ref_tower.worst_gap(e4m3, want)}
    queries = torch.stack(want).to(torch.bfloat16).to(torch.float32)
    vals, ids = ref.int8_topk(queries, index_slices(seed, n, d, device), k,
                              envelope_block(n + (-n) % search.PAD_MULTIPLE, tr["batch"]))
    ref_vals, _, scores = ref.topk_and_scores(queries, index_slices(seed, n, d, device), k, ids)
    out.update(ref.compare(vals.cpu().numpy(), ids.cpu().numpy(), ref_vals, scores, n))
    return out
