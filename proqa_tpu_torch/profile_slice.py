"""Where the device time goes in the port's hot workloads, on one NVIDIA GPU.

    python -m proqa_tpu_torch.profile_slice [--out build/profile_slice.json]
        [--only search,search_21m]

Workloads, at chip_smoke.py's sizes (search_21m at the benchmark's), with random
seeded data and weights:
  search      DenseIndex.search, exact top-80 over a 4,194,304 x 128 bf16
              corpus, 2,048 queries per batch (kernel K1, torch select,
              then kernel K6's rescore);
  search_f32  the same over an f32 index (`--f32`; kernel K1's f32 body,
              csrc/block_maxima_f32.cu, and K6 over f32 rows);
  search_21m  the bf16 search over 21,015,324 rows (psgs_w100's count, the
              benchmark's 128-d index) in a 21,015,552-row buffer: the
              rows end inside the last group of block maxima, so the
              select masks that group for padding;
  search_int8 the same over an int8 index (`--int8-index`): codes and
              per-block scales made on the device, quant block 16 (kernel
              K5, then the select and the scaled `take` rescore);
  encode_T*   the BERT-base context tower, bf16, 512 rows of T tokens
              (build-index's batch; K2, F1 and F2 at every layer);
  train       one retriever train step at bench.py's operating point
              (bench.py:_bench_train_step): BERT-base, bf16, remat, fused
              attention, dropout 0.1, 80 pairs of 32-token questions and
              512-token paragraphs, AdamW (K2, K3 and K4 in every layer);
  qa          one warm eval-qa question group (QATrainer's retrieve, read
              and decode over 8 questions): the BERT-base query tower (T =
              30), the exact top-5 search of an 8,192 x 128 bf16 index (K1,
              K6), sqlite and tokenization of 40 paragraphs of 100-510 words,
              the BERT-base reader over 8 x 5 rows of T = 512 (K2, F1 and F2
              in every layer), the span decode, and the text projection;
              beside it the sampler alone, the reader step alone, and the
              whole predict over 256 questions with and without the
              prefetch thread (three pairs, alternating which runs first,
              after a warm-up of each);
  qa_train    one QA train step (QATrainer._train_step) on a fixed batch of
              the online sampler's train load: 4 questions x 5 paragraphs
              at T = 512, queries at T = 30, 5,000 candidates gathered from
              an 8,192-row index, BERT-base reader and retriever, bf16,
              remat, fused attention, dropout 0.1, qa_drop 0.1 (K2, K3 and
              K4 in every reader layer); the sampler's load of the batch
              timed apart on the host clock.

For each workload:
  - a steady loop, host clock around calls that end synchronised (median,
    p25, p75), the peak device memory, and nvidia-smi's SM clock and power
    draw sampled during the loop;
  - a torch.profiler trace of a few more calls. Only GPU activity counts as
    device time: trace events of category kernel, gpu_memcpy and gpu_memset.
    Busy time is the union of their intervals; the idle share is 1 - busy /
    the host-clock wall of the traced calls. Device time is summed by kernel
    group, by the aten op that launched the kernel, and by kernel name;
  - device and idle time by program span (the `proqa.*` spans of
    utils/profiling.py:span, see span_times);
  - for the searches, the groups of block maxima the select masks for
    padding a call (ops/mips_kernel.py:tail_mask_groups).

--only runs the named workloads alone (the encode workloads are named
encode_T128, encode_T256, encode_T512). Exits non-zero without a CUDA
device: there is no CPU fallback.
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

GPU_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# host calls behind the GPU records: kernel launches, copies and sets
CALL_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel",
                 "cudaMemcpy", "cudaMemset")
WINDOW = "profile_slice.window"  # the user annotation around the traced calls
PROGRAM = "proqa."  # the prefix of the program's span names
NO_SPAN = "(none)"  # span_times' key for idle time outside every program span

# kernel group: substrings of the kernel name, first match wins. The Hopper
# block-maxima kernel names its epilogue and output layout
# (bmax_wgmma_kernel<block, warpgroups, corpus type, epilogue, layout>), the
# f32 one is bmax_f32_kernel<block, queries a thread>; the simple body names
# its output layout. K6/K9 is gather_score_ring_kernel<T> (in older
# checkouts gather_score_kernel<T>), grouped before "gather" can claim it.
GROUPS = (
    ("K5 block_maxima int8", ("BlockScales",)),
    ("K7 block_maxima int8 bound", ("RowBounds",)),
    ("K8 block_maxima block-major", ("BlockMajor",)),
    ("K8 simple body", ("bmax_block_major_kernel",)),
    ("K1 f32", ("bmax_f32_kernel",)),
    ("K5/K7 simple body", ("bmax3_kernel<float, signed char>",
                           "bmax3_kernel<__nv_bfloat16, signed char>")),
    ("K1 block_maxima", ("bmax_wgmma_kernel", "bmax3_kernel")),
    ("K6/K9 gather_score", ("gather_score_ring_kernel", "gather_score_kernel")),
    ("K2 attention", ("attention_fwd_",)),   # attention_fwd_wgmma_kernel (bf16), _f32_ (f32)
    ("K3 attention backward", ("attention_bwd_",)),  # attention_bwd_rows_ and _cols_kernel
    ("K4 dropout", ("dropout_vec_kernel", "dropout_scalar_kernel")),
    # the backward kernels and their column sums before the forward's keys claim them
    # (dense_epilogue_bwd_kernel, add_layer_norm_bwd_kernel; an older checkout
    # profiled with this script also has their _sums_kernel and F2's _vec_
    # and _scalar_ bodies, which the same prefixes group)
    ("F1 backward", ("dense_epilogue_bwd",)),
    ("F2 backward", ("add_layer_norm_bwd",)),
    ("F1 dense epilogue", ("dense_epilogue_",)),    # dense_epilogue_vec_kernel, _scalar_
    ("F2 add+LayerNorm", ("add_layer_norm_",)),     # add_layer_norm_vec_kernel, _scalar_
    ("GEMM", ("nvjet", "gemm", "cutlass", "xmma", "sm90_")),
    ("topk/sort", ("topk", "radixSort", "Sort", "cub::")),
    ("gather/index", ("gather", "index_elementwise", "index_kernel")),
    ("reduction", ("reduce_kernel",)),
    ("elementwise", ("elementwise",)),
)


# GPU work launched inside these spans (utils/profiling.py:span) is grouped
# by the span's name, before the kernel-name groups (QATrainer._eval_step
# wraps the span decode in one)
ANNOTATED_GROUPS = ("proqa.qa.decode",)


def kernel_group(name: str, cat: str) -> str:
    if cat != "kernel":
        return cat
    for group, keys in GROUPS:
        if any(key in name for key in keys):
            return group
    return "other"


def busy_us(spans: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def trace_breakdown(trace: dict, calls: int, wall_ms: float) -> dict:
    """Device time per call from a chrome trace exported by torch.profiler."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    cpu_ops = {e["args"]["External id"]: e for e in events
               if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    # an annotated range claims the kernels launched inside it by its own
    # thread (another thread, such as the QA prefetch thread, may launch
    # meanwhile)
    ranges = [(e["name"], e.get("tid"), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in events
              if e.get("cat") == "user_annotation" and e["name"] in ANNOTATED_GROUPS]
    gpu = [e for e in events if e.get("cat") in GPU_CATEGORIES]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in gpu]
    busy_ms = busy_us(spans) / 1e3
    by_group, by_op, by_name = {}, {}, {}
    for e in gpu:
        ms = float(e["dur"]) / 1e3 / calls
        launcher = cpu_ops.get(e.get("args", {}).get("External id"))
        group = kernel_group(e["name"], e["cat"])
        if launcher is not None:
            ts = float(launcher["ts"])
            group = next((name for name, tid, s, end in ranges
                          if tid == launcher.get("tid") and s <= ts < end), group)
        op = launcher["name"] if launcher is not None else "(no aten op)"
        by_group[group] = by_group.get(group, 0.0) + ms
        by_op[op] = by_op.get(op, 0.0) + ms
        name = e["name"][:120]
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + ms)

    def ranked(d: dict) -> dict:
        return dict(sorted(d.items(), key=lambda kv: -kv[1]))

    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:25]
    span_device, span_idle = span_times(events)
    return {
        "traced_calls": calls,
        "wall_ms_per_call": wall_ms / calls,
        "device_busy_ms_per_call": busy_ms / calls,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "gpu_events_per_call": len(gpu) / calls,
        "ms_per_call_by_group": ranked(by_group),
        "ms_per_call_by_launching_op": ranked(by_op),
        "top_kernels": [{"name": n, "launches_per_call": c / calls, "ms_per_call": t}
                        for n, (c, t) in top],
        "device_ms_per_call_by_span": ranked({k: v * 1e3 / calls for k, v in span_device.items()}),
        "idle_ms_per_call_by_span": ranked({k: v * 1e3 / calls for k, v in span_idle.items()}),
    }


class _Spans:
    """One thread's program spans, properly nested: the innermost one open
    at a time."""

    def __init__(self, spans: list[tuple[float, float, str]]):
        self.spans = sorted(spans, key=lambda x: (x[0], -x[1]))  # outer first on a tie
        self.starts = [s for s, _, _ in self.spans]
        self.parent: list[int] = []
        stack: list[int] = []
        for i, (s, _, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] <= s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def innermost(self, t: float) -> str | None:
        # the last span to start by t, else the nearest of its enclosing
        # spans still open at t
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i][1] <= t:
            i = self.parent[i]
        return self.spans[i][2] if i >= 0 else None


def span_times(events: list[dict]) -> tuple[dict, dict]:
    """(device, idle) seconds by program span inside the WINDOW annotation,
    ({}, {}) where the trace has none. Device: each GPU record charged to
    the innermost `proqa.*` span open on the thread of its host call (a
    launch, copy or set, matched by correlation id) when that call was made;
    every span name of the window is a key. Idle: the window's idle gaps cut
    at the span boundaries on the window's thread, each piece charged to the
    innermost span open over it or to NO_SPAN, so the values sum to the
    window's idle time."""
    windows = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
    if not windows:
        return {}, {}
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    by_tid: dict = {}
    for e in events:
        if (e.get("cat") == "user_annotation" and e["name"].startswith(PROGRAM)
                and w0 <= float(e["ts"]) < w1):
            by_tid.setdefault(e.get("tid"), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
    threads = {tid: _Spans(spans) for tid, spans in by_tid.items()}
    device = {name: 0.0 for spans in by_tid.values() for _, _, name in spans}
    calls = {e.get("args", {}).get("correlation"): e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and e["name"].startswith(CALL_PREFIXES)}
    gpu = [e for e in events if e.get("cat") in GPU_CATEGORIES]
    for rec in gpu:
        call = calls.get(rec.get("args", {}).get("correlation"))
        spans = threads.get(call.get("tid")) if call is not None else None
        name = spans.innermost(float(call["ts"])) if spans is not None else None
        if name is not None:
            device[name] += float(rec["dur"]) / 1e6
    busy = sorted((max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1))
                  for e in gpu)
    gaps, prev = [], w0
    for s, e in [(s, e) for s, e in busy if e > s] + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    own = threads.get(windows[0].get("tid"))
    idle = {name: 0.0 for _, _, name in (own.spans if own else [])}
    cuts = sorted({t for s, e, _ in (own.spans if own else []) for t in (s, e)})
    for s, e in gaps:
        points = [s] + cuts[bisect.bisect_right(cuts, s):bisect.bisect_left(cuts, e)] + [e]
        for a, b in zip(points, points[1:]):
            name = (own.innermost((a + b) / 2) if own else None) or NO_SPAN
            idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    return device, idle


def smi_sampler() -> subprocess.Popen:
    return subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
         "-lms", "200"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)


def smi_summary(proc: subprocess.Popen) -> dict:
    proc.terminate()
    out, _ = proc.communicate(timeout=30)
    clocks, watts = [], []
    for line in out.splitlines():
        parts = [p.strip() for p in line.split(",")]
        try:
            clocks.append(float(parts[0]))
            watts.append(float(parts[1]))
        except (ValueError, IndexError):
            continue
    if not watts:
        return {"samples": 0}
    return {"samples": len(watts), "sm_clock_mhz_median": statistics.median(clocks),
            "power_w_median": statistics.median(watts), "power_w_max": max(watts)}


def measure(name: str, fn, *, loop_calls: int, traced_calls: int, trace_dir: str,
            extra: dict) -> dict:
    """Steady loop, then a profiled window, of fn() (which must return only
    after its device work is done)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    fn()
    torch.cuda.reset_peak_memory_stats()
    smi = smi_sampler()
    try:
        walls = []
        for _ in range(loop_calls):
            t0 = time.perf_counter()
            fn()
            walls.append((time.perf_counter() - t0) * 1e3)
    finally:
        power = smi_summary(smi)
    q = statistics.quantiles(walls, n=4)
    loop = {"calls": loop_calls, "wall_ms_median": statistics.median(walls),
            "wall_ms_p25": q[0], "wall_ms_p75": q[2],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "nvidia_smi": power}

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        with record_function(WINDOW):
            t0 = time.perf_counter()
            for _ in range(traced_calls):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    path = os.path.join(trace_dir, f"{name}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    result = {"workload": name, **extra, "calls": 2 + loop_calls + traced_calls,
              "steady_loop": loop,
              "trace": trace_breakdown(trace, traced_calls, wall_ms)}
    t = result["trace"]
    print(f"{name}: steady {loop['wall_ms_median']:.3f} ms per call "
          f"(p25 {loop['wall_ms_p25']:.3f}, p75 {loop['wall_ms_p75']:.3f}, n={loop_calls}), "
          f"peak {loop['peak_gib']:.2f} GiB, nvidia-smi {json.dumps(power)}; traced "
          f"{t['wall_ms_per_call']:.3f} ms wall, {t['device_busy_ms_per_call']:.3f} ms busy, "
          f"idle share {t['idle_share']:.4f}", flush=True)
    for group, ms in t["ms_per_call_by_group"].items():
        print(f"    {group:<16} {ms:10.3f} ms  {ms / t['device_busy_ms_per_call']:6.1%}")
    for name, ms in t["device_ms_per_call_by_span"].items():
        print(f"    {name:<26} {ms:10.3f} ms device, "
              f"{t['idle_ms_per_call_by_span'].get(name, 0.0):8.3f} ms idle")
    if NO_SPAN in t["idle_ms_per_call_by_span"]:
        print(f"    {NO_SPAN:<26} {t['idle_ms_per_call_by_span'][NO_SPAN]:8.3f} ms idle")
    return result


def tail_masks(result: dict) -> None:
    """Adds (and prints) the groups the select masked for padding a call,
    over every call of measure() since mips_kernel.tail_mask_groups was
    reset."""
    from proqa_tpu_torch.ops import mips_kernel

    calls = result["calls"]
    result["tail_mask_groups_per_call"] = mips_kernel.tail_mask_groups / calls
    print(f"    tail_mask_groups {result['tail_mask_groups_per_call']:.3f} a call "
          f"({mips_kernel.tail_mask_groups} over {calls} calls)", flush=True)


def search_workload(name: str, dtype, n: int, trace_dir: str, loop_calls: int) -> dict:
    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.ops import mips, mips_kernel

    q, d, k = 2048, 128, 80
    device = torch.device("cuda", 0)
    g = torch.Generator(device=device).manual_seed(4)
    corpus = (torch.randn(n, d, device=device, generator=g) / d ** 0.5).to(dtype)
    queries = torch.randn(q, d, device=device, generator=g) / d ** 0.5
    index = DenseIndex.from_embeddings(corpus, device=device, dtype=dtype)
    del corpus
    block = mips.envelope_block(index.embeddings.shape[0], q)
    mips_kernel.tail_mask_groups = 0
    result = measure(name, lambda: index.search(queries, k), loop_calls=loop_calls,
                     traced_calls=3, trace_dir=trace_dir,
                     extra={"shape": {"n": n, "d": d, "q": q, "k": k, "block": block,
                                      "dtype": str(dtype)},
                            "k1_flop_per_call": 2.0 * n * q * d})
    tail_masks(result)
    result["qps"] = q / result["steady_loop"]["wall_ms_median"] * 1e3
    return result


def search_int8_workload(trace_dir: str, loop_calls: int) -> dict:
    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.ops import mips, mips_kernel
    from proqa_tpu_torch.testing import random_int8_corpus

    n, q, d, k = 4_194_304, 2048, 128, 80
    device = torch.device("cuda", 0)
    block = mips.envelope_block(n, q)
    codes, scales = random_int8_corpus(n, d, block, seed=4, device=device)
    index = DenseIndex._from_quantized(codes, scales, n, block, None)
    g = torch.Generator(device=device).manual_seed(5)
    queries = torch.randn(q, d, device=device, generator=g) / d ** 0.5
    mips_kernel.tail_mask_groups = 0
    result = measure("search_int8", lambda: index.search(queries, k), loop_calls=loop_calls,
                     traced_calls=3, trace_dir=trace_dir,
                     extra={"shape": {"n": n, "d": d, "q": q, "k": k, "block": block,
                                      "dtype": "int8, bf16 queries"},
                            "k5_flop_per_call": 2.0 * n * q * d})
    tail_masks(result)
    result["qps"] = q / result["steady_loop"]["wall_ms_median"] * 1e3
    return result


def encode_workload(model, t: int, trace_dir: str, loop_calls: int) -> dict:
    b, cfg = 512, model.cfg
    device = torch.device("cuda", 0)
    g = torch.Generator(device=device).manual_seed(3)
    ids = torch.randint(5, 68, (b, t), device=device, generator=g)
    lengths = torch.randint(t // 2, t + 1, (b,), device=device, generator=g)
    mask = (torch.arange(t, device=device)[None] < lengths[:, None]).to(torch.int32)
    ids = ids * mask
    h, layers, inter = cfg.hidden_size, cfg.num_layers, cfg.intermediate_size

    def call():
        with torch.inference_mode():
            out = model.encode_context(ids, mask)
        torch.cuda.synchronize()
        return out

    result = measure(f"encode_T{t}", call, loop_calls=loop_calls, traced_calls=2,
                     trace_dir=trace_dir,
                     extra={"shape": {"batch": b, "seq": t, "hidden": h, "layers": layers,
                                      "heads": cfg.num_heads, "dtype": str(cfg.dtype)},
                            "gemm_flop_per_call": 2.0 * b * t * layers * (4 * h * h + 2 * h * inter),
                            "k2_flop_per_call": 4.0 * b * t * t * h * layers})
    result["padded_tokens_per_s"] = b * t / result["steady_loop"]["wall_ms_median"] * 1e3
    return result


def train_workload(trace_dir: str, loop_calls: int) -> dict:
    from proqa_tpu_torch.models.bert import BertConfig
    from proqa_tpu_torch.models.retriever import Retriever
    from proqa_tpu_torch.train.optim import AdamW, init_train_state
    from proqa_tpu_torch.train.retriever_trainer import train_step

    b, tq, tc = 80, 32, 512
    cfg = BertConfig(remat=True, flash_attention=True)
    device = torch.device("cuda", 0)
    g = torch.Generator(device=device).manual_seed(2)
    batch = {"input_ids_q": torch.randint(5, cfg.vocab_size, (b, tq), device=device, generator=g),
             "input_mask_q": torch.ones(b, tq, dtype=torch.int32, device=device),
             "input_ids_c": torch.randint(5, cfg.vocab_size, (b, tc), device=device, generator=g),
             "input_mask_c": torch.ones(b, tc, dtype=torch.int32, device=device)}
    model = Retriever(cfg).reset_parameters(0).to(device)
    box = {"state": init_train_state(dict(model.named_parameters()))}
    tx = AdamW(1e-5, max_grad_norm=2.0)
    gen = torch.Generator().manual_seed(3)

    def call():
        box["state"], m = train_step(model, box["state"], tx, batch, gen)
        return float(m["loss"])  # synchronises

    h, layers, inter = cfg.hidden_size, cfg.num_layers, cfg.intermediate_size
    tokens = b * (tq + tc)
    # forward GEMMs of both towers, x3 for backward, +1 forward for remat
    gemm = 2.0 * tokens * layers * (4 * h * h + 2 * h * inter) * 4
    result = measure("train", call, loop_calls=loop_calls, traced_calls=2, trace_dir=trace_dir,
                     extra={"shape": {"batch": b, "q_len": tq, "c_len": tc, "hidden": h,
                                      "layers": layers, "dtype": str(cfg.dtype), "remat": True,
                                      "dropout": cfg.hidden_dropout},
                            "gemm_flop_per_call": gemm,
                            "k2_flop_per_call": 2 * 4.0 * b * tc * tc * h * layers,
                            "k3_flop_per_call": 10.0 * b * tc * tc * h * layers})
    result["tokens_per_s"] = tokens / result["steady_loop"]["wall_ms_median"] * 1e3
    return result


VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"tok{i}" for i in range(60)] + [
    "what", "is", "about",
]


def _qa_world(trace_dir: str, rng, n: int = 8192):
    """The QA workloads' world: n paragraphs of 100-510 words in sqlite, a
    random n x 128 bf16 index on the card, the vocabulary. Returns (root,
    db, index, tokenizer)."""
    from proqa_tpu_torch.data.docdb import DocDB
    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.index.idmap import IdMap
    from proqa_tpu_torch.text.wordpiece import BertTokenizer

    device = torch.device("cuda", 0)
    root = tempfile.mkdtemp(prefix="proqa_profile_qa_", dir=trace_dir)
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(VOCAB) + "\n")
    paras = [(f"p{i}", " ".join(f"tok{w}" for w in rng.integers(0, 60, int(rng.integers(100, 511)))))
             for i in range(n)]
    db = DocDB.create(os.path.join(root, "docs.db"), paras)
    g = torch.Generator(device=device).manual_seed(13)
    emb = torch.randn(n, 128, device=device, generator=g) / 128 ** 0.5
    index = DenseIndex.from_embeddings(emb, IdMap([pid for pid, _ in paras]), device=device)
    return root, db, index, BertTokenizer.from_vocab_file(os.path.join(root, "vocab.txt"))


def _host_clock(fn, calls=5) -> float:
    """Median host ms of fn() after one warm-up call (fn ends on the host)."""
    fn()
    walls = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def qa_workload(trace_dir: str, loop_calls: int) -> dict:
    import numpy as np

    from proqa_tpu_torch.models.bert import BertConfig
    from proqa_tpu_torch.models.reader import QAConfig
    from proqa_tpu_torch.qa.sampler import OnlineSampler, OnlineSamplerConfig
    from proqa_tpu_torch.train import qa_trainer

    n, qpb, k, t, tq = 8192, 8, 5, 512, 30
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(12)
    root, db, index, tok = _qa_world(trace_dir, rng, n)
    questions = [{"question": f"what is about tok{a} tok{b}", "answer": [f"tok{b}"]}
                 for a, b in rng.integers(0, 60, (qpb, 2))]
    cfg = BertConfig(flash_attention=True)
    trainer = qa_trainer.QATrainer(cfg, QAConfig(), qa_trainer.QATrainerConfig(
        eval_k=k, questions_per_batch=qpb, output_dir=os.path.join(root, "run")), device=device)
    sampler = OnlineSampler(questions, tok, db, index,
                            OnlineSamplerConfig(max_query_length=tq, max_length=t,
                                                question_batch=qpb, exact_search=True))

    def group():
        return list(trainer._iter_candidate_predictions(sampler, qpb))  # ends on the host

    enc = trainer.query_encoder()
    batch = next(iter(sampler.eval_load(enc, k, qpb)))
    parts = {"sampler_eval_load_ms": _host_clock(lambda: list(sampler.eval_load(enc, k, qpb))),
             "reader_step_ms": _host_clock(lambda: trainer._eval_step(batch["net_input"]))}
    h, layers, inter = cfg.hidden_size, cfg.num_layers, cfg.intermediate_size
    rows = qpb * k
    result = measure("qa", group, loop_calls=loop_calls, traced_calls=3, trace_dir=trace_dir,
                     extra={"shape": {"questions": qpb, "eval_k": k, "reader_rows": rows,
                                      "seq": t, "query_len": tq, "index_rows": n,
                                      "dtype": str(cfg.dtype)},
                            "host_clock_parts": parts,
                            "reader_gemm_flop_per_call":
                                2.0 * rows * t * layers * (4 * h * h + 2 * h * inter),
                            "k2_flop_per_call": 4.0 * rows * t * t * h * layers})
    # the whole eval-qa predict over 256 distinct questions (32 groups), with
    # the sampler of the next group built ahead in the prefetch thread
    # (--prefetch 2) and without it (--prefetch 0): one warm-up of each, then
    # three pairs, each order first in turn; then --prefetch 2 with Python's
    # thread switch interval cut from 5 ms to 0.5 ms, twice (a diagnostic:
    # the main thread waits for the GIL after each op it launches while the
    # prefetch thread runs Python)
    many = [{"question": f"what is about tok{pair // 60} tok{pair % 60}", "answer": ["tok1"]}
            for pair in rng.choice(60 * 60, 256, replace=False)]

    def predict(prefetch):
        trainer.tcfg = dataclasses.replace(trainer.tcfg, prefetch_batches=prefetch)
        t0 = time.perf_counter()
        trainer.predict(OnlineSampler(many, sampler.tokenizer, db, index, sampler.cfg))
        return time.perf_counter() - t0

    predict(2), predict(0)
    predict_s = {"prefetch_2": [], "prefetch_0": [], "prefetch_2_switch_0.5ms": []}
    for prefetch in (2, 0, 0, 2, 2, 0):
        predict_s[f"prefetch_{prefetch}"].append(predict(prefetch))
    switch = sys.getswitchinterval()
    sys.setswitchinterval(5e-4)
    try:
        predict_s["prefetch_2_switch_0.5ms"] = [predict(2), predict(2)]
    finally:
        sys.setswitchinterval(switch)
    result["predict_256_questions_s"] = predict_s
    wall = result["steady_loop"]["wall_ms_median"]
    result["questions_per_s"] = qpb / wall * 1e3
    result["reader_tokens_per_s"] = qpb * k * t / wall * 1e3
    print(f"qa: {result['questions_per_s']:.2f} questions/s, {result['reader_tokens_per_s']:.0f} "
          f"reader tokens/s; host clock parts {json.dumps(parts)}; predict over 256 questions "
          f"(s) {json.dumps(predict_s)}", flush=True)
    return result


def qa_train_workload(trace_dir: str, loop_calls: int) -> dict:
    """One QATrainer train step on a fixed batch of the online sampler's
    train load: 4 questions x 5 paragraphs at T = 512, queries at T = 30,
    5,000 candidates a question gathered from an 8,192-row index, BERT-base
    reader and retriever in bf16 with remat, fused attention, dropout 0.1
    and qa_drop 0.1, AdamW over the reader and the query tower. The
    sampler's load of that batch (query tower, search, sqlite, span
    matching, tensorizing) is timed apart on the host clock."""
    import numpy as np

    from proqa_tpu_torch.data.collate import batch_pad
    from proqa_tpu_torch.models.bert import BertConfig
    from proqa_tpu_torch.models.reader import QAConfig
    from proqa_tpu_torch.qa.sampler import OnlineSampler, OnlineSamplerConfig
    from proqa_tpu_torch.train.qa_trainer import QATrainer, QATrainerConfig

    n, qpb, k, t, tq, m = 8192, 4, 5, 512, 30, 5000
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(14)
    root, db, index, tok = _qa_world(trace_dir, rng, n)
    questions = [{"question": f"what is about tok{a} tok{b}", "answer": [f"tok{w}" for w in range(60)]}
                 for a, b in rng.integers(0, 60, (qpb, 2))]
    matched = os.path.join(root, "matched.jsonl")
    with open(matched, "w") as f:
        for qa in questions:
            f.write(json.dumps({"question": qa["question"], "matched_paras": {
                f"p{i}": "tok1" for i in range(0, n, 7)}}) + "\n")
    cfg = BertConfig(remat=True, flash_attention=True)
    trainer = QATrainer(cfg, QAConfig(qa_drop=0.1), QATrainerConfig(
        questions_per_batch=qpb, train_k=k, learning_rate=1e-5,
        output_dir=os.path.join(root, "run")), device=device)
    sampler = OnlineSampler(questions, tok, db, index, OnlineSamplerConfig(
        max_query_length=tq, max_length=t, candidates=m, question_batch=qpb, exact_search=True),
        matched)
    enc = trainer.query_encoder()
    load = lambda: next(iter(sampler.load(enc, k, qpb)))  # noqa: E731
    net, rows = batch_pad(load()["net_input"], qpb)
    net["question_mask"] = (np.arange(qpb) < rows).astype(np.int32)
    trainer.set_corpus(index)

    def step():
        return float(trainer._train_step(dict(net))["loss"])  # synchronises

    parts = {"sampler_load_ms": _host_clock(load)}
    h, layers, inter = cfg.hidden_size, cfg.num_layers, cfg.intermediate_size
    rows_r = qpb * k
    # forward GEMMs of the reader and the query tower, x3 for backward, +1
    # forward for remat
    gemm = 2.0 * (rows_r * t + qpb * tq) * layers * (4 * h * h + 2 * h * inter) * 4
    result = measure("qa_train", step, loop_calls=loop_calls, traced_calls=2,
                     trace_dir=trace_dir,
                     extra={"shape": {"questions": qpb, "train_k": k, "reader_rows": rows_r,
                                      "seq": t, "query_len": tq, "candidates": m,
                                      "index_rows": n, "dtype": str(cfg.dtype), "remat": True,
                                      "dropout": cfg.hidden_dropout, "qa_drop": 0.1},
                            "host_clock_parts": parts, "gemm_flop_per_call": gemm,
                            "k2_flop_per_call": 2 * 4.0 * rows_r * t * t * h * layers,
                            "k3_flop_per_call": 10.0 * rows_r * t * t * h * layers})
    result["reader_tokens_per_s"] = rows_r * t / result["steady_loop"]["wall_ms_median"] * 1e3
    print(f"qa_train: {result['reader_tokens_per_s']:.0f} reader tokens/s; host clock parts "
          f"{json.dumps(parts)}", flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile_slice.json")
    ap.add_argument("--only", default="", help="comma-separated workload names")
    args = ap.parse_args(argv)
    only = set(filter(None, args.only.split(",")))
    wanted = lambda name: not only or name in only  # noqa: E731
    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device; this measurement needs an NVIDIA GPU",
              file=sys.stderr)
        return 1

    from proqa_tpu_torch.models.bert import BertConfig
    from proqa_tpu_torch.models.retriever import Retriever
    from proqa_tpu_torch.ops.dot import pin_f32_precision

    pin_f32_precision()
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(gpu, flush=True)
    report = {"gpu": gpu, "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda, "workloads": []}
    with tempfile.TemporaryDirectory(prefix="proqa_profile_") as trace_dir:
        for name, dtype, n, calls in (("search", torch.bfloat16, 4_194_304, 100),
                                      ("search_f32", torch.float32, 4_194_304, 25),
                                      ("search_21m", torch.bfloat16, 21_015_324, 40)):
            if wanted(name):
                report["workloads"].append(search_workload(name, dtype, n, trace_dir, calls))
                torch.cuda.empty_cache()
        if wanted("search_int8"):
            report["workloads"].append(search_int8_workload(trace_dir, 100))
            torch.cuda.empty_cache()
        buckets = [(t, calls) for t, calls in ((128, 20), (256, 10), (512, 5))
                   if wanted(f"encode_T{t}")]
        if buckets:
            model = Retriever(BertConfig(flash_attention=True)).reset_parameters(5).to("cuda")
            model = model.eval()
            for t, calls in buckets:
                report["workloads"].append(encode_workload(model, t, trace_dir, calls))
                torch.cuda.empty_cache()
            del model
        if wanted("train"):
            report["workloads"].append(train_workload(trace_dir, 10))
            torch.cuda.empty_cache()
        if wanted("qa"):
            report["workloads"].append(qa_workload(trace_dir, 10))
            torch.cuda.empty_cache()
        if wanted("qa_train"):
            report["workloads"].append(qa_train_workload(trace_dir, 10))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
