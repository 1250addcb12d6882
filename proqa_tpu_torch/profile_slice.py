"""Where the device time goes in the port's hot workloads, on one NVIDIA GPU.

    python -m proqa_tpu_torch.profile_slice [--out build/profile_slice.json]

Workloads, at chip_smoke.py's sizes, with random seeded data and weights:
  search      DenseIndex.search, exact top-80 over a 4,194,304 x 128 bf16
              corpus, 2,048 queries per batch (kernel K1, then torch select
              and rescore);
  search_f32  the same over an f32 index (`--f32`);
  search_int8 the same over an int8 index (`--int8-index`): codes and
              per-block scales made on the device, quant block 16 (kernel
              K5, then the select and the scaled rescore);
  encode_T*   the BERT-base context tower, bf16, 512 rows of T tokens
              (build-index's batch; K2 at every layer);
  train       one retriever train step at bench.py's operating point
              (bench.py:_bench_train_step): BERT-base, bf16, remat, fused
              attention, dropout 0.1, 80 pairs of 32-token questions and
              512-token paragraphs, AdamW (K2, K3 and K4 in every layer).

For each workload:
  - a steady loop, host clock around calls that end synchronised (median,
    p25, p75), the peak device memory, and nvidia-smi's SM clock and power
    draw sampled during the loop;
  - a torch.profiler trace of a few more calls. Only GPU activity counts as
    device time: trace events of category kernel, gpu_memcpy and gpu_memset.
    Busy time is the union of their intervals; the idle share is 1 - busy /
    the host-clock wall of the traced calls. Device time is summed by kernel
    group, by the aten op that launched the kernel, and by kernel name.

Exits non-zero without a CUDA device: there is no CPU fallback.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

GPU_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

# kernel group: substrings of the kernel name, first match wins
GROUPS = (
    ("K5 block_maxima int8", ("bmax3_kernel<__nv_bfloat16, signed char>",)),
    ("K1 block_maxima", ("bmax_wgmma_kernel", "bmax3_kernel")),
    ("K6/K9 gather_score", ("gather_score_kernel",)),
    ("K2 attention", ("attention_fwd_",)),   # attention_fwd_wgmma_kernel (bf16), _simple_ (f32)
    ("K3 attention backward", ("attention_bwd_",)),  # attention_bwd_rows_ and _cols_kernel
    ("K4 dropout", ("dropout_vec_kernel", "dropout_scalar_kernel")),
    ("GEMM", ("nvjet", "gemm", "cutlass", "xmma", "sm90_")),
    ("topk/sort", ("topk", "radixSort", "Sort", "cub::")),
    ("gather/index", ("gather", "index_elementwise", "index_kernel")),
    ("reduction", ("reduce_kernel",)),
    ("elementwise", ("elementwise",)),
)


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
    ops = {e["args"]["External id"]: e["name"] for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    gpu = [e for e in events if e.get("cat") in GPU_CATEGORIES]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in gpu]
    busy_ms = busy_us(spans) / 1e3
    by_group, by_op, by_name = {}, {}, {}
    for e in gpu:
        ms = float(e["dur"]) / 1e3 / calls
        group = kernel_group(e["name"], e["cat"])
        op = ops.get(e.get("args", {}).get("External id"), "(no aten op)")
        by_group[group] = by_group.get(group, 0.0) + ms
        by_op[op] = by_op.get(op, 0.0) + ms
        name = e["name"][:120]
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + ms)

    def ranked(d: dict) -> dict:
        return dict(sorted(d.items(), key=lambda kv: -kv[1]))

    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:25]
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
    }


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
    from torch.profiler import ProfilerActivity, profile

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
        t0 = time.perf_counter()
        for _ in range(traced_calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    path = os.path.join(trace_dir, f"{name}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    result = {"workload": name, **extra, "steady_loop": loop,
              "trace": trace_breakdown(trace, traced_calls, wall_ms)}
    t = result["trace"]
    print(f"{name}: steady {loop['wall_ms_median']:.3f} ms per call "
          f"(p25 {loop['wall_ms_p25']:.3f}, p75 {loop['wall_ms_p75']:.3f}, n={loop_calls}), "
          f"peak {loop['peak_gib']:.2f} GiB, nvidia-smi {json.dumps(power)}; traced "
          f"{t['wall_ms_per_call']:.3f} ms wall, {t['device_busy_ms_per_call']:.3f} ms busy, "
          f"idle share {t['idle_share']:.4f}", flush=True)
    for group, ms in t["ms_per_call_by_group"].items():
        print(f"    {group:<16} {ms:10.3f} ms  {ms / t['device_busy_ms_per_call']:6.1%}")
    return result


def search_workload(dtype, trace_dir: str, loop_calls: int) -> dict:
    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.ops import mips

    n, q, d, k = 4_194_304, 2048, 128, 80
    device = torch.device("cuda", 0)
    g = torch.Generator(device=device).manual_seed(4)
    corpus = (torch.randn(n, d, device=device, generator=g) / d ** 0.5).to(dtype)
    queries = torch.randn(q, d, device=device, generator=g) / d ** 0.5
    index = DenseIndex.from_embeddings(corpus, device=device, dtype=dtype)
    del corpus
    block = mips.envelope_block(index.embeddings.shape[0], q)
    name = "search" if dtype == torch.bfloat16 else "search_f32"
    result = measure(name, lambda: index.search(queries, k), loop_calls=loop_calls,
                     traced_calls=3, trace_dir=trace_dir,
                     extra={"shape": {"n": n, "d": d, "q": q, "k": k, "block": block,
                                      "dtype": str(dtype)},
                            "k1_flop_per_call": 2.0 * n * q * d})
    result["qps"] = q / result["steady_loop"]["wall_ms_median"] * 1e3
    return result


def search_int8_workload(trace_dir: str, loop_calls: int) -> dict:
    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.ops import mips
    from proqa_tpu_torch.testing import random_int8_corpus

    n, q, d, k = 4_194_304, 2048, 128, 80
    device = torch.device("cuda", 0)
    block = mips.envelope_block(n, q)
    codes, scales = random_int8_corpus(n, d, block, seed=4, device=device)
    index = DenseIndex._from_quantized(codes, scales, n, block, None)
    g = torch.Generator(device=device).manual_seed(5)
    queries = torch.randn(q, d, device=device, generator=g) / d ** 0.5
    result = measure("search_int8", lambda: index.search(queries, k), loop_calls=loop_calls,
                     traced_calls=3, trace_dir=trace_dir,
                     extra={"shape": {"n": n, "d": d, "q": q, "k": k, "block": block,
                                      "dtype": "int8, bf16 queries"},
                            "k5_flop_per_call": 2.0 * n * q * d})
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile_slice.json")
    args = ap.parse_args(argv)
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
        for dtype, calls in ((torch.bfloat16, 100), (torch.float32, 25)):
            report["workloads"].append(search_workload(dtype, trace_dir, calls))
            torch.cuda.empty_cache()
        report["workloads"].append(search_int8_workload(trace_dir, 100))
        torch.cuda.empty_cache()
        model = Retriever(BertConfig(flash_attention=True)).reset_parameters(5).to("cuda").eval()
        for t, calls in ((128, 20), (256, 10), (512, 5)):
            report["workloads"].append(encode_workload(model, t, trace_dir, calls))
            torch.cuda.empty_cache()
        del model
        report["workloads"].append(train_workload(trace_dir, 10))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
