"""The traced window: a torch.profiler trace of a few calls, checked for
completeness and reduced to device time by kernel group, busy time, idle
gaps and launch counts.

The kernel groups, `busy_us` and the trace arithmetic are copies of the
program's own profiling script (proqa_tpu_torch/profile_slice.py), taken
here so that the yardstick stays fixed whatever the program's copy becomes.

A trace counts only when it is complete: every kernel launch recorded on
the host (`cudaLaunchKernel`, `cudaLaunchKernelExC`, `cuLaunchKernel*`) has
its kernel record, matched by correlation id. On the H100 machine a trace
sometimes holds the launch but not its kernel; such a window would
undercount busy time and kernel times, so it is dropped and traced again,
and after `attempts` incomplete windows the traced run fails.
"""
from __future__ import annotations

import bisect
import dataclasses
import gzip
import json
import os
import sys
import tempfile
import time

GPU_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel")
WINDOW = "benchmark.window"  # the user annotation around the traced calls
BATCH = "benchmark.batch"    # a driver's span around one batch's call into a layer

# kernel group: substrings of the kernel name, first match wins. Taken
# from profile_slice.GROUPS, with K1, K1 f32 and K6 widened to their forms
# past D = 128 (bmax_wgmma_wide_kernel, bmax_f32_wide_kernel,
# gather_score_wide_kernel), which that copy filed under "other" and
# "gather/index"
GROUPS = (
    ("K5 block_maxima int8", ("BlockScales",)),
    ("K7 block_maxima int8 bound", ("RowBounds",)),
    ("K8 block_maxima block-major", ("BlockMajor",)),
    ("K8 simple body", ("bmax_block_major_kernel",)),
    ("K1 f32", ("bmax_f32_",)),
    ("K5/K7 simple body", ("bmax3_kernel<float, signed char>",
                           "bmax3_kernel<__nv_bfloat16, signed char>")),
    ("K1 block_maxima", ("bmax_wgmma_", "bmax3_kernel")),
    ("K6/K9 gather_score", ("gather_score_",)),
    ("K2 attention", ("attention_fwd_",)),
    ("K3 attention backward", ("attention_bwd_",)),
    ("K4 dropout", ("dropout_vec_kernel", "dropout_scalar_kernel")),
    ("F1 backward", ("dense_epilogue_bwd",)),
    ("F2 backward", ("add_layer_norm_bwd",)),
    ("F1 dense epilogue", ("dense_epilogue_",)),
    ("F2 add+LayerNorm", ("add_layer_norm_",)),
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


def union(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The union of [start, end) intervals as sorted disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclasses.dataclass
class TraceSummary:
    """One complete traced window. Times in seconds."""
    window_s: float                  # the annotated window's length
    busy_s: float                    # union of GPU activity inside it
    group_s: dict                    # device seconds by kernel group
    launches: int                    # kernel launches recorded on the host
    kernels: int                     # kernel records
    idle_gaps: list                  # [[host op, idle seconds]], longest first
    batch_groups: list = dataclasses.field(default_factory=list)
    # for each BATCH span in start order, device seconds by kernel group of
    # the kernels launched inside it

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.group_s.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[name, s] for name, s in ops],
                "idle_gaps": self.idle_gaps[:top]}


def missing_kernels(events: list[dict]) -> int:
    """Host launch records whose kernel record is absent."""
    kernels = {e.get("args", {}).get("correlation") for e in events if e.get("cat") == "kernel"}
    return sum(1 for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")
               and e["name"].startswith(LAUNCH_PREFIXES)
               and e.get("args", {}).get("correlation") not in kernels)


def _host_labels(events: list[dict], times: list[float]) -> list[str]:
    """For each trace time, the innermost host op running then (an aten op
    before a user annotation), or "(python)" where none is: one sweep over
    the events in start order."""
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e) for e in events
                   if e.get("cat") in ("cpu_op", "user_annotation") and e["name"] != WINDOW),
                  key=lambda x: x[0])
    labels = [""] * len(times)
    active: list = []
    j = 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while j < len(host) and host[j][0] <= t:
            active.append(host[j])
            j += 1
        active = [a for a in active if a[1] > t]
        best = max(active, key=lambda a: (a[2].get("cat") == "cpu_op", a[0]), default=None)
        labels[i] = "(python)" if best is None else best[2]["name"]
    return labels


def summarize(trace: dict) -> TraceSummary:
    """Reduces a chrome trace exported by torch.profiler to a summary of the
    events inside its WINDOW annotation. Raises ValueError where the window
    is absent."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    windows = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
    if not windows:
        raise ValueError(f"no {WINDOW!r} annotation in the trace")
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    gpu = [e for e in events if e.get("cat") in GPU_CATEGORIES]
    spans = [(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)) for e in gpu]
    spans = [(s, e) for s, e in spans if e > s]
    group_s: dict = {}
    for e in gpu:
        g = kernel_group(e["name"], e["cat"])
        group_s[g] = group_s.get(g, 0.0) + float(e["dur"]) / 1e6
    busy = union(spans)
    gaps, prev = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    idle: dict = {}
    for (s, e), label in zip(gaps, _host_labels(events, [(s + e) / 2 for s, e in gaps])):
        idle[label] = idle.get(label, 0.0) + (e - s) / 1e6
    launch_records = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                      and e["name"].startswith(LAUNCH_PREFIXES)]
    return TraceSummary(
        window_s=(w1 - w0) / 1e6, busy_s=busy_us(spans) / 1e6, group_s=group_s,
        launches=len(launch_records), kernels=sum(1 for e in gpu if e.get("cat") == "kernel"),
        idle_gaps=[[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])],
        batch_groups=_batch_groups(events, gpu, launch_records))


def _batch_groups(events: list[dict], gpu: list[dict], launches: list[dict]) -> list[dict]:
    """Device seconds by kernel group of the kernels each BATCH span
    launched (a launch record inside the span, on its thread)."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("tid"))
                   for e in events if e.get("cat") == "user_annotation" and e["name"] == BATCH)
    if not spans:
        return []
    kernel = {e.get("args", {}).get("correlation"): e for e in gpu if e.get("cat") == "kernel"}
    starts = [s for s, _, _ in spans]
    out: list[dict] = [{} for _ in spans]
    for rec in launches:
        k = kernel.get(rec.get("args", {}).get("correlation"))
        if k is None:
            continue
        t = float(rec["ts"])
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < spans[i][1] and rec.get("tid") == spans[i][2]:
            g = kernel_group(k["name"], "kernel")
            out[i][g] = out[i].get(g, 0.0) + float(k["dur"]) / 1e6
    return out


def traced(run_calls, *, attempts: int = 4, log=sys.stderr):
    """Runs run_calls() inside a torch.profiler window until a complete trace
    comes, at most `attempts` times. Returns (summary, what run_calls
    returned in the window kept). Raises RuntimeError when every window is
    incomplete. The trace goes through a gzip file in TMPDIR, deleted after."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    dropped = 0
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            with record_function(WINDOW):
                out = run_calls()
                torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json.gz")
            t0 = time.perf_counter()
            prof.export_chrome_trace(path)
            with gzip.open(path, "rt") as f:
                trace = json.load(f)
        events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
        missing = missing_kernels(events)
        if missing == 0:
            summary = summarize(trace)
            print(f"trace: kept a complete window after dropping {dropped} "
                  f"({summary.kernels} kernels, {summary.launches} launches, read in "
                  f"{time.perf_counter() - t0:.1f} s)", file=log, flush=True)
            return summary, out
        dropped += 1
        print(f"trace: dropped an incomplete window ({missing} launches without their "
              "kernel record)", file=log, flush=True)
    raise RuntimeError(f"trace: all {attempts} windows incomplete; no per-layer metric is read")
