"""Times kernels K1, K5, K6, K7, K8, K4, F1 and F2 (and their backward), K2
and K3 of a checkout of the port on one NVIDIA GPU, and the host path of one
K4 call piece by piece.

    python proqa_tpu_torch/kernel_times.py [--root DIR] [--out FILE] [--only K6,K1]

--root is the checkout whose `proqa_tpu_torch` is imported (default: the one
this file lies in), so that one command can time an older checkout with the
same yardstick: run it on two checkouts in turns (A, B, B, A) in one call to
the card. Only functions both checkouts share are called.

Device times are CUDA events around one call ("one call": the host path is
included, as the card sits idle until the launch) and around 10
back-to-back calls divided by 10 ("queued": the device time alone where the
host keeps ahead), medians of repeated rounds; beside them the kernels'
own time in torch.profiler traces of one call ("kernel ms": the median of
three traces that hold every kernel, "kernel traces": [those counted, those
taken], since the profiler drops kernel records) and the host time of a call
while the card keeps up ("host us", 20 calls a round):
  K1  block_maxima_grouped, bf16, 4,194,304 x 128 corpus, block 16, group
      128, at Q = 2,048 and Q = 32;
  K8  block_maxima (block-major), the same corpus, Q = 2,048, block 256,
      tile_n 2,048;
  K6  gather_rescore (K9 runs the same kernel): the same corpus's candidate
      blocks that the K1 pipeline selects, Q = 2,048, k = kb = 80, block 16,
      and at mips_topk_v1's shape, its top-128 blocks of 256 rows for the
      first 256 queries (its query chunk); then the block-16 candidates over
      an f32 corpus;
  K1 f32  block_maxima_grouped over a 4,194,304 x 128 f32 corpus and f32
      queries, block 16, group 128, at Q = 2,048 and Q = 32;
  K5  the same over 4,194,304 x 128 int8 codes with per-block scales, at
      Q = 2,048 and Q = 32;
  K7  the same codes with the bounds (smax, smin) of per-row scales, at
      Q = 2,048;
  K1, K1 f32, K5, K7, K8, K6 at D = 768  the K-loop forms at DPR's width
      over 1,048,576 rows, beside their plain versions, the take path (K6)
      and their bounds (`width_times`; checkouts whose kernels take D = 128
      alone skip them);
  K4  dropout at [80, 512, 768] bf16, rate 0.1, beside F.dropout;
  F1  the dense epilogue at the encode's shapes (build-index's 512 rows of
      T = 512: 262,144 rows), an f32 product of [262,144, 768] to bf16 and
      of [262,144, 3,072] with GELU to bf16;
  F2  residual add + LayerNorm at [262,144, 768] bf16, with and without the
      residual, beside F.layer_norm on the same rows (checkouts without
      ops/fused_bert.py skip F1 and F2);
  F1, F2 backward  at the retriever train step's 40,960 context rows, the
      QA train step's 10,240 reader rows, and the question rows of the
      retriever step (2,560) and of the QA step (120), bf16: F1's with GELU at
      [N, 3,072] beside aten::gelu_backward, F1's bias column sum alone at
      [N, 768] beside torch.sum(dim=0), F2's with a residual at [N, 768]
      beside aten::native_layer_norm_backward (checkouts without the
      backward kernels skip them); the outputs of these calls, and of F2 at
      [262,144, 1,024] (the widest warp form), as SHA-256 digests ("digest");
  F1, F2 wide  the forms past 12,288 columns and past width 1,024
      (`wide_times`: BERT-xlarge's and ALBERT-xxlarge's widths, each beside
      its plain version, a library call and its bound; checkouts without
      fused_bert.layer_norm_form skip them);
  K2, K3  fused attention forward and backward, bf16, random key padding
      with one all-padding row, at rates 0.1 and 0, beside
      F.scaled_dot_product_attention and its backward at rate 0 (the
      yardstick; the port never calls it), each with its bound by
      chip_smoke.py:bound ("bound ms", "bound by"): Dh = 32 at [512, 12,
      512, 32] (MiniLM's encode) and [80, 12, 512, 32] (its train step),
      Dh = 128 at [64, 8, 512, 128], Dh = 64 at [80, 12, 512, 64]
      (BERT-base's train step) and Dh = 16 at [80, 12, 512, 16]; past 128,
      Dh = 256 at [512, 3, 512, 256] and [80, 3, 512, 256] (BERT-base's
      widths with 3 heads of 256: its encode and train step) and the loop
      forms at [64, 2, 512, 384] and [64, 1, 512, 768]; each shape's inputs
      come from a generator seeded by the shape, and each call's outputs are
      recorded as a SHA-256 digest ("digest"), so two checkouts' kernels can
      be held bit for bit; a checkout whose kernels lack a head dim
      (attention.kernel_head_dim raises for it) skips its shapes.
Host pieces of K4 (time.perf_counter_ns, mean over 1,000 calls, median of
5 rounds, on a [80, 768] bf16 tensor so that the card keeps up): each step
the earlier dropout wrapper took (an autograd node always, the rate checked
twice, keys in Python, a device switch, a torch.cuda.Stream), and the whole
call of this checkout's wrapper with and without autograd, beside
F.dropout's whole call.

Each kernel's CUDA kernel names are read from a torch.profiler trace of one
more call ("kernels"), so the record shows which body ran. --only times the
kernels whose names start with one of the given prefixes (and skips K4's
host pieces unless K4 is among them). Prints one JSON object, with the
card's name and power limit; exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time


def _events_ms(fn, calls: int, rounds: int) -> float:
    import torch

    fn()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _kernel_trace(fn, reps: int = 3, tries: int = 40) -> tuple[list[str], float | None, list]:
    """The names of the GPU kernels one call of fn launches, their summed
    device time in ms (torch.profiler's kernel events) and [traces counted,
    traces taken]. torch.profiler loses most kernel records on the H100
    machine (chip_smoke.kernel_ms), so a trace counts only if it holds as
    many kernels as the fullest trace seen: up to `tries` traces, until
    `reps` count; the time is their median (None if no trace held one)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    traces = []  # the kernel events of each trace
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        traces.append([e for e in events if e.get("cat") == "kernel"])
        most = max(map(len, traces))
        full = [t for t in traces if len(t) == most and most > 0]
        if len(full) >= reps:
            break
    if not full:
        return [], None, [0, len(traces)]
    ms = statistics.median(sum(e.get("dur", 0.0) for e in t) / 1e3 for t in full)
    return sorted({e["name"] for e in full[0]}), ms, [len(full), len(traces)]


def _host_us(fn, calls: int = 1000, rounds: int = 5) -> float:
    import torch

    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(rounds):
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            fn()
        means.append((time.perf_counter_ns() - t0) / calls / 1e3)
        torch.cuda.synchronize()
    return statistics.median(means)


def host_pieces(x) -> dict:
    """The host time of each piece of one K4 call, in microseconds."""
    import torch
    import torch.nn.functional as F

    from proqa_tpu_torch import _build
    from proqa_tpu_torch.ops import dropout, random

    lib = _build.library()
    y = torch.empty_like(x)
    k0, k1 = random.keys(3, 0)
    thr, stream = random.threshold(0.1), torch.cuda.current_stream().cuda_stream

    # the earlier entry point took the keys (9 arguments); the later the seed
    keys = (k0, k1) if len(lib.proqa_dropout.argtypes) == 9 else (3,)

    def ctypes_call():
        _build.check(lib.proqa_dropout(x.data_ptr(), y.data_ptr(), x.numel(), *keys, thr,
                                       1.0 / 0.9, 1, stream), "dropout")

    def device_switch():
        with torch.cuda.device(x.device):
            pass

    class Identity(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t

        @staticmethod
        def backward(ctx, g):
            return g

    xg = x.clone().requires_grad_(True)
    pieces = {
        "autograd.Function.apply (identity)": lambda: Identity.apply(x),
        "random.threshold": lambda: random.threshold(0.1),
        "random.keys": lambda: random.keys(3, 0),
        "torch.empty_like": lambda: torch.empty_like(x),
        "with torch.cuda.device": device_switch,
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "torch._C._cuda_getCurrentRawStream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "ctypes call and check (launch included)": ctypes_call,
        "whole call, no gradient": lambda: dropout.dropout(x, 0.1, seed=3),
        "whole call, x requires grad": lambda: dropout.dropout(xg, 0.1, seed=3),
        "F.dropout whole call": lambda: F.dropout(x, 0.1, training=True),
    }
    return {name: _host_us(fn) for name, fn in pieces.items()}


def backward_times(time_kernel, digest, fused_bert, dev, g) -> None:
    """F1's and F2's backward kernels at the retriever train step's context
    rows (80 x 512), the QA train step's reader rows (4 x 5 x 512), the
    retriever step's question rows (80 x 32) and the QA step's (4 x 30),
    bf16, beside one library call each."""
    for n in (80 * 512, 4 * 5 * 512, 80 * 32, 4 * 30):
        _backward_times(time_kernel, digest, fused_bert, dev, g, n)


def _backward_times(time_kernel, digest, fused_bert, dev, g, n) -> None:
    import torch

    h = 768
    for cols, gelu in ((4 * h, True), (h, False)):
        dout = torch.randn(n, cols, device=dev, generator=g).bfloat16()
        z = (torch.randn(n, cols, device=dev, generator=g) * 2.0).bfloat16() if gelu else None
        name = f"F1 backward [{n}, {cols}]{' GELU' if gelu else ''} bf16"
        time_kernel(name, lambda: fused_bert._dense_epilogue_backward_kernel(dout, z, gelu, True,
                                                                             True))
        digest(name, lambda: fused_bert._dense_epilogue_backward_kernel(dout, z, gelu, True,
                                                                        True))
        if gelu:
            time_kernel(f"aten::gelu_backward [{n}, {cols}] bf16",
                        lambda: torch.ops.aten.gelu_backward(dout, z, approximate="none"))
        else:
            time_kernel(f"torch.sum(dim=0) [{n}, {cols}] bf16",
                        lambda: torch.sum(dout, dim=0, dtype=torch.float32))
        del dout, z
    x, r, dy = (torch.randn(n, h, device=dev, generator=g).bfloat16() for _ in range(3))
    scale, bias = torch.ones(h, device=dev), torch.zeros(h, device=dev)
    _, mean, rstd = fused_bert._add_layer_norm_kernel(x, r, scale, bias, 1e-12, save_stats=True)
    name = f"F2 backward [{n}, {h}] bf16 + residual"
    time_kernel(name, lambda: fused_bert._add_layer_norm_backward_kernel(dy, x, r, mean, rstd,
                                                                         scale, True, True))
    digest(name, lambda: fused_bert._add_layer_norm_backward_kernel(dy, x, r, mean, rstd, scale,
                                                                    True, True))
    s, sc, bi = x + r, scale.bfloat16(), bias.bfloat16()
    _, a_mean, a_rstd = torch.ops.aten.native_layer_norm(s, [h], sc, bi, 1e-12)
    time_kernel(f"aten::native_layer_norm_backward [{n}, {h}] bf16",
                lambda: torch.ops.aten.native_layer_norm_backward(
                    dy, s, [h], a_mean, a_rstd, sc, bi, [True, True, True]))


def _smoke():
    """chip_smoke.py of the checkout this file lies in, for its `bound`."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def wide_times(time_kernel, fused_bert, dev, g, out) -> None:
    """F1's and F2's forms past their first widths (BERT-xlarge's 2,048 and
    8,192, ALBERT-xxlarge's 4,096 and 16,384), each beside its plain version
    ("plain ..."), one library call and its bound ("... bound ms", "... bound
    by"): F2 at [131,072, 2,048] and [65,536, 4,096] bf16 with a residual
    and in f32, and the stream form at [8,192, 32,768] bf16 (beside
    F.layer_norm without the residual); F1 at [131,072, 2,048] (beside
    torch.add into bf16), [131,072, 8,192] and [32,768, 16,384] with GELU
    (the first on the staged form, the last on the wide one); the backward
    kernels at the BERT-xlarge train step's rows (80 x 512 context rows, 80
    x 32 question rows): F2's with a residual at [N, 2,048] beside
    aten::native_layer_norm_backward, F1's with GELU at [N, 8,192] beside
    aten::gelu_backward, and at the xxlarge tower's [32,768, 16,384]."""
    import torch

    smoke = _smoke()
    for n, h, dt in ((131_072, 2048, torch.bfloat16), (65_536, 4096, torch.bfloat16),
                     (131_072, 2048, torch.float32), (65_536, 4096, torch.float32),
                     (8192, 32_768, torch.bfloat16)):
        x, r = (torch.randn(n, h, device=dev, generator=g).to(dt) for _ in range(2))
        scale, bias = torch.ones(h, device=dev), torch.zeros(h, device=dev)
        shape = f"[{n}, {h}] {str(dt)[6:]}"
        time_kernel(f"F2 {shape} + residual",
                    lambda: fused_bert.add_layer_norm(x, r, scale, bias, 1e-12))
        time_kernel(f"plain F2 {shape} + residual",
                    lambda: fused_bert.add_layer_norm_reference(x, r, scale, bias, 1e-12))
        sc, bi = scale.to(dt), bias.to(dt)
        time_kernel(f"F.layer_norm {shape}",
                    lambda: torch.nn.functional.layer_norm(x, (h,), sc, bi, 1e-12))
        out[f"F2 {shape} + residual bound ms"], out[f"F2 {shape} + residual bound by"] = \
            smoke.bound(3 * n * h * dt.itemsize + 2 * h * 4, 10 * n * h, smoke.PEAK_F32_FLOPS)
        del x, r
    for n, cols, gelu in ((131_072, 2048, False), (131_072, 8192, True), (32_768, 16_384, True)):
        y = torch.randn(n, cols, device=dev, generator=g) * 2.0
        b = torch.randn(cols, device=dev, generator=g) * 0.1
        shape = f"[{n}, {cols}]{' GELU' if gelu else ''} bf16"
        time_kernel(f"F1 {shape}", lambda: fused_bert.dense_epilogue(y, b, torch.bfloat16, gelu))
        time_kernel(f"plain F1 {shape}",
                    lambda: fused_bert.dense_epilogue_reference(y, b, torch.bfloat16, gelu))
        if not gelu:
            o = torch.empty(n, cols, device=dev, dtype=torch.bfloat16)
            time_kernel(f"torch.add [{n}, {cols}] bf16", lambda: torch.add(y, b, out=o))
            del o
        out[f"F1 {shape} bound ms"], out[f"F1 {shape} bound by"] = smoke.bound(
            n * cols * 6 + cols * 4, n * cols * (25 if gelu else 1), smoke.PEAK_F32_FLOPS)
        del y
    h = 2048
    for n in (80 * 512, 80 * 32):
        x, r, dy = (torch.randn(n, h, device=dev, generator=g).bfloat16() for _ in range(3))
        scale, bias = torch.ones(h, device=dev), torch.zeros(h, device=dev)
        _, mean, rstd = fused_bert._add_layer_norm_kernel(x, r, scale, bias, 1e-12,
                                                          save_stats=True)
        shape = f"[{n}, {h}] bf16"
        time_kernel(f"F2 backward {shape} + residual",
                    lambda: fused_bert._add_layer_norm_backward_kernel(dy, x, r, mean, rstd,
                                                                       scale, True, True))
        time_kernel(f"plain F2 backward {shape} + residual",
                    lambda: fused_bert.add_layer_norm_backward_reference(dy, x, r, mean, rstd,
                                                                         scale))
        s, sc, bi = x + r, scale.bfloat16(), bias.bfloat16()
        _, a_mean, a_rstd = torch.ops.aten.native_layer_norm(s, [h], sc, bi, 1e-12)
        time_kernel(f"aten::native_layer_norm_backward {shape}",
                    lambda: torch.ops.aten.native_layer_norm_backward(
                        dy, s, [h], a_mean, a_rstd, sc, bi, [True, True, True]))
        out[f"F2 backward {shape} + residual bound ms"], \
            out[f"F2 backward {shape} + residual bound by"] = smoke.bound(
                n * h * 2 * 4 + n * 8 + h * 4 + 2 * h * 4, n * h * 12, smoke.PEAK_F32_FLOPS)
        del x, r, dy, s
    for n, cols in ((80 * 512, 8192), (80 * 32, 8192), (32_768, 16_384)):
        dout = torch.randn(n, cols, device=dev, generator=g).bfloat16()
        z = (torch.randn(n, cols, device=dev, generator=g) * 2.0).bfloat16()
        shape = f"[{n}, {cols}] GELU bf16"
        time_kernel(f"F1 backward {shape}",
                    lambda: fused_bert._dense_epilogue_backward_kernel(dout, z, True, True, True))
        time_kernel(f"plain F1 backward {shape}",
                    lambda: fused_bert.dense_epilogue_backward_reference(dout, z, True))
        time_kernel(f"aten::gelu_backward [{n}, {cols}] bf16",
                    lambda: torch.ops.aten.gelu_backward(dout, z, approximate="none"))
        out[f"F1 backward {shape} bound ms"], out[f"F1 backward {shape} bound by"] = \
            smoke.bound(n * cols * 6 + cols * 4, 0)
        del dout, z
    torch.cuda.empty_cache()


WIDTH = 768          # DPR's embedding width (and ANCE's, Contriever's, GTR-base's)
WIDTH_ROWS = 1_048_576


def width_times(time_kernel, mips_kernel, rescore, dev, g, out) -> None:
    """The search kernels' K-loop forms at D = 768 over 1,048,576 rows, each
    beside its plain version ("plain ...") and its bound ("... bound ms",
    "... bound by", chip_smoke.py:bound): K1 over bf16 at Q = 2,048 and 32
    and over f32 at Q = 2,048 (the f32 FMA rate), block 16; K5 and K7 over
    int8 codes at Q = 2,048, block 16; K8 block-major at block 256, tile_n
    2,048; K6 on the candidate blocks the K1 pipeline selects (Q = 2,048,
    k = kb = 80) at block 16, beside the take path (the gather and one
    batched product), and at block 64 (the 21M-row search's block). The
    plain versions run 128 groups at a time (their [Q, N] f32 scores would
    not fit) and are timed as the sum of their parts. Checkouts whose
    kernels take D = 128 alone skip this."""
    import torch

    from proqa_tpu_torch.ops import mips
    from proqa_tpu_torch.ops.dot import dot_f32

    smoke = _smoke()
    n, d, q = WIDTH_ROWS, WIDTH, 2048

    def plain_grouped(name, queries, corpus, block, **kw):
        def run():
            for r0 in range(0, n, 128 * block * 16):
                sl = slice(r0 // block, (r0 + 128 * block * 16) // block)
                part = {k: tuple(x[sl] for x in v) if isinstance(v, tuple) else v[sl]
                        for k, v in kw.items()}
                mips_kernel.block_maxima_grouped_reference(
                    queries, corpus[r0:r0 + 128 * block * 16], block=block, **part)
        time_kernel(f"plain {name}", run, rounds=3, queued_rounds=1)

    def bound(name, queries, corpus, outputs, peak=smoke.PEAK_BF16_FLOPS, extra=0):
        nbytes = (corpus.numel() * corpus.element_size()
                  + queries.numel() * queries.element_size() + extra
                  + sum(o.numel() * o.element_size() for o in outputs))
        out[f"{name} bound ms"], out[f"{name} bound by"] = smoke.bound(
            nbytes, 2.0 * queries.shape[0] * corpus.shape[0] * d, peak)

    corpus = (torch.randn(n, d, device=dev, generator=g) / d ** 0.5).bfloat16()
    queries = (torch.randn(q, d, device=dev, generator=g) / d ** 0.5).bfloat16()
    for qn in (2048, 32):
        qs = queries[:qn].contiguous()
        name = f"K1 D={d} Q={qn}"
        time_kernel(name, lambda: mips_kernel.block_maxima_grouped(qs, corpus, block=16))
        plain_grouped(name, qs, corpus, 16)
        bound(name, qs, corpus, mips_kernel.block_maxima_grouped(qs, corpus, block=16))
    name = f"K8 D={d} Q={q}"
    time_kernel(name, lambda: mips_kernel.block_maxima(queries, corpus, block=256, tile_n=2048))
    time_kernel(f"plain {name}", lambda: [
        mips_kernel.block_maxima_reference(queries, corpus[r0:r0 + 65536], block=256,
                                           tile_n=2048) for r0 in range(0, n, 65536)],
        rounds=3, queued_rounds=1)
    bound(name, queries, corpus, (mips_kernel.block_maxima(queries, corpus, block=256,
                                                           tile_n=2048),))
    for block in (16, 64):
        ids = mips_kernel.select_blocks(queries, corpus, 80, block=block)
        blocks = corpus.view(-1, block, d)
        name = f"K6 D={d} Q={q} kb=80 block={block}"
        time_kernel(name, lambda: rescore.gather_rescore(queries, blocks, ids, block=block),
                    rounds=10)
        distinct = torch.unique(ids).numel() * block * d * 2
        out[f"{name} bound ms"], out[f"{name} bound by"] = smoke.bound(
            distinct + q * d * 2 + q * 80 * block * 4 + ids.numel() * 8, 2.0 * q * 80 * block * d)
        if block == 16:
            time_kernel(f"take {name}", lambda: dot_f32(
                blocks[ids].view(q, 80 * block, d), queries[:, :, None]).view(q, -1), rounds=5)
            time_kernel(f"plain {name}", lambda: torch.cat([
                rescore.gather_rescore_reference(queries[s:s + 256], blocks, ids[s:s + 256],
                                                 block=block) for s in range(0, q, 256)]),
                rounds=3, queued_rounds=1)
        del ids
    del corpus
    corpus = torch.randn(n, d, device=dev, generator=g) / d ** 0.5
    qf = torch.randn(q, d, device=dev, generator=g) / d ** 0.5
    name = f"K1 f32 D={d} Q={q}"
    time_kernel(name, lambda: mips_kernel.block_maxima_grouped(qf, corpus, block=16), rounds=3)
    plain_grouped(name, qf, corpus, 16)
    bound(name, qf, corpus, mips_kernel.block_maxima_grouped(qf, corpus, block=16),
          smoke.PEAK_F32_FLOPS)
    del corpus, qf
    codes = torch.randint(-127, 128, (n, d), device=dev, generator=g, dtype=torch.int8)
    scales = torch.rand(n // 16, device=dev, generator=g) * 0.02 + 1e-3
    rows = (torch.rand(n, device=dev, generator=g) * 0.02 + 1e-3).view(-1, 16)
    bounds = (rows.amax(dim=1), rows.amin(dim=1))
    for name, kw in ((f"K5 D={d} Q={q}", {"scales": scales}),
                     (f"K7 D={d} Q={q}", {"scale_bounds": bounds})):
        time_kernel(name, lambda: mips_kernel.block_maxima_grouped(queries, codes, block=16,
                                                                   **kw))
        plain_grouped(name, queries, codes, 16, **kw)
        bound(name, queries, codes,
              mips_kernel.block_maxima_grouped(queries, codes, block=16, **kw),
              extra=scales.numel() * 4 * (1 if "scales" in kw else 2))
    del codes, scales, rows, bounds, queries
    torch.cuda.empty_cache()


ATTENTION_SHAPES = ((512, 12, 512, 32), (80, 12, 512, 32), (64, 8, 512, 128), (80, 12, 512, 64),
                    (80, 12, 512, 16), (512, 3, 512, 256), (80, 3, 512, 256), (64, 2, 512, 384),
                    (64, 1, 512, 768))


def _digest(tensors) -> str:
    """SHA-256 of the tensors' bytes, in order."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for x in tensors:
        h.update(x.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def attention_times(time_kernel, attention, dev, out) -> None:
    """K2 and K3 at ATTENTION_SHAPES, rates 0.1 and 0, beside SDPA and its
    backward, each shape's bounds, and the digests of the kernels' outputs."""
    import torch
    import torch.nn.functional as F

    smoke = _smoke()
    seed = 2**50 + 3
    for b, h, t, dh in ATTENTION_SHAPES:
        try:
            attention.kernel_head_dim(dh)
        except ValueError:  # a checkout from before this head dim ran on the card
            continue
        g = torch.Generator(device=dev).manual_seed(b * h * t + dh)
        q, k, v, do = (torch.randn(b, h, t, dh, device=dev, generator=g).bfloat16()
                       for _ in range(4))
        lengths = torch.randint(1, t + 1, (b,), device=dev, generator=g)
        lengths[0] = 0  # one all-padding row
        mask = (torch.arange(t, device=dev)[None] < lengths[:, None]).to(torch.int32)
        bias = torch.where(mask[:, None, None, :] != 0, 0.0, attention.MASK_BIAS).to(q.dtype)
        scale, shape = dh ** -0.5, f"[{b}, {h}, {t}, {dh}]"
        for rate in (0.1, 0.0):
            calls = {"K2": lambda: (attention.fused_attention(
                         q, k, v, mask, sm_scale=scale, dropout_rate=rate, seed=seed),),
                     "K3": lambda: attention._backward_kernel(q, k, v, mask, do, scale, rate,
                                                              seed)}
            for name, fn in calls.items():
                time_kernel(f"{name} {shape} rate {rate}", fn)
                out[f"{name} {shape} rate {rate} digest"] = _digest(fn())
        time_kernel(f"SDPA {shape}",
                    lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias))
        qs, ks, vs = (x.clone().requires_grad_(True) for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bias)
        time_kernel(f"SDPA backward {shape}", lambda: torch.autograd.grad(
            lib_out, (qs, ks, vs), do, retain_graph=True))
        n = b * h * t * dh * 2  # bytes of one bf16 [B, H, T, Dh] tensor
        for name, tensors, flops in (("K2", 4, 4), ("K3", 7, 10)):
            out[f"{name} {shape} bound ms"], out[f"{name} {shape} bound by"] = smoke.bound(
                tensors * n + mask.numel() * 4, flops * b * h * t * t * dh)
        del q, k, v, do, mask, bias, qs, ks, vs, lib_out
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--out", default=None, help="also write the JSON object here")
    ap.add_argument("--only", default="", help="comma-separated kernel name prefixes")
    args = ap.parse_args(argv)
    only = tuple(p for p in args.only.split(",") if p)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    from proqa_tpu_torch.ops import attention, dropout, mips_kernel, rescore

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(4)
    out = {"gpu": gpu, "root": os.path.abspath(args.root), "kernels": {}}

    def wanted(*names):  # whether --only selects any kernel of a section
        return not only or any(n.startswith(p) or p.startswith(n) for n in names for p in only)

    def time_kernel(name, fn, rounds=5, queued_rounds=3):
        if only and not name.startswith(only):
            return
        out[f"{name} one call ms"] = _events_ms(fn, 1, rounds)
        out[f"{name} queued ms"] = _events_ms(fn, 10, queued_rounds)
        (out["kernels"][name], out[f"{name} kernel ms"],
         out[f"{name} kernel traces"]) = _kernel_trace(fn)
        out[f"{name} host us"] = _host_us(fn, calls=20)

    def digest(name, fn):  # the outputs' SHA-256, to hold two checkouts bit for bit
        if not only or name.startswith(only):
            out[f"{name} digest"] = _digest(t for t in fn() if t is not None)

    if wanted("K1", "K8", "K6", "K5", "K7"):
        corpus = (torch.randn(4_194_304, 128, device=dev, generator=g) / 128 ** 0.5).bfloat16()
        queries = (torch.randn(2048, 128, device=dev, generator=g) / 128 ** 0.5).bfloat16()
        for q in (2048, 32):
            qs = queries[:q].contiguous()
            time_kernel(f"K1 Q={q}", lambda: mips_kernel.block_maxima_grouped(qs, corpus, block=16))
        time_kernel("K8 Q=2048", lambda: mips_kernel.block_maxima(queries, corpus, block=256,
                                                                  tile_n=2048))
        ids = mips_kernel.select_blocks(queries, corpus, 80, block=16)
        blocks = corpus.view(-1, 16, 128)
        time_kernel("K6 Q=2048 kb=80 block=16",
                    lambda: rescore.gather_rescore(queries, blocks, ids, block=16), rounds=20)
        q256 = queries[:256].contiguous()
        ids256 = torch.topk(mips_kernel.block_maxima(q256, corpus, block=256, tile_n=2048).T,
                            128).indices
        blocks256 = corpus.view(-1, 256, 128)
        time_kernel("K6 Q=256 kb=128 block=256",
                    lambda: rescore.gather_rescore(q256, blocks256, ids256, block=256), rounds=20)
        del corpus, blocks, blocks256
        corpus = torch.randn(4_194_304, 128, device=dev, generator=g) / 128 ** 0.5
        queries_f32 = torch.randn(2048, 128, device=dev, generator=g) / 128 ** 0.5
        for q in (2048, 32):
            qs = queries_f32[:q].contiguous()
            time_kernel(f"K1 f32 Q={q}",
                        lambda: mips_kernel.block_maxima_grouped(qs, corpus, block=16))
        blocks = corpus.view(-1, 16, 128)
        time_kernel("K6 f32 Q=2048 kb=80 block=16",
                    lambda: rescore.gather_rescore(queries_f32, blocks, ids, block=16), rounds=20)
        del corpus, queries_f32, blocks, ids
        # int8 codes and scales made on the device (uniform codes in [-127, 127])
        codes = torch.randint(-127, 128, (4_194_304, 128), device=dev, generator=g,
                              dtype=torch.int8)
        scales = torch.rand(4_194_304 // 16, device=dev, generator=g) * 0.02 + 1e-3
        rows = (torch.rand(4_194_304, device=dev, generator=g) * 0.02 + 1e-3).view(-1, 16)
        bounds = (rows.amax(dim=1), rows.amin(dim=1))
        for name, q, kw in (("K5", 2048, {"scales": scales}), ("K5", 32, {"scales": scales}),
                            ("K7", 2048, {"scale_bounds": bounds})):
            qs = queries[:q].contiguous()
            time_kernel(f"{name} Q={q}",
                        lambda: mips_kernel.block_maxima_grouped(qs, codes, block=16, **kw))
        del codes, scales, rows, bounds, queries
    if wanted("K1 D=", "K1 f32 D=", "K5 D=", "K7 D=", "K8 D=", "K6 D=") and getattr(
            mips_kernel, "kernel_takes_dim", lambda d: False)(WIDTH):
        width_times(time_kernel, mips_kernel, rescore, dev, g, out)
    if wanted("K4", "F.dropout"):
        x = torch.randn(80, 512, 768, device=dev, generator=g).bfloat16()
        for name, fn in (("K4", lambda: dropout.dropout(x, 0.1, seed=3)),
                         ("F.dropout", lambda: F.dropout(x, 0.1, training=True))):
            time_kernel(name, fn, rounds=20, queued_rounds=5)
        if not only or "K4".startswith(only):
            out["K4 host pieces us"] = host_pieces(
                torch.randn(80, 768, device=dev, generator=g).bfloat16())
        del x
    if wanted("F1", "F2", "F.layer_norm", "aten::", "torch.sum") and importlib.util.find_spec(
            "proqa_tpu_torch.ops.fused_bert") is not None:
        from proqa_tpu_torch.ops import fused_bert

        n, h = 512 * 512, 768
        for cols, gelu in ((h, False), (4 * h, True)):
            y = torch.randn(n, cols, device=dev, generator=g) * 2.0
            b = torch.randn(cols, device=dev, generator=g) * 0.1
            name = f"F1 [{n}, {cols}]{' GELU' if gelu else ''} bf16"
            time_kernel(name, lambda: fused_bert.dense_epilogue(y, b, torch.bfloat16, gelu))
            digest(name, lambda: (fused_bert.dense_epilogue(y, b, torch.bfloat16, gelu),))
            del y
        x, r = (torch.randn(n, h, device=dev, generator=g).bfloat16() for _ in range(2))
        scale, bias = torch.ones(h, device=dev), torch.zeros(h, device=dev)
        for res, label in ((r, " + residual"), (None, "")):
            name = f"F2 [{n}, {h}] bf16{label}"
            time_kernel(name, lambda: fused_bert.add_layer_norm(x, res, scale, bias, 1e-12))
            digest(name, lambda: (fused_bert.add_layer_norm(x, res, scale, bias, 1e-12),))
        scale16, bias16 = scale.bfloat16(), bias.bfloat16()
        time_kernel(f"F.layer_norm [{n}, {h}] bf16",
                    lambda: torch.nn.functional.layer_norm(x, (h,), scale16, bias16, 1e-12))
        del x, r
        # the widest row the warp form takes
        x, r = (torch.randn(n, 1024, device=dev, generator=g).bfloat16() for _ in range(2))
        scale, bias = torch.ones(1024, device=dev), torch.zeros(1024, device=dev)
        name = f"F2 [{n}, 1024] bf16 + residual"
        time_kernel(name, lambda: fused_bert.add_layer_norm(x, r, scale, bias, 1e-12))
        digest(name, lambda: (fused_bert.add_layer_norm(x, r, scale, bias, 1e-12),))
        del x, r
        if hasattr(fused_bert, "_dense_epilogue_backward_kernel"):
            backward_times(time_kernel, digest, fused_bert, dev, g)
        if hasattr(fused_bert, "layer_norm_form"):
            wide_times(time_kernel, fused_bert, dev, g, out)
    if wanted("K2", "K3", "SDPA"):
        attention_times(time_kernel, attention, dev, out)
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
