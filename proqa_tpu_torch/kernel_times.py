"""Times kernels K1 and K4 of a checkout of the port on one NVIDIA GPU, and
the host path of one K4 call piece by piece.

    python proqa_tpu_torch/kernel_times.py [--root DIR] [--out FILE]

--root is the checkout whose `proqa_tpu_torch` is imported (default: the one
this file lies in), so that one command can time an older checkout with the
same yardstick: run it on two checkouts in turns (A, B, B, A) in one call to
the card. Only functions both checkouts share are called.

Device times are CUDA events around one call ("one call": the host path is
included, as the card sits idle until the launch) and around 10
back-to-back calls divided by 10 ("queued": the device time alone), medians
of repeated rounds:
  K1  block_maxima_grouped, bf16, 4,194,304 x 128 corpus, block 16, group
      128, at Q = 2,048 and Q = 32;
  K4  dropout at [80, 512, 768] bf16, rate 0.1, beside F.dropout.
Host pieces of K4 (time.perf_counter_ns, mean over 1,000 calls, median of
5 rounds, on a [80, 768] bf16 tensor so that the card keeps up): each step
the earlier dropout wrapper took (an autograd node always, the rate checked
twice, keys in Python, a device switch, a torch.cuda.Stream), and the whole
call of this checkout's wrapper with and without autograd, beside
F.dropout's whole call.

Prints one JSON object, with the card's name and power limit; exits non-zero
without a CUDA device.
"""
from __future__ import annotations

import argparse
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--out", default=None, help="also write the JSON object here")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    from proqa_tpu_torch.ops import dropout, mips_kernel

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(4)
    corpus = (torch.randn(4_194_304, 128, device=dev, generator=g) / 128 ** 0.5).bfloat16()
    queries = (torch.randn(2048, 128, device=dev, generator=g) / 128 ** 0.5).bfloat16()
    out = {"gpu": gpu, "root": os.path.abspath(args.root)}
    for q in (2048, 32):
        qs = queries[:q].contiguous()
        fn = lambda: mips_kernel.block_maxima_grouped(qs, corpus, block=16)  # noqa: E731
        out[f"K1 Q={q} one call ms"] = _events_ms(fn, 1, 5)
        out[f"K1 Q={q} queued ms"] = _events_ms(fn, 10, 3)
    del corpus, queries
    x = torch.randn(80, 512, 768, device=dev, generator=g).bfloat16()
    for name, fn in (("K4", lambda: dropout.dropout(x, 0.1, seed=3)),
                     ("F.dropout", lambda: F.dropout(x, 0.1, training=True))):
        out[f"{name} one call ms"] = _events_ms(fn, 1, 20)
        out[f"{name} queued ms"] = _events_ms(fn, 10, 5)
    out["K4 host pieces us"] = host_pieces(
        torch.randn(80, 768, device=dev, generator=g).bfloat16())
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
