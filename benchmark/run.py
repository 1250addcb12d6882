"""Runs one cell of the benchmark once, in this process, on this machine.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up (the kernels' build on a checkout's first run included), warms up,
measures for `--seconds` (with --trace 1: a profiled window of the cell's
`trace_calls` calls instead), checks the answers of the window against the
plain reference, and prints one JSON line last on standard output:
correct, attempted, failed, metrics (the cell's end-to-end metrics, or
with --trace 1 its per-layer ones), device, breakdown (traced runs) and the
numbers compared beside their limits. Those numbers are also the last lines
on standard error.

Exits non-zero, printing no result, without enough CUDA devices for the
cell, or if jax, jaxlib, flax, optax or the JAX package is loaded once the
window has closed.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

from benchmark import harness  # the standard library only: torch comes later

CLOCK = harness.Clock()  # setup_s counts from the process's start


def _card_note() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable: {e}"
    return out.replace("\n", "; ")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)  # load from one process with few threads
    device = torch.device("cuda", 0)
    driver = harness.load_driver(cell.driver)
    outcome = driver.run(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                         device=device, clock=CLOCK)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    line = harness.result_line(cell, outcome, trace=bool(args.trace), device={
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips})
    print(f"card: {_card_note()}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
