"""The control of a cell's correctness comparison, at the cell's own size:
the reference put in the program's place one precision step below what the
configuration states, compared as a run's answers are. Its readings set the
upper end of each limit (PERF.md gives them); a sound limit lies below them.

    python -m benchmark.control --workload <cell> --seeds 11,12,13

Prints one JSON line a seed, then one with the smallest reading of each
number. Needs a CUDA device, as a run does.
"""
from __future__ import annotations

import argparse
import json
import sys

from benchmark import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    driver = harness.load_driver(cell.driver)
    least: dict = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        got = driver.control(cell, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": cell.name, "seed": seed, "control": got}), flush=True)
        least = {k: min(v, least.get(k, v)) for k, v in got.items()}
        torch.cuda.empty_cache()
    print(json.dumps({"workload": cell.name, "control_least": least,
                      "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
