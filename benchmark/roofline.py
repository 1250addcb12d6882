"""The table of peaks (peaks.json) and the least time a piece of work can
take on one card: the larger of its operations at the peak rate and its
bytes at the HBM rate, each input byte read once and each output byte
written once. Copied from the program's chip_smoke.py:bound, in seconds."""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def bound_s(nbytes: float, flops: float, peak_flops: float = PEAKS["bf16_flops"]) -> float:
    return max(nbytes / PEAKS["hbm_bytes_per_s"], flops / peak_flops)


def share_pct(bound: float, seconds: float) -> float | None:
    """bound / seconds in percent; None where the kernel took no time (it
    did not run in the window)."""
    return 100.0 * bound / seconds if seconds > 0 else None
