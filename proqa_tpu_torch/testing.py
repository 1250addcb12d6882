"""Helpers that hold one top-k search result against another, for the tests
and chip_smoke.py."""
from __future__ import annotations

import numpy as np


def topk_disagreements(va, ia, vb, ib, *, atol: float) -> int:
    """Rows where two top-k results differ by more than equal-score ties.

    Values must agree position by position within atol, and the id sets may
    differ only in ids whose score lies within atol of the row's k-th score
    (the rule of tests/test_pallas_mips.py: ties can swap equal values, never
    lose recall). Arguments are numpy arrays [Q, k]."""
    bad = 0
    for r in range(va.shape[0]):
        if not np.allclose(va[r], vb[r], atol=atol, rtol=0.0):
            bad += 1
            continue
        kth = min(va[r, -1], vb[r, -1])
        score = dict(zip(ia[r].tolist(), va[r].tolist()))
        score.update(zip(ib[r].tolist(), vb[r].tolist()))
        diff = set(ia[r].tolist()) ^ set(ib[r].tolist())
        if any(abs(score[i] - kth) > atol for i in diff):
            bad += 1
    return bad
