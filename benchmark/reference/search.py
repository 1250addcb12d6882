"""Plain exact top-k inner-product search, the search cells' reference.

The index is bf16 and the program scores queries in the index's dtype
(DenseIndex.search), so the reference rounds the queries to bf16 and scores
them against the index rows in f32 (TF32 off): the products of two bf16
values are exact in f32, and only the order of the sums differs from the
program's. The rows are drawn again from the seed chunk by chunk
(traffic.index_chunks), so the reference needs no copy of the index.

`int8_topk` is the control: the same search over the rows quantized to
int8 with one absmax scale a block of rows, the representation one step
below bf16.
"""
from __future__ import annotations

import numpy as np
import torch


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def topk_and_scores(queries: torch.Tensor, chunks, k: int, ids: torch.Tensor):
    """Exact top-k of each query over the rows `chunks` yields, and the
    scores of the rows `ids` [S, k'] names (NaN for an id outside the rows).

    queries: [S, D] f32 holding bf16 values; chunks: (first row, [rows, D])
    pairs in row order. Returns (values [S, k], rows [S, k], scores [S, k'])."""
    torch.backends.cuda.matmul.allow_tf32 = False
    s = queries.shape[0]
    best_v = torch.full((s, 0), -float("inf"), device=queries.device)
    best_i = torch.zeros((s, 0), dtype=torch.int64, device=queries.device)
    scores = torch.full(ids.shape, float("nan"), device=queries.device)
    for lo, rows in chunks:
        sc = queries @ _f32(rows).T                                   # [S, rows]
        v, i = torch.topk(sc, min(k, sc.shape[1]), dim=1)
        best_v, sel = torch.topk(torch.cat([best_v, v], 1), min(k, best_v.shape[1] + v.shape[1]),
                                 dim=1)
        best_i = torch.gather(torch.cat([best_i, i + lo], 1), 1, sel)
        inside = (ids >= lo) & (ids < lo + rows.shape[0])
        r, c = inside.nonzero(as_tuple=True)
        scores[r, c] = sc[r, ids[r, c] - lo]
    return best_v, best_i, scores


def int8_topk(queries: torch.Tensor, chunks, k: int, block: int):
    """The control: top-k over the rows quantized to int8 with one absmax
    scale a block of `block` rows (scale = max|x| / 127, codes rounded to
    [-127, 127]), scored as scale * (query . codes). Returns (values,
    rows), as the program would."""
    torch.backends.cuda.matmul.allow_tf32 = False
    s = queries.shape[0]
    best_v = torch.full((s, 0), -float("inf"), device=queries.device)
    best_i = torch.zeros((s, 0), dtype=torch.int64, device=queries.device)
    for lo, rows in chunks:
        x = _f32(rows)
        n = x.shape[0]
        pad = (-n) % block
        xb = torch.cat([x, x.new_zeros(pad, x.shape[1])]).view(-1, block, x.shape[1])
        amax = xb.abs().amax(dim=(1, 2))
        scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        codes = torch.clamp(torch.round(xb / scale[:, None, None]), -127, 127)
        deq = (codes * scale[:, None, None]).view(-1, x.shape[1])[:n]
        sc = queries @ deq.T
        v, i = torch.topk(sc, min(k, n), dim=1)
        best_v, sel = torch.topk(torch.cat([best_v, v], 1), min(k, best_v.shape[1] + v.shape[1]),
                                 dim=1)
        best_i = torch.gather(torch.cat([best_i, i + lo], 1), 1, sel)
    return best_v, best_i


def distinct_blocks(queries: torch.Tensor, chunks, kb: int, block: int,
                    sub_rows: int = 1 << 15) -> list[int]:
    """The blocks an exact block-max search must read: each query's kb
    blocks of `block` rows with the highest maximum score (blocks cut from
    row 0, the last one partial), counted once however many queries select
    them. queries: [B, Q, D] f32 holding bf16 values, B batches searched
    apart; chunks as in topk_and_scores, each a multiple of `block` rows but
    the last. Returns the count of each batch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b, q, d = queries.shape
    flat = queries.reshape(b * q, d)
    best_v = torch.full((b * q, 0), -float("inf"), device=queries.device)
    best_i = torch.zeros((b * q, 0), dtype=torch.int64, device=queries.device)
    for lo, rows in chunks:
        for s in range(0, rows.shape[0], sub_rows):
            sc = flat @ _f32(rows[s:s + sub_rows]).T                  # [B Q, rows]
            pad = (-sc.shape[1]) % block
            if pad:
                sc = torch.cat([sc, sc.new_full((sc.shape[0], pad), -float("inf"))], 1)
            bmax = sc.view(b * q, -1, block).amax(dim=2)               # [B Q, blocks]
            first = (lo + s) // block
            ids = torch.arange(first, first + bmax.shape[1], device=bmax.device)
            best_v, sel = torch.topk(torch.cat([best_v, bmax], 1),
                                     min(kb, best_v.shape[1] + bmax.shape[1]), dim=1)
            best_i = torch.gather(torch.cat([best_i, ids.expand(b * q, -1)], 1), 1, sel)
    return [int(torch.unique(best_i[i * q:(i + 1) * q]).numel()) for i in range(b)]


def compare(prog_vals: np.ndarray, prog_ids: np.ndarray, ref_vals: torch.Tensor,
            scores: torch.Tensor, n: int) -> dict:
    """The numbers a search cell compares, over sampled queries:
      score_gap: the largest amount by which the row the program ranks r-th
        scores below the reference's r-th best (a row missed, or ranked out of
        order, beyond the rounding of the sums);
      value_gap: the largest gap between a score the program returns and the
        reference's score of the row it names;
      bad_ids: rows outside [0, n), and rows named twice for one query."""
    true = scores.cpu().numpy().astype(np.float64)
    ref = ref_vals.cpu().numpy().astype(np.float64)
    outside = (prog_ids < 0) | (prog_ids >= n)
    srt = np.sort(prog_ids, axis=1)
    twice = int((srt[:, 1:] == srt[:, :-1]).sum())
    valid = ~np.isnan(true)
    gap = np.where(valid, ref - true, np.inf)
    vgap = np.where(valid, np.abs(prog_vals.astype(np.float64) - true), np.inf)
    return {"score_gap": float(gap.max()), "value_gap": float(vgap.max()),
            "bad_ids": float(outside.sum() + twice)}
