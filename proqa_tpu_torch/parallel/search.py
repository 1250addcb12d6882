"""Corpus-sharded MIPS: each shard searches its rows, the candidates merge on
the first device.

Counterpart of proqa_tpu/parallel/search.py. The corpus [N, D] is split into
contiguous row slabs, one per mesh entry (mesh.py:shard_rows); every shard
runs the port's exact search (ops/mips.py:mips_topk; on a CUDA shard kernel
K1 and K6's rescore over bf16 or f32, K5 over int8 codes, each launch
counted per shard), and the [Q, k] lists of all shards meet on the first
device, where one top-k merges them. The JAX package all-gathers the lists
over ICI; here it is a `.to(first device)` of each list, with no
torch.distributed involved: one process drives every shard.
"""
from __future__ import annotations

import torch

from proqa_tpu_torch.ops.mips import NEG_INF, mips_topk, sanitize_padding


def sharded_mips_topk(queries: torch.Tensor, shards: list[torch.Tensor], k: int,
                      mesh: list[torch.device], *, exact: bool = True,
                      n_valid: int | None = None, scales: list[torch.Tensor] | None = None,
                      quant_block: int = 1):
    """Global top-k over row-sharded corpus slabs.

    queries: [Q, D] on any device (copied to each shard's); shards: one
    [N / len(mesh), D] slab per mesh entry, on its device. Returns (values
    [Q, k] f32, global row ids [Q, k] int64) on the first mesh device.
    n_valid masks trailing padded rows by their global index, before each
    shard's local top-k (zero padding rows score 0 and would otherwise evict
    genuine rows of negative score from the padded shard's list).
    scales: one per-block f32 vector per shard for an int8 corpus; each
    shard's row count must divide by quant_block."""
    n_dev = len(mesh)
    if len(shards) != n_dev:
        raise ValueError(f"{len(shards)} shards for a mesh of {n_dev}")
    local_n = shards[0].shape[0]
    if any(s.shape[0] != local_n for s in shards):
        raise ValueError("every shard must hold the same number of rows")
    n = local_n * n_dev
    if scales is not None:
        if len(scales) != n_dev or local_n % quant_block:
            raise ValueError(f"need one scale vector per shard and shard rows {local_n} "
                             f"divisible by quant_block {quant_block}")
        if any(tuple(s.shape) != (local_n // quant_block,) for s in scales):
            raise ValueError(f"each shard needs {local_n // quant_block} block scales")
    masked = n_valid is not None and n_valid < n
    # a shard can hold fewer rows than k: it offers its whole slab, and the
    # merge still finds the global top-k
    k_local = min(k, local_n)
    vals_all, idx_all = [], []
    for s, (shard, dev) in enumerate(zip(shards, mesh)):
        offset = s * local_n
        local_valid = min(max(n_valid - offset, 0), local_n) if masked else None
        vals, idx = mips_topk(queries.to(dev), shard, k_local, exact=exact,
                              n_valid=local_valid,
                              scales=None if scales is None else scales[s],
                              quant_block=quant_block)
        idx = idx + offset
        if masked:
            vals = torch.where(idx < n_valid, vals, NEG_INF)
        if k_local < k:
            # pad to k columns with the (NEG_INF, row 0) contract, which
            # loses the merge to any real candidate
            vals = torch.nn.functional.pad(vals, (0, k - k_local), value=NEG_INF)
            idx = torch.nn.functional.pad(idx, (0, k - k_local))
        vals_all.append(vals.to(mesh[0]))
        idx_all.append(idx.to(mesh[0]))
    cat_vals, cat_idx = torch.cat(vals_all, dim=1), torch.cat(idx_all, dim=1)
    mv, sel = torch.topk(cat_vals, k, dim=1)
    # a fully padded shard's local row 0 became its offset above: a padded
    # global id, so the contract is asserted again after the merge
    return sanitize_padding(mv, torch.gather(cat_idx, 1, sel))


def sharded_matvec_stats(shards: list[torch.Tensor]):
    """Row count and the sum of squared entries over every shard (a cheap
    check of a sharded layout), as host numbers."""
    rows = sum(int(s.shape[0]) for s in shards)
    sq = sum(float(s.float().square().sum()) for s in shards)
    return rows, sq
