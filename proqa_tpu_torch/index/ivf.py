"""IVF (inverted-file) approximate MIPS index.

Counterpart of proqa_tpu/index/ivf.py, the equivalent of faiss.IndexIVFFlat
as the reference QA sampler uses it (qa/online_sampler.py:75-79: nlist 100,
nprobe 20). The coarse quantizer is the port's k-means (ops/kmeans.py); the
inverted lists are the corpus reordered cluster by cluster, each cluster
padded to a fixed capacity, so a search is

    centroid scores [Q, nlist] -> top-nprobe clusters
    -> gather [Q, nprobe, cap, D] slabs -> score -> top-k over the probes.

Rows past a cluster's capacity go to an overflow region that every search
scores, so no row is dropped. The centroid and slab scores are plain
products (`ops/dot.py:dot_f32`: f32 accumulation, full f32 for f32
operands), as the JAX package's are XLA products: no TPU kernel is involved.

It pays where queries are few and the corpus large; a batch of queries
shares one read of the corpus in the exact block-max search (K1), which is
exact as well.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np
import torch

from proqa_tpu_torch.ops.dot import dot_f32
from proqa_tpu_torch.ops.kmeans import kmeans
from proqa_tpu_torch.ops.mips import NEG_INF, exact_topk


@dataclasses.dataclass
class IVFIndex:
    centroids: torch.Tensor      # [nlist, D] f32
    slabs: torch.Tensor          # [nlist, cap, D] cluster-contiguous rows, zero padded
    slab_rows: torch.Tensor      # [nlist, cap] int32 original row (-1: padding)
    overflow: torch.Tensor       # [n_over_padded, D]
    overflow_rows: torch.Tensor  # [n_over_padded] int32 original row (-1: padding)
    nprobe: int = 20
    # the geometry the quantizer was trained in; probing must use the same
    # (faiss probes with the quantizer that assigned the rows)
    spherical: bool = True

    # a search gathers [Q, nprobe, cap, D] slabs: larger query batches run in
    # chunks whose gather stays near this size (at least 8 queries a chunk)
    GATHER_BUDGET_BYTES: ClassVar[int] = 1 << 30

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def capacity(self) -> int:
        return self.slabs.shape[1]

    def search(self, queries, k: int):
        """(values [Q, k] f32, original rows [Q, k] int32), as tensors on the
        slabs' device. A batch whose gather would pass GATHER_BUDGET_BYTES
        runs in chunks of equal size, the last one padded."""
        q = torch.as_tensor(queries).to(self.slabs.device, self.slabs.dtype)
        qn = q.shape[0]
        nprobe = min(self.nprobe, self.nlist)
        per_q = nprobe * self.capacity * q.shape[1] * q.element_size()
        chunk = max(8, int(self.GATHER_BUDGET_BYTES // max(per_q, 1)) // 8 * 8)
        if qn <= chunk:
            return self._search_call(q, k)
        outs = []
        for s in range(0, qn, chunk):
            part = q[s:s + chunk]
            if part.shape[0] < chunk:
                part = torch.cat([part, part.new_zeros(chunk - part.shape[0], part.shape[1])])
            outs.append(self._search_call(part, k))
        return (torch.cat([v for v, _ in outs])[:qn], torch.cat([i for _, i in outs])[:qn])

    def _search_call(self, q, k: int):
        return _ivf_search(q, self.centroids, self.slabs, self.slab_rows, self.overflow,
                           self.overflow_rows, k=k, nprobe=self.nprobe,
                           spherical=self.spherical)


def _ivf_search(q, centroids, slabs, slab_rows, overflow, overflow_rows, *, k: int,
                nprobe: int, spherical: bool = True):
    """The search of proqa_tpu/index/ivf.py:_ivf_search. Returns (values
    [Q, min(k, scanned)] f32, rows int32); a slot that found no real row is
    (NEG_INF, row 0), DenseIndex's contract, never -1."""
    qn, d = q.shape
    nlist, cap, _ = slabs.shape
    nprobe = min(nprobe, nlist)
    c_scores = dot_f32(q.float(), centroids.T)
    if not spherical:
        # rows were assigned by argmin |x - c|^2 = argmax x.c - |c|^2 / 2: probe
        # in that geometry, or a large-norm centroid takes every probe
        c_scores = c_scores - 0.5 * centroids.square().sum(1)[None, :]
    probes = exact_topk(c_scores, nprobe).indices                     # [Q, nprobe]
    cand = slabs[probes].to(q.dtype).view(qn, nprobe * cap, d)        # [Q, nprobe * cap, D]
    s = dot_f32(cand, q[:, :, None]).view(qn, nprobe * cap)
    del cand
    rows = slab_rows[probes].view(qn, nprobe * cap)
    s = torch.where(rows >= 0, s, NEG_INF)
    if overflow.shape[0] > 0:
        s_over = dot_f32(q, overflow.to(q.dtype).T)
        s_over = torch.where(overflow_rows[None, :] >= 0, s_over, NEG_INF)
        s = torch.cat([s, s_over], dim=1)
        rows = torch.cat([rows, overflow_rows[None, :].expand(qn, -1).to(rows.dtype)], dim=1)
    vals, sel = exact_topk(s, min(k, s.shape[1]))
    idx = torch.gather(rows, 1, sel)
    # fewer real rows than k among the probes: the tail selected padding
    # slots (-1), which must not escape (an IdMap lookup of -1 is the last
    # document)
    invalid = idx < 0
    return vals.masked_fill(invalid, NEG_INF), idx.masked_fill(invalid, 0).to(torch.int32)


def build_ivf(embeddings, *, nlist: int = 100, nprobe: int = 20, niter: int = 20,
              capacity_factor: float = 2.0, spherical: bool = True, seed: int = 0,
              dtype=torch.bfloat16, max_points_per_centroid: int | None = 1000) -> IVFIndex:
    """Train the coarse quantizer and lay the rows out cluster by cluster.

    embeddings: [N, D] numpy or tensor (the layout is made on its device).
    capacity = capacity_factor * N / nlist rounded up to 8; rows
    past it go to the overflow. A cluster keeps its rows in row order, the
    first `capacity` of them in its slab, as the JAX package's fill does.
    k-means draws from torch.Generator(seed), so its initial centroids
    differ from the JAX package's (ops/kmeans.py); from the same initial
    centroids both lay out the same slabs."""
    emb = torch.as_tensor(embeddings).float()
    n, d = emb.shape
    res = kmeans(torch.Generator().manual_seed(seed), emb, nlist, niter=niter,
                 spherical=spherical, max_points_per_centroid=max_points_per_centroid)
    assign = res.assignments.long()

    cap = max(8, int(np.ceil(capacity_factor * n / nlist / 8)) * 8)
    # each row's slot is its rank within its cluster, in row order
    order = torch.argsort(assign, stable=True)
    sorted_assign = assign[order]
    counts = torch.bincount(assign, minlength=nlist)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=emb.device) - starts[sorted_assign]
    in_slab = pos < cap

    slabs = torch.zeros(nlist * cap, d, dtype=dtype, device=emb.device)
    slab_rows = torch.full((nlist * cap,), -1, dtype=torch.int32, device=emb.device)
    slot = sorted_assign[in_slab] * cap + pos[in_slab]
    slabs[slot] = emb[order[in_slab]].to(dtype)
    slab_rows[slot] = order[in_slab].to(torch.int32)

    over_sel = order[~in_slab]
    n_over = over_sel.shape[0]
    over_pad = max(8, -(-n_over // 8) * 8) if n_over else 0
    overflow = torch.zeros(over_pad, d, dtype=dtype, device=emb.device)
    overflow_rows = torch.full((over_pad,), -1, dtype=torch.int32, device=emb.device)
    overflow[:n_over] = emb[over_sel].to(dtype)
    overflow_rows[:n_over] = over_sel.to(torch.int32)
    return IVFIndex(centroids=res.centroids, slabs=slabs.view(nlist, cap, d),
                    slab_rows=slab_rows.view(nlist, cap), overflow=overflow,
                    overflow_rows=overflow_rows, nprobe=nprobe, spherical=spherical)
