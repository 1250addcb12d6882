"""Lloyd's k-means on the device, for corpus clustering.

Counterpart of proqa_tpu/ops/kmeans.py (which replaces faiss.Clustering,
upstream retrieval/group_paras.py:20-53): spherical (inner-product) or L2
geometry, `max_points_per_centroid` subsampling, k-means++ or random
initialisation, and empty clusters keeping their previous centroid. Each
chunk of rows is scored against every centroid by one f32 product in full
f32 (`ops/dot.py:full_f32` turns TF32 off for that product and restores the
caller's setting; the JAX package pins HIGHEST precision so that near ties
do not flip with the backend), so the [N, k] score matrix never exists
whole. No TPU kernel is involved: the JAX package scores with
an XLA product too. Where JAX sums each cluster's rows by a one-hot product,
the port adds them with `index_add_`: the same sums in another order.

Random draws come from a torch.Generator (the subsample first, then the
initial centroids, as JAX splits its key), so the port's draws differ from
the JAX package's by design; from the same initial centroids both compute
the same clustering.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from proqa_tpu_torch.ops.dot import full_f32


class KMeansResult(NamedTuple):
    centroids: torch.Tensor    # [k, D] f32
    assignments: torch.Tensor  # [N] int32
    # mean best assignment score (higher is better in both geometries): the
    # inner product when spherical, else the L2 surrogate x.c - |c|^2 / 2
    objective: torch.Tensor


def _chunk_scores(x: torch.Tensor, centroids: torch.Tensor, spherical: bool) -> torch.Tensor:
    """[n, D] x [k, D] -> [n, k] f32, higher is better: L2's argmin is the
    argmax of x.c - |c|^2 / 2."""
    with full_f32():
        ip = torch.matmul(x, centroids.T)
    if spherical:
        return ip
    return ip - 0.5 * centroids.square().sum(-1)[None, :]


def _chunks(n: int, chunk: int):
    return ((s, min(s + chunk, n)) for s in range(0, n, chunk))


@torch.no_grad()
def assign_clusters(data: torch.Tensor, centroids: torch.Tensor, *, spherical: bool = False,
                    chunk: int = 1 << 16) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest centroid of every row, chunk by chunk: (assignments [N]
    int32, best scores [N] f32). Ties go to the lower centroid index, as
    JAX's argmax."""
    a, v = [], []
    for s, e in _chunks(data.shape[0], chunk):
        sc = _chunk_scores(data[s:e].float(), centroids, spherical)
        a.append(sc.argmax(-1).to(torch.int32))
        v.append(sc.amax(-1))
    return torch.cat(a), torch.cat(v)


@torch.no_grad()
def _lloyd_iter(data: torch.Tensor, centroids: torch.Tensor, *, k: int, spherical: bool,
                chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One assignment and update: (new centroids [k, D], mean best score)."""
    d = data.shape[1]
    sums = torch.zeros(k, d, dtype=torch.float32, device=data.device)
    counts = torch.zeros(k, dtype=torch.float32, device=data.device)
    obj = torch.zeros((), dtype=torch.float32, device=data.device)
    for s, e in _chunks(data.shape[0], chunk):
        x = data[s:e].float()
        sc = _chunk_scores(x, centroids, spherical)
        a = sc.argmax(-1)
        sums.index_add_(0, a, x)
        counts += torch.bincount(a, minlength=k).float()
        obj += sc.amax(-1).sum()
    new = sums / counts.clamp(min=1.0)[:, None]
    # empty clusters keep their previous centroid (FAISS-style carryover)
    new = torch.where((counts > 0)[:, None], new, centroids)
    if spherical:
        new = new / new.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    return new, obj / data.shape[0]


@torch.no_grad()
def _kmeanspp_init(generator: torch.Generator, train: torch.Tensor, k: int,
                   spherical: bool) -> torch.Tensor:
    """k-means++ seeding: each next centroid drawn with probability
    proportional to its squared distance to the nearest one chosen
    (uniformly where every distance is 0). O(k N D): for moderate k."""
    n = train.shape[0]
    x32 = train.float()
    first = int(torch.randint(0, n, (), generator=generator))
    chosen = [x32[first]]
    d2 = (x32 - chosen[0][None]).square().sum(-1)
    for _ in range(k - 1):
        total = d2.sum()
        probs = torch.where(total > 0, d2 / total.clamp(min=1e-12),
                            torch.full_like(d2, 1.0 / n))
        cdf = torch.cumsum(probs, 0)
        u = torch.rand((), generator=generator).to(x32.device)  # the generator is the host's
        nxt = torch.searchsorted(cdf, u * cdf[-1], right=True).clamp(max=n - 1)
        c = x32[nxt]
        chosen.append(c)
        d2 = torch.minimum(d2, (x32 - c[None]).square().sum(-1))
    return torch.stack(chosen)


def kmeans(generator: torch.Generator, data: torch.Tensor, k: int, *, niter: int = 25,
           spherical: bool = False, max_points_per_centroid: int | None = None,
           chunk: int = 1 << 16, init: str = "auto") -> KMeansResult:
    """Lloyd's k-means of data [N, D] (any float dtype, on any device). The
    final assignment covers every row even when training runs on a
    subsample of k * max_points_per_centroid rows (FAISS semantics, upstream
    group_paras.py:43).

    init: "kmeans++" | "random" | "auto" (k-means++ for k <= 1024, else
    random rows, as FAISS samples at corpus-clustering scale)."""
    # the [chunk, k] f32 score matrix stays near 256 MB whatever k
    chunk = min(chunk, max(1024, (1 << 26) // max(k, 1)))
    n = data.shape[0]
    train = data
    if max_points_per_centroid is not None and n > k * max_points_per_centroid:
        sel = torch.randperm(n, generator=generator)[:k * max_points_per_centroid]
        train = data[sel.to(data.device)]
    if init == "auto":
        init = "kmeans++" if k <= 1024 else "random"
    if init == "kmeans++":
        centroids = _kmeanspp_init(generator, train, k, spherical)
    else:
        sel = torch.randperm(train.shape[0], generator=generator)[:k]
        centroids = train[sel.to(data.device)].float()
    if spherical:
        centroids = centroids / centroids.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    obj = torch.zeros(())
    for _ in range(niter):
        centroids, obj = _lloyd_iter(train, centroids, k=k, spherical=spherical, chunk=chunk)
    assignments, _ = assign_clusters(data, centroids, spherical=spherical, chunk=chunk)
    return KMeansResult(centroids, assignments, obj)
