"""Corpus clustering for progressive (cluster-batched) retriever pretraining.

Counterpart of proqa_tpu/index/cluster.py (upstream retrieval/group_paras.py):
k-means the training pairs' paragraph embeddings on the device
(ops/kmeans.py), then shard the pretraining jsonl so each output file holds
one cluster's pairs. data/datasets.py:ClusterPairDataset and
cluster_batch_order read the shards, so every batch carries hard in-batch
negatives. The shard writer is a copy of the JAX package's (pure Python).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from proqa_tpu_torch.ops.kmeans import kmeans


def cluster_corpus_embeddings(
    embeddings: np.ndarray,
    ncentroids: int = 10000,
    *,
    niter: int = 250,
    max_points_per_centroid: int | None = 1000,
    spherical: bool = False,
    seed: int = 0,
    init: str = "auto",
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Cluster [N, D] embeddings on `device`; returns int32 assignments [N].
    The defaults are the reference recipe's (ncentroids 10000, niter 250,
    max_points_per_centroid 1000; group_paras.py:57-59)."""
    data = torch.from_numpy(np.ascontiguousarray(embeddings, np.float32)).to(device)
    res = kmeans(torch.Generator().manual_seed(seed), data, ncentroids, niter=niter,
                 spherical=spherical, max_points_per_centroid=max_points_per_centroid,
                 init=init)
    return res.assignments.cpu().numpy()


def write_cluster_shards(
    pairs_jsonl: str, assignments: np.ndarray, out_dir: str, prefix: str = "split_"
) -> int:
    """Write one `<prefix><cluster>.jsonl` per non-empty cluster; line i of
    pairs_jsonl goes to shard assignments[i]. Returns the shard count."""
    os.makedirs(out_dir, exist_ok=True)
    with open(pairs_jsonl) as f:
        lines = f.readlines()
    assert len(lines) == len(assignments), (
        f"{len(lines)} pairs vs {len(assignments)} assignments"
    )
    ncentroids = int(assignments.max()) + 1 if len(assignments) else 0
    buckets: dict[int, list[str]] = {}
    for line, a in zip(lines, assignments):
        buckets.setdefault(int(a), []).append(line)
    width = len(str(max(ncentroids - 1, 0)))
    for c, bucket in sorted(buckets.items()):
        with open(os.path.join(out_dir, f"{prefix}{c:0{width}d}.jsonl"), "w") as f:
            f.writelines(bucket)
    return len(buckets)
