"""DenseIndex: the device-resident corpus embedding matrix with exact MIPS
search.

Counterpart of proqa_tpu/index/dense.py for one device. The on-disk format
is the JAX package's, and the reference's: an f32 `embeddings.npy` plus
`idx_id.json`, so an index built by either package loads in the other. Rows
are padded to a multiple of 1024 with zero vectors, which are never returned.

Not ported yet, and raising NotImplementedError: incremental add / removal /
compaction (ROADMAP Queue 1, item 12), the int8 index (item 13), IVF (item 14)
and row sharding over several devices (item 15).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from proqa_tpu_torch.index.idmap import IdMap
from proqa_tpu_torch.ops.mips import mips_topk, pad_queries

_LOAD_CHUNK = 1 << 20  # rows copied to the device per step when loading


def _not_ported(what: str, item: int):
    raise NotImplementedError(f"{what} is not ported to PyTorch yet (ROADMAP Queue 1, item {item})")


@dataclass
class DenseIndex:
    embeddings: torch.Tensor   # [N_padded, D], bf16 or f32, on the device
    n: int                     # true row count (<= N_padded)
    id_map: IdMap | None = None

    @property
    def dim(self) -> int:
        return self.embeddings.shape[1]

    def __len__(self) -> int:
        return self.n

    @classmethod
    def from_embeddings(cls, embeddings, id_map: IdMap | None = None, *,
                        device: str | torch.device, dtype=torch.bfloat16,
                        pad_multiple: int = 1024) -> "DenseIndex":
        """Build from an [N, D] array (numpy, possibly a memmap, or a tensor).
        Rows are cast to `dtype` on the device and padded with zero rows to
        a multiple of pad_multiple."""
        if dtype == "int8":
            _not_ported("the int8 index", 13)
        n, d = embeddings.shape
        arr = torch.zeros(n + (-n) % pad_multiple, d, dtype=dtype, device=device)
        if isinstance(embeddings, torch.Tensor):
            arr[:n] = embeddings
        else:
            for s in range(0, n, _LOAD_CHUNK):  # bounded host memory for memmaps
                e = min(s + _LOAD_CHUNK, n)
                arr[s:e] = torch.from_numpy(np.array(embeddings[s:e], np.float32))
        return cls(embeddings=arr, n=n, id_map=id_map)

    # -------- mutation, quantization, IVF: later slices --------

    def add(self, embeddings, ids=None) -> None:
        _not_ported("DenseIndex.add", 12)

    def remove_rows(self, rows) -> int:
        _not_ported("DenseIndex.remove_rows", 12)

    def remove_ids(self, doc_ids) -> int:
        _not_ported("DenseIndex.remove_ids", 12)

    def compact(self) -> "DenseIndex":
        _not_ported("DenseIndex.compact", 12)

    def to_ivf(self, **kw):
        _not_ported("the IVF index", 14)

    # ---------------- search ----------------

    def search(self, queries, k: int, *, exact: bool = True, q_pad: int = 256):
        """Top-k rows by inner product. queries: [Q, D] numpy array or tensor,
        cast to the index dtype. Returns (values [Q, k] f32, rows [Q, k]
        int32) as numpy; padded rows and padded queries are excluded, and a
        k beyond the row count pads with (-inf, row 0)."""
        q = torch.as_tensor(queries).to(self.embeddings.device, self.embeddings.dtype)
        q, q_n = pad_queries(q, q_pad)
        k_eff = min(k, self.n)
        vals, idx = mips_topk(q, self.embeddings, k_eff, exact=exact, n_valid=self.n)
        vals = vals[:q_n].float().cpu().numpy()
        idx = idx[:q_n].to(torch.int32).cpu().numpy()
        if k_eff < k:  # degenerate tiny-corpus case
            vals = np.pad(vals, ((0, 0), (0, k - k_eff)), constant_values=-np.inf)
            idx = np.pad(idx, ((0, 0), (0, k - k_eff)), constant_values=0)
        return vals, idx

    def search_ids(self, queries, k: int, **kw):
        """Search returning document ids through the IdMap."""
        assert self.id_map is not None, "index has no id map"
        vals, idx = self.search(queries, k, **kw)
        return vals, idx, [self.id_map.rows_to_ids(row) for row in idx]

    # ---------------- persistence ----------------

    def save(self, path: str) -> None:
        """Writes `<path>/embeddings.npy` (f32, unpadded) and
        `<path>/idx_id.json`."""
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "embeddings.npy"),
                self.embeddings[: self.n].float().cpu().numpy())
        if self.id_map is not None:
            self.id_map.save(os.path.join(path, "idx_id.json"))

    @classmethod
    def load(cls, path: str, *, device: str | torch.device,
             dtype=torch.bfloat16) -> "DenseIndex":
        """`path` is a directory (embeddings.npy [+ idx_id.json]) or a bare
        .npy file."""
        if os.path.isdir(path):
            emb_path = os.path.join(path, "embeddings.npy")
            map_path = os.path.join(path, "idx_id.json")
            id_map = IdMap.load(map_path) if os.path.exists(map_path) else None
        else:
            emb_path, id_map = path, None
        emb = np.load(emb_path, mmap_mode="r")
        return cls.from_embeddings(emb, id_map, device=device, dtype=dtype)
