"""DenseIndex: the device-resident corpus embedding matrix with exact MIPS
search.

Counterpart of proqa_tpu/index/dense.py for one device. The on-disk format
is the JAX package's, and the reference's: an f32 `embeddings.npy` plus
`idx_id.json`, so an index built by either package loads in the other. Rows
are padded to a multiple of 1024 with zero vectors, which are never returned.

dtype "int8" stores the corpus int8-quantized (ops/quant.py) at half the
bf16 footprint, with per-block f32 scales whose block is pinned to the search
kernel's reduce block (ops/mips.py:envelope_block), so the search runs kernel
K5 and is exact with respect to the quantized scores. int8 is a runtime
representation: `save` writes the dequantized f32 matrix, and
`load(dtype="int8")` quantizes again.

Not ported yet, and raising NotImplementedError: incremental add / removal /
compaction (ROADMAP Queue 1, item 12), IVF (item 14) and row sharding over
several devices (item 15).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from proqa_tpu_torch.index.idmap import IdMap
from proqa_tpu_torch.ops.mips import envelope_block, mips_topk, pad_queries
from proqa_tpu_torch.ops.quant import quantize_rows

_LOAD_CHUNK = 1 << 20  # rows copied to the device per step when loading


def _not_ported(what: str, item: int):
    raise NotImplementedError(f"{what} is not ported to PyTorch yet (ROADMAP Queue 1, item {item})")


@dataclass
class DenseIndex:
    embeddings: torch.Tensor   # [N_padded, D], bf16, f32 or int8 codes, on the device
    n: int                     # true row count (<= N_padded)
    id_map: IdMap | None = None
    scales: torch.Tensor | None = None  # [N_padded / quant_block] f32 (int8 only)
    quant_block: int = 1                # rows per quantization scale (int8 only)

    @property
    def dim(self) -> int:
        return self.embeddings.shape[1]

    @property
    def is_quantized(self) -> bool:
        return self.scales is not None

    @property
    def _query_dtype(self) -> torch.dtype:
        """Scoring dtype of the queries: an int8 corpus scores in bf16 (its
        codes convert exactly), also where the index was loaded for f32."""
        d = self.embeddings.dtype
        return torch.bfloat16 if d == torch.int8 else d

    def __len__(self) -> int:
        return self.n

    @classmethod
    def from_embeddings(cls, embeddings, id_map: IdMap | None = None, *,
                        device: str | torch.device, dtype=torch.bfloat16,
                        pad_multiple: int = 1024) -> "DenseIndex":
        """Build from an [N, D] array (numpy, possibly a memmap, or a tensor).
        Rows are cast to `dtype` on the device and padded with zero rows to
        a multiple of pad_multiple.

        dtype "int8" (or torch.int8) quantizes the rows on the host with the
        block envelope_block(N padded), halved until it divides the padded
        rows; the padding rows get zero codes and their blocks scale 1.0."""
        n, d = embeddings.shape
        if dtype in ("int8", torch.int8):
            n_total = n + (-n) % pad_multiple
            qb = envelope_block(n_total)
            while qb > 16 and n_total % qb:
                qb //= 2
            if n_total % qb:
                raise ValueError(f"cannot pick an int8 quantization block for {n_total} rows")
            if isinstance(embeddings, torch.Tensor):
                embeddings = embeddings.detach().float().cpu().numpy()
            q8, sc = quantize_rows(embeddings, block=qb)  # chunked: memmap-friendly
            codes = torch.zeros(n_total, d, dtype=torch.int8, device=device)
            codes[:n] = torch.from_numpy(q8)
            scales = torch.ones(n_total // qb, dtype=torch.float32, device=device)
            scales[:sc.shape[0]] = torch.from_numpy(sc)
            return cls._from_quantized(codes, scales, n, qb, id_map)
        arr = torch.zeros(n + (-n) % pad_multiple, d, dtype=dtype, device=device)
        if isinstance(embeddings, torch.Tensor):
            arr[:n] = embeddings
        else:
            for s in range(0, n, _LOAD_CHUNK):  # bounded host memory for memmaps
                e = min(s + _LOAD_CHUNK, n)
                arr[s:e] = torch.from_numpy(np.array(embeddings[s:e], np.float32))
        return cls(embeddings=arr, n=n, id_map=id_map)

    @classmethod
    def _from_quantized(cls, codes: torch.Tensor, scales: torch.Tensor, n: int, qb: int,
                        id_map: IdMap | None) -> "DenseIndex":
        """Already-padded int8 codes [N_padded, D] and f32 per-block scales
        [N_padded / qb], on the device."""
        if codes.dtype != torch.int8 or codes.shape[0] != qb * scales.shape[0]:
            raise ValueError(f"need int8 codes of {qb} rows per scale, got {codes.dtype} "
                             f"{tuple(codes.shape)} and {tuple(scales.shape)} scales")
        return cls(embeddings=codes, n=n, id_map=id_map, scales=scales.float(),
                   quant_block=qb)

    # -------- mutation and IVF: later slices --------

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
        cast to the scoring dtype (the index dtype; bf16 for int8). Returns
        (values [Q, k] f32, rows [Q, k] int32) as numpy; padded rows and
        padded queries are excluded, and a k beyond the row count pads with
        (-inf, row 0)."""
        q = torch.as_tensor(queries).to(self.embeddings.device, self._query_dtype)
        q, q_n = pad_queries(q, q_pad)
        k_eff = min(k, self.n)
        vals, idx = mips_topk(q, self.embeddings, k_eff, exact=exact, n_valid=self.n,
                              scales=self.scales, quant_block=self.quant_block)
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

    def gather(self, rows: torch.Tensor) -> torch.Tensor:
        """Embedding rows [..., D] as f32 on the index's device, int8 rows
        dequantized. Indices are clipped to the padded row range, so -1 (an
        under-filled retrieval slot) gathers row 0, as the JAX package's
        mode="clip" does."""
        r = rows.to(self.embeddings.device).long().clamp(0, self.embeddings.shape[0] - 1)
        out = self.embeddings[r].float()
        if self.scales is not None:
            out = out * self.scales[r // self.quant_block][..., None]
        return out

    def take(self, rows) -> np.ndarray:
        """`gather` of host row ids, as f32 numpy."""
        return self.gather(torch.as_tensor(np.asarray(rows))).cpu().numpy()

    # ---------------- persistence ----------------

    def save(self, path: str) -> None:
        """Writes `<path>/embeddings.npy` (f32, unpadded; an int8 index
        writes its dequantized rows) and `<path>/idx_id.json`."""
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "embeddings.npy"), self.take(np.arange(self.n)))
        if self.id_map is not None:
            self.id_map.save(os.path.join(path, "idx_id.json"))

    @classmethod
    def load(cls, path: str, *, device: str | torch.device,
             dtype=torch.bfloat16) -> "DenseIndex":
        """`path` is a directory (embeddings.npy [+ idx_id.json]) or a bare
        .npy file. dtype="int8" quantizes at load."""
        if os.path.isdir(path):
            emb_path = os.path.join(path, "embeddings.npy")
            map_path = os.path.join(path, "idx_id.json")
            id_map = IdMap.load(map_path) if os.path.exists(map_path) else None
        else:
            emb_path, id_map = path, None
        emb = np.load(emb_path, mmap_mode="r")
        return cls.from_embeddings(emb, id_map, device=device, dtype=dtype)
