"""DenseIndex: the device-resident corpus embedding matrix with exact MIPS
search, live updates, and an IVF view.

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

Live updates (the serving path's /add and /remove), with the JAX package's
semantics:
* `add` writes in place into the zero-padded capacity tail, its width
  bucketed to the next power of two; past the capacity the buffer grows by
  1.5x (rounded to 1024 rows) and the old one is dropped at once. An int8
  add requantizes the quantization block it starts inside;
* removal tombstones rows: `search` over-fetches k + #deleted (bucketed to a
  power of two) and filters on the host, so an exact search equals that of a
  rebuilt index; `compact` rebuilds without them, and `save` compacts first;
* every mutation bumps `version`.

`to_ivf` builds an IVF view (`IVFDenseIndex`, index/ivf.py) that searches
through a coarse quantizer and refuses mutation. Not ported: row sharding
over several devices (ROADMAP Queue 1, item 15).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from proqa_tpu_torch.index.idmap import IdMap
from proqa_tpu_torch.ops.mips import envelope_block, mips_topk, pad_queries
from proqa_tpu_torch.ops.quant import quantize_rows

_LOAD_CHUNK = 1 << 20  # rows copied to the device per step when loading
_PAD_MULTIPLE = 1024   # rows: the padding of a built index and of a grown one


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


@dataclass
class DenseIndex:
    embeddings: torch.Tensor   # [N_padded, D], bf16, f32 or int8 codes, on the device
    n: int                     # true row count (<= N_padded)
    id_map: IdMap | None = None
    scales: torch.Tensor | None = None  # [N_padded / quant_block] f32 (int8 only)
    quant_block: int = 1                # rows per quantization scale (int8 only)
    version: int = 0                    # bumped by every add and removal
    _deleted: np.ndarray | None = field(default=None, repr=False)  # sorted tombstoned rows

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
        """Live rows: the true row count less the tombstoned ones."""
        return self.n - self.n_deleted

    @property
    def n_deleted(self) -> int:
        return 0 if self._deleted is None else int(self._deleted.size)

    def check_mutable(self) -> None:
        """Raise ValueError where add and remove_rows would: callers that
        write elsewhere first (the DocDB) check before any write."""

    @classmethod
    def from_embeddings(cls, embeddings, id_map: IdMap | None = None, *,
                        device: str | torch.device, dtype=torch.bfloat16,
                        pad_multiple: int = _PAD_MULTIPLE) -> "DenseIndex":
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

    # ---------------- live updates ----------------

    def add(self, embeddings, ids=None) -> None:
        """Append rows (numpy or a tensor, [m, D]) in place, with their doc
        ids iff the index has an id map (proqa_tpu/index/dense.py:214). The
        write covers the next power of two of rows from the first written
        one, zeros past the new rows, so repeated small adds launch a handful
        of shapes; past the capacity the buffer grows by 1.5x (rounded to
        1024 rows). An int8 add that starts inside a quantization block
        requantizes that block's rows with the new ones; only blocks that
        hold a real row get written scales, and `quant_block` stays what
        construction chose."""
        if isinstance(embeddings, torch.Tensor):
            embeddings = embeddings.detach().float().cpu().numpy()
        new = np.asarray(embeddings, np.float32)
        if new.ndim != 2 or new.shape[1] != self.dim:
            raise ValueError(f"expected [m, {self.dim}] rows, got {new.shape}")
        m = new.shape[0]
        if (ids is None) != (self.id_map is None):
            raise ValueError("ids must be passed iff the index has an id map "
                             f"(has map: {self.id_map is not None})")
        if ids is not None:
            ids = list(ids)
            if len(ids) != m:
                raise ValueError(f"{m} rows but {len(ids)} ids")
        if m == 0:
            return
        qb = self.quant_block
        start = self.n  # first written row
        if self.scales is not None:
            # quantization blocks are the absolute row ranges [i*qb, (i+1)*qb):
            # an add starting inside one requantizes its old rows with the new
            # ones (they round again, against a scale that may have grown)
            r0 = (self.n // qb) * qb
            if r0 < self.n:
                new = np.concatenate([self.take(np.arange(r0, self.n)), new])
                start = r0
        m_w = new.shape[0]  # rows written: the straddled old rows and the new
        mp = _next_pow2(m_w)
        cap = self.embeddings.shape[0]
        if start + mp > cap:
            self._grow(max(start + mp, cap + cap // 2))
        padded = np.zeros((mp, self.dim), np.float32)
        padded[:m_w] = new
        if self.scales is not None:
            padded, sc = quantize_rows(padded, block=qb)
            # the zero rows past the new ones keep the capacity tail zero; the
            # scales of their blocks stay 1.0, not overwriting real ones
            sc[-(-m_w // qb):] = 1.0
            self.scales[start // qb:start // qb + sc.shape[0]] = torch.from_numpy(sc).to(
                self.scales.device)
        self.embeddings[start:start + mp] = torch.from_numpy(padded).to(
            self.embeddings.device).to(self.embeddings.dtype)
        self.n += m
        if ids is not None:
            self.id_map.extend(ids)
        self.version += 1

    def _grow(self, rows: int) -> None:
        """A new zero buffer of `rows` rounded up to 1024 rows, holding the
        old rows; the old buffer is dropped before the scales allocate, so at
        most the old and the new matrix are held together."""
        new_cap = rows + (-rows) % _PAD_MULTIPLE
        old = self.embeddings
        buf = old.new_zeros(new_cap, self.dim)
        buf[:old.shape[0]] = old
        self.embeddings = buf
        del old
        if self.scales is not None:
            sc = self.scales.new_ones(new_cap // self.quant_block)
            sc[:self.scales.shape[0]] = self.scales
            self.scales = sc

    def remove_rows(self, rows) -> int:
        """Tombstone index rows; returns the number newly deleted. Searches
        over-fetch and filter them, so exact results equal a rebuilt
        index's; compact() reclaims the space."""
        rows = np.unique(np.asarray(rows, np.int64))
        if rows.size and (rows[0] < 0 or rows[-1] >= self.n):
            raise ValueError(f"row out of range [0, {self.n})")
        merged = rows if self._deleted is None else np.union1d(self._deleted, rows)
        newly = int(merged.size) - self.n_deleted
        if newly == 0:
            return 0
        self._deleted = merged
        self.version += 1
        return newly

    def remove_ids(self, doc_ids) -> int:
        """Tombstone every row carrying any of the doc ids (a duplicated id
        tombstones all its rows)."""
        if self.id_map is None:
            raise ValueError("index has no id map")
        return self.remove_rows(self.id_map.ids_to_rows(doc_ids))

    def live_rows(self, doc_ids) -> list[int]:
        """The rows carrying the doc ids that are not tombstoned: the
        retrievable ones (IdMap.ids_to_rows also returns a replaced row)."""
        if self.id_map is None:
            raise ValueError("index has no id map")
        rows = self.id_map.ids_to_rows(doc_ids)
        if self._deleted is None or not rows:
            return rows
        live = ~np.isin(np.asarray(rows, np.int64), self._deleted)
        return [r for r, keep in zip(rows, live) if keep]

    def compact(self) -> "DenseIndex":
        """A new index without the tombstoned rows, renumbered; this one stays
        valid. An int8 index requantizes from its dequantized survivors
        (from_embeddings of them, dtype "int8")."""
        keep = np.arange(self.n)
        if self.n_deleted:
            keep = np.setdiff1d(keep, self._deleted)
        id_map = None if self.id_map is None else IdMap(self.id_map.rows_to_ids(keep))
        device = self.embeddings.device
        if self.scales is not None:
            return DenseIndex.from_embeddings(self.take(keep), id_map, device=device,
                                              dtype="int8")
        rows = self.embeddings[torch.from_numpy(keep).to(device)]
        return DenseIndex.from_embeddings(rows, id_map, device=device,
                                          dtype=self.embeddings.dtype)

    def _filter_deleted(self, vals: np.ndarray, idx: np.ndarray, k: int):
        """The first k rows of each query's over-fetched top that are not
        tombstoned, in order; an under-filled tail is (-inf, row 0)."""
        keep = ~np.isin(idx, self._deleted)
        out_v = np.full((vals.shape[0], k), -np.inf, np.float32)
        out_i = np.zeros((idx.shape[0], k), idx.dtype)
        for r in range(vals.shape[0]):
            cols = np.nonzero(keep[r])[0][:k]
            out_v[r, :cols.size] = vals[r, cols]
            out_i[r, :cols.size] = idx[r, cols]
        return out_v, out_i

    # ---------------- IVF ----------------

    def to_ivf(self, *, nlist: int = 100, nprobe: int = 20, niter: int = 20, seed: int = 0,
               **kw) -> "IVFDenseIndex":
        """An IVF view of this index (the reference's online-QA setting is
        nlist 100, nprobe 20: qa/online_sampler.py:75-79). The slabs hold the
        rows as f32 (an int8 index's dequantized) cast to the scoring dtype.
        Refuses an index with tombstones: compact() first."""
        from proqa_tpu_torch.index.ivf import build_ivf

        if self.n_deleted:
            raise ValueError("index has tombstoned rows: compact() before to_ivf(), so the "
                             "slabs cannot serve removed paragraphs")
        rows = self.gather(torch.arange(self.n, device=self.embeddings.device))
        ivf = build_ivf(rows, nlist=nlist, nprobe=nprobe, niter=niter, seed=seed,
                        dtype=self._query_dtype, **kw)
        del rows
        return IVFDenseIndex(embeddings=self.embeddings, n=self.n, id_map=self.id_map,
                             scales=self.scales, quant_block=self.quant_block, ivf=ivf)

    # ---------------- search ----------------

    def search(self, queries, k: int, *, exact: bool = True, q_pad: int = 256,
               _skip_tombstones: bool = False):
        """Top-k rows by inner product. queries: [Q, D] numpy array or tensor,
        cast to the scoring dtype (the index dtype; bf16 for int8). Returns
        (values [Q, k] f32, rows [Q, k] int32) as numpy; padded rows, padded
        queries and tombstoned rows are excluded, and a k beyond the live
        rows pads with (-inf, row 0)."""
        if self.n_deleted and not _skip_tombstones:
            # over-fetch so that k live rows survive the filter even if every
            # tombstoned row outscored them; the width is a power of two, so
            # accumulating removals launch few shapes
            k_fetch = min(self.n, _next_pow2(k + self.n_deleted))
            vals, idx = self.search(queries, k_fetch, exact=exact, q_pad=q_pad,
                                    _skip_tombstones=True)
            return self._filter_deleted(vals, idx, k)
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
        writes its dequantized rows) and `<path>/idx_id.json`. Tombstoned
        rows are compacted away first (the rows renumber)."""
        if self.n_deleted:
            self.compact().save(path)
            return
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


@dataclass
class IVFDenseIndex(DenseIndex):
    """A DenseIndex whose searches go through an IVF coarse quantizer
    (approximate; a query scores nprobe of nlist clusters and the overflow),
    keeping the dense matrix for gathers, exact searches and saving. Its
    slab layout is made once (to_ivf): mutate the dense index, then build
    the view again."""

    ivf: object = None  # index/ivf.py:IVFIndex

    def check_mutable(self) -> None:
        raise ValueError("the IVF slab layout is fixed when it is built: mutate the dense "
                         "index, then run to_ivf() again")

    def add(self, embeddings, ids=None) -> None:
        self.check_mutable()

    def remove_rows(self, rows) -> int:
        self.check_mutable()

    def search(self, queries, k: int, *, exact: bool = False, q_pad: int | None = None):
        """IVF top-k, or the dense exact search when `exact` (bypassing the
        quantizer). A caller's q_pad is kept; without one the batch pads to
        the next power of two up to 256: IVF costs a slab gather a query, so
        a lone query does not pay for 256."""
        if exact:
            return super().search(queries, k, exact=True,
                                  q_pad=q_pad if q_pad is not None else 256)
        q = torch.as_tensor(queries).to(self.embeddings.device, self._query_dtype)
        if q_pad is None:
            q_pad = min(_next_pow2(q.shape[0]), 256)
        q, q_n = pad_queries(q, q_pad)
        vals, idx = self.ivf.search(q, min(k, self.n))
        vals = vals[:q_n].float().cpu().numpy()
        idx = idx[:q_n].to(torch.int32).cpu().numpy()
        if vals.shape[1] < k:
            vals = np.pad(vals, ((0, 0), (0, k - vals.shape[1])), constant_values=-np.inf)
            idx = np.pad(idx, ((0, 0), (0, k - idx.shape[1])))
        return vals, idx
