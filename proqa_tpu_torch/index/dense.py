"""DenseIndex: the device-resident corpus embedding matrix with exact MIPS
search, live updates, and an IVF view.

Counterpart of proqa_tpu/index/dense.py. The on-disk format
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
through a coarse quantizer and refuses mutation.

Row sharding (`mesh=`, a device list of parallel/mesh.py): the padded rows
split into one contiguous slab per mesh entry, `embeddings` (and an int8
index's `scales`) then being the list of slabs, and every search goes
through parallel/search.py:sharded_mips_topk. The padding is a multiple of
lcm(1024, mesh size), and an int8 index picks its quantization block per
shard. `gather`, `take`, `save`, `compact` and `to_ivf` read across the
shards (`save` writes the unsharded artifact); `add` and the removals raise,
as the JAX package's do: a sharded index is rebuilt, not mutated.
"""
from __future__ import annotations

import functools
import math
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from proqa_tpu_torch.index.idmap import IdMap
from proqa_tpu_torch.ops.mips import envelope_block, mips_topk, pad_queries
from proqa_tpu_torch.ops.quant import quantize_rows
from proqa_tpu_torch.parallel.search import sharded_mips_topk
from proqa_tpu_torch.utils.host_heap import grow_in_large_steps
from proqa_tpu_torch.utils.profiling import span

_LOAD_CHUNK = 1 << 20  # rows copied to the device per step when loading
_PAD_MULTIPLE = 1024   # rows: the padding of a built index and of a grown one


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _device_rows(src, lo: int, hi: int, n: int, dtype, device) -> torch.Tensor:
    """Rows [lo, hi) of `src` ([n, D], numpy, memmap or tensor) padded with
    zero rows past n, as `dtype` on `device`; numpy rows are copied a chunk
    at a time (bounded host memory for memmaps)."""
    out = torch.zeros(hi - lo, src.shape[1], dtype=dtype, device=device)
    top = min(hi, n)
    if isinstance(src, torch.Tensor):
        if top > lo:
            out[:top - lo] = src[lo:top]
        return out
    host = np.int8 if dtype == torch.int8 else np.float32
    for s in range(lo, top, _LOAD_CHUNK):
        e = min(s + _LOAD_CHUNK, top)
        out[s - lo:e - lo] = torch.from_numpy(np.array(src[s:e], host))
    return out


def _gather_rows(rows: torch.Tensor, scales, quant_block: int, r: torch.Tensor) -> torch.Tensor:
    """f32 rows r of one row tensor, int8 codes dequantized by their block's
    scale."""
    out = rows[r].float()
    if scales is not None:
        out = out * scales[r // quant_block][..., None]
    return out


@dataclass
class DenseIndex:
    # [N_padded, D], bf16, f32 or int8 codes, on the device; sharded: a list
    # of [N_padded / len(mesh), D] slabs, one on each mesh device
    embeddings: torch.Tensor | list
    n: int                     # true row count (<= N_padded)
    id_map: IdMap | None = None
    scales: torch.Tensor | list | None = None  # [N_padded / quant_block] f32 (int8 only),
                                               # split like the rows when sharded
    quant_block: int = 1                # rows per quantization scale (int8 only)
    version: int = 0                    # bumped by every add and removal
    mesh: list | None = None            # the devices of the shards (parallel/mesh.py)
    _deleted: np.ndarray | None = field(default=None, repr=False)  # sorted tombstoned rows

    @property
    def _first(self) -> torch.Tensor:
        """The row tensor, or the first shard's."""
        return self.embeddings if self.mesh is None else self.embeddings[0]

    @property
    def device(self) -> torch.device:
        """Where searches return and gathers land: the first shard's device."""
        return self._first.device

    @property
    def capacity(self) -> int:
        """Padded rows over every shard."""
        return self._first.shape[0] * (1 if self.mesh is None else len(self.mesh))

    @property
    def dim(self) -> int:
        return self._first.shape[1]

    @property
    def is_quantized(self) -> bool:
        return self.scales is not None

    @property
    def _query_dtype(self) -> torch.dtype:
        """Scoring dtype of the queries: an int8 corpus scores in bf16 (its
        codes convert exactly), also where the index was loaded for f32."""
        d = self._first.dtype
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
        if self.mesh is not None:
            raise ValueError("incremental add on a mesh-sharded index is not supported — "
                             "rebuild with DenseIndex.from_embeddings(..., mesh=mesh)")

    @classmethod
    def from_embeddings(cls, embeddings, id_map: IdMap | None = None, *,
                        device: str | torch.device | None = None, dtype=torch.bfloat16,
                        pad_multiple: int = _PAD_MULTIPLE,
                        mesh: list | None = None) -> "DenseIndex":
        """Build from an [N, D] array (numpy, possibly a memmap, or a tensor)
        on `device`, or row-sharded over `mesh`. Rows are cast to `dtype` on
        the device and padded with zero rows to a multiple of pad_multiple
        (and of the mesh size).

        dtype "int8" (or torch.int8) quantizes the rows on the host with the
        block envelope_block(rows per shard), halved until it divides the
        shard, so each shard's search runs kernel K5; the padding rows get
        zero codes and their blocks scale 1.0."""
        if (device is None) == (mesh is None):
            raise ValueError("give a device or a mesh")
        devices = [torch.device(device)] if mesh is None else list(mesh)
        n, d = embeddings.shape
        n_total = n + (-n) % math.lcm(pad_multiple, len(devices))
        local = n_total // len(devices)
        src, scales = embeddings, None
        if dtype in ("int8", torch.int8):
            qb = envelope_block(local)
            while qb > 16 and local % qb:
                qb //= 2
            if local % qb:
                raise ValueError(f"cannot pick an int8 quantization block for {local} rows "
                                 "per shard")
            if isinstance(embeddings, torch.Tensor):
                embeddings = embeddings.detach().float().cpu().numpy()
            src, sc = quantize_rows(embeddings, block=qb)  # chunked: memmap-friendly
            scales = torch.ones(n_total // qb, dtype=torch.float32)
            scales[:sc.shape[0]] = torch.from_numpy(sc)
            dtype = torch.int8
        parts = [_device_rows(src, i * local, (i + 1) * local, n, dtype, dev)
                 for i, dev in enumerate(devices)]
        if scales is not None:
            nb = local // qb
            scale_parts = [scales[i * nb:(i + 1) * nb].to(dev) for i, dev in enumerate(devices)]
            if mesh is None:
                return cls._from_quantized(parts[0], scale_parts[0], n, qb, id_map)
            return cls(embeddings=parts, n=n, id_map=id_map, scales=scale_parts,
                       quant_block=qb, mesh=devices)
        if mesh is None:
            return cls(embeddings=parts[0], n=n, id_map=id_map)
        return cls(embeddings=parts, n=n, id_map=id_map, mesh=devices)

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
        self.check_mutable()
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
        if self.mesh is not None:
            raise ValueError("incremental removal on a mesh-sharded index is not supported")
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
        if self.mesh is not None or self.scales is not None:
            # f32 rows: exact for bf16 and f32, dequantized for int8
            place = ({"device": self.device} if self.mesh is None else {"mesh": self.mesh})
            return DenseIndex.from_embeddings(
                self.take(keep), id_map, **place,
                dtype="int8" if self.scales is not None else self._first.dtype)
        rows = self.embeddings[torch.from_numpy(keep).to(self.device)]
        return DenseIndex.from_embeddings(rows, id_map, device=self.device,
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
        rows = self.gather(torch.arange(self.n, device=self.device))
        ivf = build_ivf(rows, nlist=nlist, nprobe=nprobe, niter=niter, seed=seed,
                        dtype=self._query_dtype, **kw)
        del rows
        return IVFDenseIndex(embeddings=self.embeddings, n=self.n, id_map=self.id_map,
                             scales=self.scales, quant_block=self.quant_block,
                             mesh=self.mesh, ivf=ivf)

    # ---------------- search ----------------

    def search(self, queries, k: int, *, exact: bool = True, q_pad: int = 256,
               _skip_tombstones: bool = False):
        """Top-k rows by inner product. queries: [Q, D] numpy array or tensor,
        cast to the scoring dtype (the index dtype; bf16 for int8). Returns
        (values [Q, k] f32, rows [Q, k] int32) as numpy; padded rows, padded
        queries and tombstoned rows are excluded, and a k beyond the live
        rows pads with (-inf, row 0). Opens the proqa.search spans
        (utils/profiling.py) while a profiler collects. On a CUDA index the
        host heap grows in large steps from the first call on
        (utils/host_heap.py): callers keep the answers."""
        with span("proqa.search"):
            if self.device.type == "cuda":
                grow_in_large_steps()
            if self.n_deleted and not _skip_tombstones:
                # over-fetch so that k live rows survive the filter even if
                # every tombstoned row outscored them; the width is a power of
                # two, so accumulating removals launch few shapes
                k_fetch = min(self.n, _next_pow2(k + self.n_deleted))
                vals, idx = self.search(queries, k_fetch, exact=exact, q_pad=q_pad,
                                        _skip_tombstones=True)
                return self._filter_deleted(vals, idx, k)
            with span("proqa.search.upload"):
                q = torch.as_tensor(queries).to(self.device, self._query_dtype)
                q, q_n = pad_queries(q, q_pad)
            k_eff = min(k, self.n)
            search = (mips_topk if self.mesh is None
                      else functools.partial(sharded_mips_topk, mesh=self.mesh))
            vals, idx = search(q, self.embeddings, k_eff, exact=exact, n_valid=self.n,
                               scales=self.scales, quant_block=self.quant_block)
            with span("proqa.search.download"):
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
        mode="clip" does. A sharded index gathers each row from its shard."""
        r = rows.to(self.device).long().clamp(0, self.capacity - 1)
        if self.mesh is None:
            return _gather_rows(self.embeddings, self.scales, self.quant_block, r)
        local = self._first.shape[0]
        shard = r // local
        out = torch.empty(*r.shape, self.dim, dtype=torch.float32, device=self.device)
        for s, (rows_s, dev) in enumerate(zip(self.embeddings, self.mesh)):
            at = shard == s
            scales = None if self.scales is None else self.scales[s]
            out[at] = _gather_rows(rows_s, scales, self.quant_block,
                                   (r[at] - s * local).to(dev)).to(self.device)
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
    def load(cls, path: str, *, device: str | torch.device | None = None,
             dtype=torch.bfloat16, mesh: list | None = None) -> "DenseIndex":
        """`path` is a directory (embeddings.npy [+ idx_id.json]) or a bare
        .npy file, loaded onto `device` or row-sharded over `mesh`.
        dtype="int8" quantizes at load."""
        if os.path.isdir(path):
            emb_path = os.path.join(path, "embeddings.npy")
            map_path = os.path.join(path, "idx_id.json")
            id_map = IdMap.load(map_path) if os.path.exists(map_path) else None
        else:
            emb_path, id_map = path, None
        emb = np.load(emb_path, mmap_mode="r")
        return cls.from_embeddings(emb, id_map, device=device, dtype=dtype, mesh=mesh)


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
        q = torch.as_tensor(queries).to(self.device, self._query_dtype)
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
