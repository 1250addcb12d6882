"""Index-row <-> document-id mapping.

Counterpart of proqa_tpu/index/idmap.py (which cannot be imported without
JAX: its package __init__ imports the device index). Dense index row i maps to
the doc id of the paragraph encoded into that row. The on-disk artifact,
`idx_id.json` = {"0": id0, "1": id1, ...}, is written byte for byte as the
JAX package writes it.
"""
from __future__ import annotations

import json
from typing import Iterable, Sequence


class IdMap:
    def __init__(self, ids: Sequence[str]):
        self._ids = list(ids)

    def __len__(self) -> int:
        return len(self._ids)

    def __getitem__(self, row: int) -> str:
        return self._ids[row]

    def rows_to_ids(self, rows: Iterable[int]) -> list[str]:
        return [self._ids[int(r)] for r in rows]

    def ids_to_rows(self, doc_ids: Iterable[str]) -> list[int]:
        """ALL row indices of the given doc ids (unknown ids skipped; a
        duplicated doc id maps to every row carrying it). The inverse is built
        on first use and cached: the QA sampler turns each question's gold
        paragraph ids into a row set once, then labels candidates by isin."""
        inv = getattr(self, "_inv", None)
        if inv is None:
            inv = self._inv = {}
            for i, d in enumerate(self._ids):
                inv.setdefault(d, []).append(i)
        out: list[int] = []
        for d in doc_ids:
            out.extend(inv.get(d, ()))
        return out

    def extend(self, doc_ids: Iterable[str]) -> None:
        """Append the ids of rows added to the index (DenseIndex.add); drops
        the cached inverse so that ids_to_rows sees the new rows."""
        self._ids.extend(doc_ids)
        if hasattr(self, "_inv"):
            del self._inv

    @classmethod
    def from_doc_ids(cls, doc_ids: Iterable[str]) -> "IdMap":
        return cls(list(doc_ids))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({str(i): d for i, d in enumerate(self._ids)}, f)

    @classmethod
    def load(cls, path: str) -> "IdMap":
        with open(path) as f:
            raw = json.load(f)
        return cls([raw[str(i)] for i in range(len(raw))])
