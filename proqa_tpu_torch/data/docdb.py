"""Sqlite paragraph store.

Copy of proqa_tpu/data/docdb.py: the port keeps its own host code and imports
nothing of the JAX package.

Equivalent of the reference DocDB (upstream retrieval/utils.py:68-105):
a `documents(id PRIMARY KEY, text)` table (e.g. nq_paras.db). Differences:
thread-local connections (the reference shares one connection with
check_same_thread=False and relies on fork-pool initializers to avoid races —
qa/utils.py:84, eval_retrieval.py:19-24), an LRU row cache for the QA online
sampler's hot lookups, and a writer classmethod for tests/converters.
"""
from __future__ import annotations

import sqlite3
import threading
from functools import lru_cache


class DocDB:
    def __init__(self, db_path: str, cache_size: int = 1 << 16):
        self.path = db_path
        self._local = threading.local()
        self._get_cached = lru_cache(maxsize=cache_size)(self._get_doc_text)
        self._conn()  # fail fast on a bad path

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path)
            self._local.conn = conn
        return conn

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    def close(self):
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None

    def get_doc_ids(self) -> list[str]:
        cursor = self._conn().execute("SELECT id FROM documents")
        ids = [r[0] for r in cursor.fetchall()]
        cursor.close()
        return ids

    def _get_doc_text(self, doc_id: str):
        cursor = self._conn().execute(
            "SELECT text FROM documents WHERE id = ?", (doc_id,)
        )
        result = cursor.fetchone()
        cursor.close()
        return result if result is None else result[0]

    def get_doc_text(self, doc_id: str):
        return self._get_cached(doc_id)

    def __len__(self) -> int:
        cursor = self._conn().execute("SELECT COUNT(*) FROM documents")
        (n,) = cursor.fetchone()
        cursor.close()
        return n

    def add_docs(self, docs) -> None:
        """Upsert (id, text) pairs — the serving-time /add path. Clears the
        text cache so a replaced id can't serve its stale text."""
        conn = self._conn()
        conn.executemany(
            "INSERT OR REPLACE INTO documents VALUES (?, ?)", list(docs)
        )
        conn.commit()
        self._get_cached.cache_clear()

    def remove_docs(self, doc_ids) -> int:
        """Delete stored texts (the serving-time /remove path); returns the
        number of rows deleted."""
        conn = self._conn()
        cur = conn.executemany(
            "DELETE FROM documents WHERE id = ?", [(i,) for i in doc_ids]
        )
        conn.commit()
        n = cur.rowcount
        cur.close()
        self._get_cached.cache_clear()
        return max(n, 0)

    @classmethod
    def create(cls, db_path: str, docs) -> "DocDB":
        """Build a store from an iterable of (id, text) pairs."""
        conn = sqlite3.connect(db_path)
        conn.execute("CREATE TABLE documents (id PRIMARY KEY, text)")
        conn.executemany("INSERT INTO documents VALUES (?, ?)", docs)
        conn.commit()
        conn.close()
        return cls(db_path)
