"""HTTP serving for open-domain QA: the warm retrieve -> read -> extract path
(`QATrainer.answer`) behind a threaded stdlib HTTP server, with live corpus
updates.

Copy of proqa_tpu/serving.py (the reference has no serving layer): the port
keeps its own host code and imports nothing of the JAX package. The model,
the device-resident index and the kernels stay warm across requests; a
request costs one query-tower encode and search (kernels K1 and K6, K5 over
an int8 index) and one reader forward (K2 at T % 128 == 0).

Endpoints:
  GET  /healthz              -> {"status": "ok"}
  GET  /stats                -> micro-batcher counters + live index rows
  GET  /answer?q=<question>  -> answer row (see below)
  POST /answer {"question": ..., "topn"?: int, "alpha"?: float}
  POST /answer {"questions": [...]}   (batched: list of rows)
  POST /add    {"paras": [{"id": ..., "text": ...}, ...]}   (live updates)
  POST /remove {"ids": [...]}

Answer row: {"question", "answer", "alpha", "candidates": [{"answer",
"score", "span_score", "rank_score", "passage"}]}.

/add and /remove change the live corpus without a restart or a rebuild
(IndexUpdater -> DenseIndex.add / remove_rows and DocDB upserts): new
paragraphs are encoded by the live context tower and are retrievable by the
next /answer; removed ones stop being retrievable exactly (tombstones,
index/dense.py).

Concurrent /answer requests are micro-batched (MicroBatcher): the worker
drains whatever queued during the dispatch in flight and serves up to
--max-batch questions with one encode + search + read; a lone request
dispatches at once. Per-request alpha/topn survive batching (host-side
decode parameters). Index mutations hold the lock dispatches hold: the
handler threads, the batcher's worker and every mutation share one CUDA
stream, and no search may see a half-written index.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from proqa_tpu_torch.data.collate import pad_bucket


class _Server(ThreadingHTTPServer):
    """ThreadingHTTPServer with a listen backlog of 128 connections. The
    stdlib's 5 drops the SYNs of a burst's later clients, which retry only
    after a second: on an NVIDIA H100 80GB HBM3 at 700 W, a burst of 16
    concurrent /answer requests took 1.1 s at p99 behind the default, and
    0.19-0.27 s with 128."""

    request_queue_size = 128


class MicroBatcher:
    """Coalesce concurrent /answer requests into one device dispatch.

    Backpressure batching, no artificial wait: the worker drains whatever is
    queued and dispatches it; requests arriving DURING a dispatch queue up
    and ride the next one. The dispatch in flight is the batching window, so
    a lone request dispatches immediately (no added latency) while a loaded
    server amortizes one encode+search+read over up to `max_batch`
    questions. Per-request
    alpha/topn are honored inside a shared batch (QATrainer.answer applies
    them host-side after the device work).

    Thread-safe; one daemon worker per server. `stats` counts (batches,
    items) for observability and tests."""

    _STOP = object()

    def __init__(self, answer_batch, max_batch: int = 16):
        self._answer_batch = answer_batch   # list[(question, alpha, topn)] -> rows
        self.max_batch = max(1, int(max_batch))
        self._cv = threading.Condition()
        self._queue: list = []              # [(item, slot)] — slot: [event, out, err]
        self._stopped = False
        self.stats = {"batches": 0, "items": 0, "max_batch_seen": 0}
        self._worker = threading.Thread(
            target=self._run, name="proqa-microbatcher", daemon=True
        )
        self._worker.start()

    def submit_many(self, items: list[tuple]) -> list[dict]:
        """Enqueue [(question, alpha, topn)] as one unit and wait. A batched
        POST stays contiguous so its questions share a dispatch (subject to
        max_batch splitting)."""
        if not items:
            return []
        slot = [threading.Event(), None, None]
        with self._cv:
            if self._stopped:
                raise RuntimeError("server is shutting down")
            self._queue.extend((it, slot, i) for i, it in enumerate(items))
            slot[1] = [None] * len(items)
            self._cv.notify()
        slot[0].wait()
        if slot[2] is not None:
            raise slot[2]
        return slot[1]

    def submit(self, question: str, alpha: float, topn: int) -> dict:
        return self.submit_many([(question, alpha, topn)])[0]

    def close(self):
        with self._cv:
            self._stopped = True
            self._cv.notify()
        self._worker.join(timeout=5)

    def _run(self):
        while True:
            with self._cv:
                while not self._queue and not self._stopped:
                    self._cv.wait()
                if self._stopped and not self._queue:
                    return
                # skip items whose slot already failed (a submit_many larger
                # than max_batch splits across drains; once an early drain
                # errored the caller has been failed — dispatching the
                # remainder would waste device work on discarded results)
                batch = []
                while self._queue and len(batch) < self.max_batch:
                    entry = self._queue.pop(0)
                    if entry[1][2] is None:
                        batch.append(entry)
            if not batch:
                continue
            items = [it for it, _, _ in batch]
            try:
                rows = self._answer_batch(items)
                err = None
                if len(rows) != len(items):  # pragma: no cover - invariant
                    err = RuntimeError(
                        f"answer returned {len(rows)} rows for {len(items)}"
                    )
            except Exception as e:
                rows, err = None, e
            self.stats["batches"] += 1
            self.stats["items"] += len(items)
            self.stats["max_batch_seen"] = max(
                self.stats["max_batch_seen"], len(items)
            )
            for bi, (_, slot, pos) in enumerate(batch):
                if err is not None:
                    slot[2] = err
                else:
                    slot[1][pos] = rows[bi]
            # a slot completes when all its items have results (a request
            # split across two drains by max_batch finishes on the later one)
            for _, slot, _ in batch:
                if slot[2] is not None or all(r is not None for r in slot[1]):
                    slot[0].set()


def warmup_buckets(cap: int) -> list[int]:
    """The distinct power-of-two batch buckets a `--max-batch cap` server can
    dispatch ([1, 2, 4, ..., cap]); `proqa-torch serve --warmup` runs one
    answer at each before the server takes traffic, so the first requests
    do not pay the allocator's and the kernels' first-call costs."""
    out, b = [], 1
    while True:
        b = pad_bucket(b, max(1, cap))
        if out and b == out[-1]:
            return out
        out.append(b)
        b += 1


class IndexUpdater:
    """Serving-time corpus mutation: tokenize and encode new paragraph texts
    with the LIVE context tower, append them to the device index and the
    DocDB; removals tombstone index rows and delete the stored text.

    Encoding pads row counts to powers of two at a fixed sequence length,
    so repeated small /add calls launch a handful of shapes."""

    MAX_BATCH = 256  # rows encoded per forward

    def __init__(self, trainer, tokenizer, db, index, max_seq_length: int = 288):
        self.trainer, self.tok, self.db, self.index = trainer, tokenizer, db, index
        self.max_len = max_seq_length

    def _check_index(self) -> None:
        """Refuse a request the index cannot take before anything is written,
        so a refused /add or /remove leaves the DocDB as it was."""
        if self.index.id_map is None:
            raise ValueError("index has no idx_id.json — live updates need "
                             "the row<->doc-id map")
        self.index.check_mutable()

    def _encode_texts(self, texts: list[str]) -> np.ndarray:
        """[len(texts), D] f32 host embeddings from the trainer's live
        context tower, in inference mode with no dropout, under the
        trainer's lock (a train step updates the weights in place)."""
        retriever, device = self.trainer.model.retriever, self.trainer.device
        out = []
        for start in range(0, len(texts), self.MAX_BATCH):
            chunk = texts[start:start + self.MAX_BATCH]
            rows = [self.tok.encode(t, max_length=self.max_len) for t in chunk]
            b = len(rows)
            bp = 1 << max(b - 1, 0).bit_length()
            ids = np.zeros((bp, self.max_len), np.int64)
            mask = np.zeros((bp, self.max_len), np.int32)
            mask[:, 0] = 1  # pad rows attend [CLS] only (no all-masked rows)
            for i, r in enumerate(rows):
                ids[i, : len(r)] = r
                mask[i, : len(r)] = 1
            with torch.inference_mode(), self.trainer._lock:
                emb = retriever.encode_context(torch.from_numpy(ids).to(device),
                                               torch.from_numpy(mask).to(device),
                                               deterministic=True)
                out.append(emb.float().cpu().numpy()[:b])
        return np.concatenate(out)

    def add(self, paras: list[dict]) -> int:
        """paras: [{"id": ..., "text": ...}]. Returns rows added. An id
        already in the index is REPLACED: its live rows are tombstoned once
        the new row has landed (under the dispatch lock), so the old text's
        embedding can never rank a candidate that is then displayed as the
        new text, and no doc id maps to two live rows (upsert — FAISS itself
        has no id-replace; this matches the DocDB upsert the texts get). Raises ValueError on
        malformed input, duplicate ids within one request, or an unsupported
        index (an IVF view does not mutate — see IVFDenseIndex)."""
        if not paras or not all(
            isinstance(p, dict) and p.get("text") and "id" in p for p in paras
        ):
            raise ValueError("paras must be [{'id': ..., 'text': ...}, ...]")
        self._check_index()
        ids = [str(p["id"]) for p in paras]
        if len(set(ids)) != len(ids):
            raise ValueError("duplicate ids within one add request")
        texts = [str(p["text"]) for p in paras]
        emb = self._encode_texts(texts)
        # DB first: if the index mutation fails mid-way the worst outcome is
        # an orphan text row, never a retrievable embedding without text
        self.db.add_docs(zip(ids, texts))
        # add the new rows BEFORE tombstoning the stale ones: /add runs under
        # the same lock as search dispatches, so no reader can observe the
        # transient two-live-rows state — and if add raises (e.g. a failed
        # allocation while the capacity grows) the OLD rows stay retrievable
        # instead of the doc vanishing from the index
        stale = self.index.live_rows(ids)
        self.index.add(emb, ids=ids)
        if stale:
            self.index.remove_rows(stale)  # replace, don't shadow
        return len(ids)

    def remove(self, doc_ids: list) -> int:
        """Tombstones every index row carrying the given doc ids and deletes
        the stored texts of ids actually present in the index — an id known
        only to the DocDB keeps its text (a removed=0 response must not
        silently destroy unrelated stored documents). Returns rows removed."""
        if not doc_ids or not all(isinstance(i, (str, int)) for i in doc_ids):
            raise ValueError("ids must be a non-empty list of doc ids")
        self._check_index()
        doc_ids = [str(i) for i in doc_ids]
        found = [d for d in doc_ids if self.index.live_rows([d])]
        n = self.index.remove_rows(
            self.index.live_rows(found)) if found else 0
        if found:
            self.db.remove_docs(found)
        return n


def make_qa_server(
    trainer,
    make_sampler,
    host: str = "127.0.0.1",
    port: int = 8080,
    alpha: float = 0.8,
    topn: int = 3,
    logger=None,
    updater: IndexUpdater | None = None,
    max_batch: int = 16,
) -> ThreadingHTTPServer:
    """Build (not start) the server. Call .serve_forever() to run; tests use
    port=0 for an ephemeral port and .shutdown() from another thread.

    Concurrent /answer requests are micro-batched (MicroBatcher): up to
    `max_batch` questions share one encode+search+read dispatch, with
    per-request alpha/topn applied host-side."""
    lock = threading.Lock()

    def _answer_batch(items: list[tuple]) -> list[dict]:
        sampler = make_sampler([{"question": q} for q, _, _ in items])
        with lock:  # mutations (/add, /remove) serialize with dispatches
            return trainer.answer(
                sampler,
                alpha=[a for _, a, _ in items],
                topn=[n for _, _, n in items],
            )

    batcher = MicroBatcher(_answer_batch, max_batch=max_batch)

    def _answer(questions: list[str], a: float, n: int) -> list[dict]:
        return batcher.submit_many([(q, a, n) for q in questions])

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route to our logger, not stderr
            if logger:
                logger.info("serve: " + fmt % args)

        def _send(self, code: int, payload):
            body = json.dumps(payload, ensure_ascii=False).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/healthz":
                return self._send(200, {"status": "ok"})
            if url.path == "/stats":
                out = dict(batcher.stats)
                if updater is not None:
                    out["index_rows"] = len(updater.index)
                return self._send(200, out)
            if url.path == "/answer":
                qs = parse_qs(url.query)
                if "q" not in qs:
                    return self._send(400, {"error": "missing query param 'q'"})
                if not all(q.strip() for q in qs["q"]):
                    return self._send(400, {"error": "questions must be non-empty"})
                try:
                    rows = _answer(qs["q"], alpha, topn)
                except Exception as e:  # pragma: no cover - defensive
                    return self._send(500, {"error": f"{type(e).__name__}: {e}"})
                return self._send(200, rows[0] if len(rows) == 1 else rows)
            return self._send(404, {"error": f"no route {url.path}"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path not in ("/answer", "/add", "/remove"):
                return self._send(404, {"error": f"no route {url.path}"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                return self._send(400, {"error": f"bad json: {e}"})
            if not isinstance(req, dict):
                return self._send(400, {"error": "body must be a json object"})
            if url.path in ("/add", "/remove"):
                if updater is None:
                    return self._send(
                        400, {"error": "live index updates are not enabled "
                                       "on this server (no updater)"}
                    )
                try:
                    with lock:  # mutations share the device lock with /answer
                        if url.path == "/add":
                            n = updater.add(req.get("paras"))
                            out = {"added": n}
                        else:
                            n = updater.remove(req.get("ids"))
                            out = {"removed": n}
                        out["index_rows"] = len(updater.index)
                except ValueError as e:
                    return self._send(400, {"error": str(e)})
                except Exception as e:  # pragma: no cover - defensive
                    return self._send(500, {"error": f"{type(e).__name__}: {e}"})
                return self._send(200, out)
            if "question" in req:
                questions, single = [req["question"]], True
            elif "questions" in req and isinstance(req["questions"], list):
                questions, single = list(req["questions"]), False
            else:
                return self._send(
                    400, {"error": "provide 'question' or 'questions' list"}
                )
            if not questions or not all(
                isinstance(q, str) and q.strip() for q in questions
            ):
                return self._send(400, {"error": "questions must be non-empty strings"})
            try:
                a = float(req.get("alpha", alpha))
                n = int(req.get("topn", topn))
            except (TypeError, ValueError) as e:
                return self._send(400, {"error": f"bad alpha/topn: {e}"})
            if n < 1:
                return self._send(400, {"error": f"topn must be >= 1, got {n}"})
            try:
                rows = _answer(questions, a, n)
            except Exception as e:  # pragma: no cover - defensive
                return self._send(500, {"error": f"{type(e).__name__}: {e}"})
            return self._send(200, rows[0] if single else rows)

    server = _Server((host, port), Handler)
    # exposed for stats, tests and the smoke test; the batcher closes on shutdown
    server.batcher, server.updater, server.make_sampler = batcher, updater, make_sampler
    _orig_shutdown = server.shutdown

    def _shutdown():
        _orig_shutdown()
        batcher.close()

    server.shutdown = _shutdown
    return server
