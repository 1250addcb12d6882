"""Serving in the port against the JAX package: the MicroBatcher (twins of
tests/test_serving_batch.py), the `serve` command's HTTP server (a twin of
tests/test_cli.py::test_cli_serve_http) and `--use-ivf` on the QA commands,
in f32 on the CPU.

The server world is tests/test_torch_qa.py's shape at a smaller size: 4,500
paragraphs (past the 4,096-row naive-search cut, so the port searches
through K1's pipeline, its plain version on the CPU), a tiny QA checkpoint as
flax msgpack for the JAX CLI and as .npz for the port. Each package's server
gets its own copy of the sqlite store, since /add and /remove write to it.
"""
import json
import shutil
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from flax import serialization  # noqa: E402

from proqa_tpu.cli.main import (  # noqa: E402
    _qa_setup as jax_qa_setup, build_parser as jax_parser, main as jax_main,
)
from proqa_tpu.models.bert import BertConfig as JaxBertConfig  # noqa: E402
from proqa_tpu.models.reader import QAConfig as JaxQAConfig, init_qa_params  # noqa: E402
from proqa_tpu.qa.sampler import OnlineSampler as JaxSampler  # noqa: E402
from proqa_tpu.serving import make_qa_server as jax_make_qa_server  # noqa: E402
from proqa_tpu.serving import IndexUpdater as JaxIndexUpdater  # noqa: E402
from proqa_tpu.train.checkpoint import save_checkpoint  # noqa: E402
from proqa_tpu_torch.cli.main import _serve_setup, build_parser, main as torch_main  # noqa: E402
from proqa_tpu_torch.data.docdb import DocDB  # noqa: E402
from proqa_tpu_torch.index.dense import DenseIndex  # noqa: E402
from proqa_tpu_torch.index.idmap import IdMap  # noqa: E402
from proqa_tpu_torch.models.convert import save_npz  # noqa: E402
from proqa_tpu_torch.serving import MicroBatcher, warmup_buckets  # noqa: E402

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"tok{i}" for i in range(60)] + [
    "what", "is", "about",
]
N_PARAS, T, TQ = 4500, 64, 12
# `answer` rounds its scores to 4 decimals: one step either way
# (tests/test_torch_qa.py's bound); f32 embeddings of the tiny towers: 1e-5
ANSWER_ATOL, EMBED_ATOL = 2e-4, 1e-5


# ---------------- MicroBatcher (pure unit tests with a fake answer) ----------------

class Gate:
    """An answer_batch fake that records its batches and can block."""

    def __init__(self, fail_batches=()):
        self.calls = []
        self.entered = threading.Event()
        self.release = threading.Event()
        self.release.set()
        self.fail_batches = set(fail_batches)

    def __call__(self, items):
        self.calls.append(list(items))
        self.entered.set()
        assert self.release.wait(timeout=10)
        if len(self.calls) - 1 in self.fail_batches:
            raise RuntimeError("device fell over")
        return [{"question": q, "alpha": a, "topn": n} for q, a, n in items]


def _submit_async(b, item):
    out = {}

    def run():
        try:
            out["row"] = b.submit(*item)
        except Exception as e:  # noqa: BLE001 - recorded for the assertions
            out["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, out


def test_coalesces_requests_queued_during_dispatch():
    g = Gate()
    b = MicroBatcher(g, max_batch=16)
    try:
        g.release.clear()
        t0, r0 = _submit_async(b, ("q0", 0.8, 3))
        assert g.entered.wait(timeout=5)  # the worker is inside dispatch 0
        pending = [_submit_async(b, (f"q{i}", 0.5, 1)) for i in range(1, 6)]
        time.sleep(0.2)  # let the five arrivals queue behind the dispatch
        g.release.set()
        for t, _ in [(t0, r0)] + pending:
            t.join(timeout=10)
            assert not t.is_alive()
        assert r0["row"]["question"] == "q0" and r0["row"]["alpha"] == 0.8
        for i, (_, out) in enumerate(pending, start=1):
            assert out["row"] == {"question": f"q{i}", "alpha": 0.5, "topn": 1}
        assert [len(c) for c in g.calls] == [1, 5]  # one follow-up dispatch, not five
        assert b.stats == {"batches": 2, "items": 6, "max_batch_seen": 5}
    finally:
        b.close()


def test_lone_request_dispatches_immediately():
    g = Gate()
    b = MicroBatcher(g, max_batch=16)
    try:
        t0 = time.perf_counter()
        row = b.submit("solo", 0.8, 2)
        assert time.perf_counter() - t0 < 1.0  # no batching-window sleep
        assert row["question"] == "solo" and g.calls == [[("solo", 0.8, 2)]]
    finally:
        b.close()


def test_max_batch_splits_and_reassembles_in_order():
    g = Gate()
    b = MicroBatcher(g, max_batch=2)
    try:
        g.release.clear()
        t0, _ = _submit_async(b, ("head", 0.8, 3))
        assert g.entered.wait(timeout=5)
        items = [(f"q{i}", 0.1 * i, i + 1) for i in range(5)]
        big = {}
        tm = threading.Thread(target=lambda: big.update(rows=b.submit_many(items)), daemon=True)
        tm.start()
        time.sleep(0.2)
        g.release.set()
        tm.join(timeout=10)
        t0.join(timeout=10)
        assert not tm.is_alive() and not t0.is_alive()
        # 5 items through max_batch 2: drains of 2, 2 and 1, one ordered list back
        assert [len(c) for c in g.calls] == [1, 2, 2, 1]
        assert [r["question"] for r in big["rows"]] == [q for q, _, _ in items]
        assert [r["topn"] for r in big["rows"]] == [n for _, _, n in items]
    finally:
        b.close()


def test_error_propagates_to_its_batch_only():
    g = Gate(fail_batches={1})
    b = MicroBatcher(g, max_batch=16)
    try:
        g.release.clear()
        t0, r0 = _submit_async(b, ("ok", 0.8, 3))
        assert g.entered.wait(timeout=5)
        doomed = [_submit_async(b, (f"bad{i}", 0.8, 3)) for i in range(2)]
        time.sleep(0.2)
        g.release.set()
        t0.join(timeout=10)
        for t, _ in doomed:
            t.join(timeout=10)
            assert not t.is_alive()
        assert r0["row"]["question"] == "ok"
        for _, out in doomed:
            assert isinstance(out["err"], RuntimeError)
        assert b.submit("after", 0.8, 3)["question"] == "after"  # the batcher survives
    finally:
        b.close()


def test_closed_batcher_rejects_submits():
    b = MicroBatcher(lambda items: [{}] * len(items))
    b.close()
    with pytest.raises(RuntimeError):
        b.submit("late", 0.8, 3)


def test_warmup_buckets_ladder():
    assert warmup_buckets(16) == [1, 2, 4, 8, 16]
    assert warmup_buckets(1) == [1]
    assert warmup_buckets(5) == [1, 2, 4, 5]  # a cap that is no power of two ends the ladder
    assert warmup_buckets(0) == [1]           # a degenerate cap clamps to 1


def test_submit_many_empty_returns_empty():
    b = MicroBatcher(lambda items: [{}] * len(items))
    try:
        assert b.submit_many([]) == []
    finally:
        b.close()


# ---------------- the serve command's server against the JAX package's ----------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_world")
    (root / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    rng = np.random.default_rng(0)
    paras = []
    for i in range(N_PARAS):
        n = 1 if i % 3 == 0 else int(rng.integers(2, 13))
        paras.append((f"p{i}", " ".join(f"tok{t}" for t in rng.integers(0, 60, size=n))))
    DocDB.create(str(root / "docs.db"), paras)
    (root / "index").mkdir()
    emb = rng.standard_normal((N_PARAS, 128)).astype(np.float32) / np.sqrt(128)
    np.save(root / "index" / "embeddings.npy", emb)
    IdMap([pid for pid, _ in paras]).save(str(root / "index" / "idx_id.json"))
    params = init_qa_params(jax.random.PRNGKey(2), JaxBertConfig.tiny(initializer_range=0.3),
                            JaxQAConfig())
    save_checkpoint(str(root / "qa.msgpack"), params)
    with open(root / "qa.msgpack", "rb") as f:
        save_npz(str(root / "qa.npz"), jax.tree.map(np.asarray,
                                                    serialization.msgpack_restore(f.read())))
    return root


def _qa_args(world, ckpt, name):
    w = str(world)
    shutil.copy(f"{w}/docs.db", f"{w}/{name}.db")  # /add and /remove write to it
    return ["--vocab", f"{w}/vocab.txt", "--tiny", "--f32", "--max-seq-length", str(T),
            "--max-query-length", str(TQ), "--db", f"{w}/{name}.db", "--index", f"{w}/index",
            "--init-checkpoint", f"{w}/{ckpt}", "--eval-k", "3", "--candidates", "8",
            "--output-dir", f"{w}/{name}_run", "--topn", "2", "--port", "0",
            "--max-batch", "4"]


def _jax_server(world):
    """The JAX package's `serve` setup (proqa_tpu/cli/main.py:550-599), built
    in-process: that command has no setup function of its own."""
    import dataclasses

    args = jax_parser().parse_args(["serve", *_qa_args(world, "qa.msgpack", "jax_serve")])
    trainer, make_sampler = jax_qa_setup(args)
    probe = make_sampler([])
    cfg = dataclasses.replace(probe.cfg, question_batch=args.max_batch, pad_buckets=True)
    updater = JaxIndexUpdater(trainer, probe.tokenizer, probe.db, probe.index,
                              max_seq_length=args.max_seq_length)
    server = jax_make_qa_server(
        trainer, lambda raw: JaxSampler(raw, probe.tokenizer, probe.db, probe.index, cfg),
        port=0, topn=args.topn, updater=updater, max_batch=args.max_batch)
    return server, updater


class Client:
    def __init__(self, server):
        self.server = server
        host, port = server.server_address[:2]
        self.base = f"http://{host}:{port}"
        self.thread = threading.Thread(target=server.serve_forever, daemon=True)
        self.thread.start()

    def get(self, path):
        try:
            with urllib.request.urlopen(f"{self.base}{path}", timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def post(self, path, payload):
        req = urllib.request.Request(f"{self.base}{path}", data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"},
                                     method="POST")
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


def _assert_answers_close(got, want):
    got, want = (got, want) if isinstance(got, list) else ([got], [want])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "candidates"} == \
            {k: v for k, v in w.items() if k != "candidates"}
        assert len(g["candidates"]) == len(w["candidates"])
        for gc, wc in zip(g["candidates"], w["candidates"]):
            assert set(gc) == set(wc) and gc["answer"] == wc["answer"]
            assert gc["passage"] == wc["passage"]
            for key in ("score", "span_score", "rank_score"):
                assert gc[key] == pytest.approx(wc[key], abs=ANSWER_ATOL), key


def test_cli_serve_http(world):
    """The port's serve setup against the JAX server on the same world and
    weights: /healthz, GET and POST /answer (rows equal the JAX server's),
    /stats, the input validation, then /add (the stored row equals a fresh
    encode and the JAX server's added row; the live search equals a rebuilt
    index's; an upsert tombstones the old row) and /remove (the removed id
    leaves every candidate), over real localhost sockets."""
    args = build_parser().parse_args(["serve", *_qa_args(world, "qa.npz", "torch_serve"),
                                      "--device", "cpu", "--warmup", "what is about tok1"])
    server = _serve_setup(args)
    tsrv = Client(server)
    jserver, jupdater = _jax_server(world)
    jsrv = Client(jserver)
    try:
        # --warmup answered once at each bucket of --max-batch 4 before any request
        assert tsrv.get("/stats") == (200, {"batches": 0, "items": 0, "max_batch_seen": 0,
                                            "index_rows": N_PARAS})
        assert tsrv.get("/healthz") == (200, {"status": "ok"})
        for path, body in (("/answer?q=what+is+about+tok3", None),
                           ("/answer", {"question": "what is about tok5", "topn": 1}),
                           ("/answer", {"questions": ["what is about tok1",
                                                      "what is about tok2 tok40"],
                                        "alpha": 0.3})):
            (ts, trow), (js, jrow) = ((c.get(path) if body is None else c.post(path, body))
                                      for c in (tsrv, jsrv))
            assert ts == js == 200
            _assert_answers_close(trow, jrow)
        status, stats = tsrv.get("/stats")
        assert status == 200 and stats["items"] == 4 and stats["batches"] >= 1
        assert stats["max_batch_seen"] >= 2 and stats["index_rows"] == N_PARAS

        for body in ({}, {"questions": ["", "x"]}, {"questions": []},
                     {"question": "x", "alpha": "high"}, {"question": "x", "topn": None},
                     {"question": "x", "topn": 0}, {"question": "x", "topn": -1}, 3):
            assert tsrv.post("/answer", body)[0] == 400, body
        assert tsrv.get("/answer?q=%20")[0] == 400
        status, err = tsrv.get("/nope")
        assert status == 404 and "no route" in err["error"]

        # ---- live index updates: /add, then /remove, no restart ----
        index = server.updater.index
        new_text = "tok50 tok51 tok52 tok53 tok54"
        for c in (tsrv, jsrv):
            status, out = c.post("/add", {"paras": [{"id": "live0", "text": new_text}]})
            assert status == 200 and out == {"added": 1, "index_rows": N_PARAS + 1}
        assert len(index) == N_PARAS + 1 and index.version == 1
        assert DocDB(str(world / "torch_serve.db")).get_doc_text("live0") == new_text
        new_emb = index.take([index.n - 1])
        fresh = server.updater._encode_texts([new_text])
        np.testing.assert_array_equal(new_emb, fresh)  # f32 index: no rounding
        jnew = np.asarray(jupdater.index.take([jupdater.index.n - 1]))
        np.testing.assert_allclose(new_emb, jnew, rtol=0, atol=EMBED_ATOL)
        rebuilt = DenseIndex.from_embeddings(index.take(np.arange(index.n)),
                                             IdMap(index.id_map.rows_to_ids(range(index.n))),
                                             device="cpu", dtype=torch.float32)
        lv, li = index.search(new_emb, 5)
        rv, ri = rebuilt.search(new_emb, 5)
        np.testing.assert_array_equal(li, ri)
        np.testing.assert_array_equal(lv, rv)
        _, full = index.search(new_emb, len(index))
        assert "live0" in index.id_map.rows_to_ids(full[0])
        status, row = tsrv.get("/answer?q=what+is+about+tok50")
        assert status == 200 and row["candidates"]
        _assert_answers_close(row, jsrv.get("/answer?q=what+is+about+tok50")[1])

        # an upsert of live0: the old row is tombstoned, one live row remains
        status, out = tsrv.post("/add", {"paras": [{"id": "live0", "text": "tok1 tok2"}]})
        assert status == 200 and out == {"added": 1, "index_rows": N_PARAS + 1}
        assert index.live_rows(["live0"]) == [index.n - 1] and index.n_deleted == 1

        status, out = tsrv.post("/remove", {"ids": ["live0", "p7"]})
        assert status == 200 and out == {"removed": 2, "index_rows": N_PARAS - 1}
        assert DocDB(str(world / "torch_serve.db")).get_doc_text("live0") is None
        removed = {"live0", "p7"}
        for q in ("what is about tok50", "what is about tok7", "what is about tok1 tok2"):
            emb = server.updater._encode_texts([q])
            _, rows = index.search(emb, 64)
            assert not removed & set(index.id_map.rows_to_ids(rows[0]))
        status, row = tsrv.get("/answer?q=what+is+about+tok3")
        assert status == 200 and row["candidates"]

        for body in ({"paras": []}, {"paras": [{"id": "x"}]}):
            assert tsrv.post("/add", body)[0] == 400
        assert tsrv.post("/remove", {"ids": []})[0] == 400
        assert tsrv.post("/remove", {"ids": ["never-there"]})[1]["removed"] == 0
    finally:
        tsrv.close()
        jsrv.close()


def test_cli_answer_use_ivf_matches_jax(world, capsys):
    """`answer --use-ivf` through both CLIs at full probe (nprobe = nlist
    scans every row, so each package's IVF, whatever its k-means draws,
    returns the exact top rows): the rows equal the JAX CLI's and the port's
    exact answer; a server over the IVF view refuses /add with a 400."""
    w = str(world)
    common = ["--vocab", f"{w}/vocab.txt", "--tiny", "--f32", "--max-seq-length", str(T),
              "--max-query-length", str(TQ), "--db", f"{w}/docs.db", "--index", f"{w}/index",
              "--eval-k", "3", "--topn", "2", "--question", "what is about tok3 tok9",
              "--question", "what is about tok51"]
    ivf = ["--use-ivf", "--ivf-nlist", "4", "--ivf-nprobe", "4"]
    rows = {}
    for name, main, ckpt, extra in (
            ("jax", jax_main, "qa.msgpack", ivf),
            ("torch", torch_main, "qa.npz", ["--device", "cpu", *ivf]),
            ("torch_exact", torch_main, "qa.npz", ["--device", "cpu"])):
        main(["answer", *common, "--init-checkpoint", f"{w}/{ckpt}",
              "--output-dir", f"{w}/{name}_ivf", *extra])
        rows[name] = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()
                      if line.startswith("{")]
    assert len(rows["torch"]) == 2
    _assert_answers_close(rows["torch"], rows["jax"])
    _assert_answers_close(rows["torch"], rows["torch_exact"])

    args = build_parser().parse_args(["serve", *_qa_args(world, "qa.npz", "ivf_serve"),
                                      "--device", "cpu", *ivf])
    db_path = f"{w}/ivf_serve.db"
    with DocDB(db_path) as db:
        before = {d: db.get_doc_text(d) for d in db.get_doc_ids()}
    srv = Client(_serve_setup(args))
    try:
        # a new id and a replaced one: refused before the DocDB is written
        status, err = srv.post("/add", {"paras": [{"id": "x1", "text": "tok1"},
                                                  {"id": "p1", "text": "tok2 tok3"}]})
        assert status == 400 and "to_ivf" in err["error"]
        status, err = srv.post("/remove", {"ids": ["p2"]})
        assert status == 400 and "to_ivf" in err["error"]
        assert srv.get("/answer?q=what+is+about+tok3")[0] == 200
    finally:
        srv.close()
    with DocDB(db_path) as db:
        assert {d: db.get_doc_text(d) for d in db.get_doc_ids()} == before


def test_index_updater_refuses_an_ivf_view_before_any_write():
    """IndexUpdater over an IVF view: add and remove raise ValueError before
    they encode or touch the DocDB (the view cannot mutate, and a text
    written first would be an orphan, or would display for a row still
    scored by the old embedding)."""
    from proqa_tpu_torch.serving import IndexUpdater

    rng = np.random.default_rng(3)
    dense = DenseIndex.from_embeddings(rng.standard_normal((64, 16)).astype(np.float32),
                                       IdMap([f"d{i}" for i in range(64)]), device="cpu",
                                       dtype=torch.float32)
    dense.check_mutable()  # the dense index takes updates

    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError(f"touched {name}")

    updater = IndexUpdater(Untouchable(), Untouchable(), Untouchable(),
                           dense.to_ivf(nlist=4, nprobe=4, niter=2))
    with pytest.raises(ValueError, match="to_ivf"):
        updater.add([{"id": "d1", "text": "tok1"}, {"id": "new", "text": "tok2"}])
    with pytest.raises(ValueError, match="to_ivf"):
        updater.remove(["d1"])
    assert updater.index.version == 0 and updater.index.n_deleted == 0
