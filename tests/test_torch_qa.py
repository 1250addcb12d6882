"""The QA answering slice end to end: the JAX package and the port run the
online sampler, QATrainer.predict / answer and the `eval-qa`, `answer` and
`match-paras` commands on one synthetic world from one checkpoint, in f32,
and must agree.

The index has 4,500 rows (seeded random embeddings written as
embeddings.npy and idx_id.json), so the padded index (5,120 rows) is past the
4,096-row naive-search cut: the port searches through kernel K1's pipeline
(its plain version on the CPU). A third of the paragraphs are one word long,
so the best span of such a paragraph is its word, and EM is neither 0 nor 1.
`--tiny` caps positions at 64 (BertConfig.tiny), so the reader runs at
T = 64; T = 128 (K2's path) is covered by tests/test_torch_reader.py.
"""
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from proqa_tpu.cli.main import main as jax_main  # noqa: E402
from proqa_tpu.data.docdb import DocDB as JaxDocDB  # noqa: E402
from proqa_tpu.index.dense import DenseIndex as JaxDenseIndex  # noqa: E402
from proqa_tpu.models.bert import BertConfig as JaxBertConfig  # noqa: E402
from proqa_tpu.models.reader import QAConfig as JaxQAConfig, init_qa_params  # noqa: E402
from proqa_tpu.models.retriever import encode_query  # noqa: E402
from proqa_tpu.qa.sampler import (  # noqa: E402
    OnlineSampler as JaxSampler, OnlineSamplerConfig as JaxSamplerConfig,
)
from proqa_tpu.text.wordpiece import BertTokenizer as JaxTokenizer  # noqa: E402
from proqa_tpu.train.checkpoint import save_checkpoint  # noqa: E402
from proqa_tpu.train.qa_trainer import (  # noqa: E402
    QATrainer as JaxQATrainer, QATrainerConfig as JaxQATrainerConfig,
)
from proqa_tpu_torch.cli.main import main as torch_main  # noqa: E402
from proqa_tpu_torch.data.docdb import DocDB  # noqa: E402
from proqa_tpu_torch.index.dense import DenseIndex  # noqa: E402
from proqa_tpu_torch.index.idmap import IdMap  # noqa: E402
from proqa_tpu_torch.models.bert import BertConfig  # noqa: E402
from proqa_tpu_torch.models.convert import load_npz, params_from_jax, save_npz  # noqa: E402
from proqa_tpu_torch.models.reader import QAConfig  # noqa: E402
from proqa_tpu_torch.ops import mips_kernel  # noqa: E402
from proqa_tpu_torch.qa.sampler import OnlineSampler, OnlineSamplerConfig  # noqa: E402
from proqa_tpu_torch.text.wordpiece import BertTokenizer  # noqa: E402
from proqa_tpu_torch.train.qa_trainer import QATrainer, QATrainerConfig  # noqa: E402

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"tok{i}" for i in range(60)] + [
    "what", "is", "about",
]
N_PARAS, N_QUESTIONS, T, TQ = 4500, 20, 64, 12
# f32 on both sides, other summation orders: the span and rank scores agree
# to ~1e-6 (tests/test_torch_reader.py holds the forward at 1e-4)
SCORE_ATOL = 1e-4
ANSWER_ATOL = 2e-4  # `answer` rounds its scores to 4 decimals: one step either way


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("qa_world")
    (root / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    rng = np.random.default_rng(0)
    paras = []
    for i in range(N_PARAS):
        n = 1 if i % 3 == 0 else int(rng.integers(2, 13))
        paras.append((f"p{i}", " ".join(f"tok{t}" for t in rng.integers(0, 60, size=n))))
    with open(root / "corpus.jsonl", "w") as f:
        for pid, text in paras:
            f.write(json.dumps({"text": text, "id": pid}) + "\n")
    DocDB.create(str(root / "docs.db"), paras)
    (root / "index").mkdir()
    emb = rng.standard_normal((N_PARAS, 128)).astype(np.float32) / np.sqrt(128)
    np.save(root / "index" / "embeddings.npy", emb)
    IdMap([pid for pid, _ in paras]).save(str(root / "index" / "idx_id.json"))
    with open(root / "qa.jsonl", "w") as f:
        for i in range(N_QUESTIONS):
            a, b = rng.integers(0, 60, size=2)
            gold = [] if i == 7 else [f"tok{t}" for t in rng.choice(60, 12, replace=False)]
            f.write(json.dumps({"question": f"what is about tok{a} tok{b}",
                                "answer": gold}) + "\n")
    # one tiny QA checkpoint: flax msgpack for the JAX CLI, .npz for the port
    # a wide init (0.02 gives every question nearly the same embedding)
    params = init_qa_params(jax.random.PRNGKey(2), JaxBertConfig.tiny(initializer_range=0.3),
                            JaxQAConfig())
    save_checkpoint(str(root / "qa.msgpack"), params)
    with open(root / "qa.msgpack", "rb") as f:
        save_npz(str(root / "qa.npz"), jax.tree.map(np.asarray,
                                                    serialization.msgpack_restore(f.read())))
    return root


def _qa_rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture(scope="module")
def stacks(world):
    """The JAX and the port QA stacks over the same files: (trainer, sampler
    factory, query encoder) each."""
    w = str(world)
    jcfg = JaxBertConfig.tiny(dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, load_npz(w + "/qa.npz"))
    jtrainer = JaxQATrainer(jcfg, JaxQAConfig(), JaxQATrainerConfig(
        eval_k=3, questions_per_batch=8, output_dir=w + "/jax_run", prefetch_batches=2),
        params=params)
    jindex = JaxDenseIndex.load(w + "/index", dtype=jnp.float32)
    jtok = JaxTokenizer.from_vocab_file(w + "/vocab.txt")
    jdb = JaxDocDB(w + "/docs.db")

    ttrainer = QATrainer(BertConfig.tiny(dtype=torch.float32), QAConfig(), QATrainerConfig(
        eval_k=3, questions_per_batch=8, output_dir=w + "/torch_run", prefetch_batches=2),
        params=params_from_jax(load_npz(w + "/qa.npz")), device="cpu")
    tindex = DenseIndex.load(w + "/index", device="cpu", dtype=torch.float32)
    ttok = BertTokenizer.from_vocab_file(w + "/vocab.txt")
    tdb = DocDB(w + "/docs.db")

    def samplers(raw, matched="", **kw):
        kw = dict(max_query_length=TQ, max_length=T, candidates=16, max_spans=4,
                  question_batch=8, exact_search=True, **kw)
        return (JaxSampler(raw, jtok, jdb, jindex, JaxSamplerConfig(**kw), matched),
                OnlineSampler(raw, ttok, tdb, tindex, OnlineSamplerConfig(**kw), matched))

    def jenc(ids, mask):
        return encode_query(params["retriever"], jcfg, jnp.asarray(ids), jnp.asarray(mask))

    return {"jax": jtrainer, "torch": ttrainer, "samplers": samplers, "jenc": jenc,
            "tenc": ttrainer.query_encoder()}


def _assert_batches_equal(jb, tb):
    assert set(tb) == set(jb)
    assert set(tb["net_input"]) == set(jb["net_input"])
    for key, want in jb["net_input"].items():
        got = tb["net_input"][key]
        assert got.shape == want.shape and got.dtype == want.dtype, key
        # ids and masks, and para_embed: the same f32 rows of the same index
        np.testing.assert_array_equal(got, want, err_msg=key)
    for key in jb:
        if key != "net_input":
            assert tb[key] == jb[key], key


def _gold_file(world) -> str:
    """Matched paragraphs for every question of qa.jsonl: every 7th one."""
    gold = world / "gold.jsonl"
    with open(gold, "w") as f:
        for qa in _qa_rows(world / "qa.jsonl"):
            f.write(json.dumps({"question": qa["question"], "matched_paras": {
                f"p{i}": a for i in range(0, N_PARAS, 7) for a in qa["answer"][:1]}}) + "\n")
    return str(gold)


def test_sampler_batches_match_jax(world, stacks, monkeypatch):
    k1_calls = []
    real = mips_kernel.block_maxima_grouped

    def spy(*a, **kw):
        k1_calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(mips_kernel, "block_maxima_grouped", spy)
    js, ts = stacks["samplers"](str(world / "qa.jsonl"))
    jbatches = list(js.eval_load(stacks["jenc"], k=3))
    tbatches = list(ts.eval_load(stacks["tenc"], k=3))
    assert [len(b["id"]) for b in tbatches] == [8, 8, 4]
    assert k1_calls, "the port's search did not run K1's pipeline"
    for jb, tb in zip(jbatches, tbatches, strict=True):
        _assert_batches_equal(jb, tb)
        assert tb["net_input"]["para_embed"].shape == (len(tb["id"]), 3, 128)

    # train batches over a gold file: rank labels over M = 16 candidates
    js, ts = stacks["samplers"](str(world / "qa.jsonl"), _gold_file(world), retrieval_batch=16)
    jbatches = list(js.load(stacks["jenc"], k=2, questions_per_batch=4))
    tbatches = list(ts.load(stacks["tenc"], k=2, questions_per_batch=4))
    assert len(tbatches) > 1 and ts.failed_retrieval == js.failed_retrieval
    for jb, tb in zip(jbatches, tbatches, strict=True):
        _assert_batches_equal(jb, tb)
        assert tb["net_input"]["top5000_labels"].shape == (len(tb["id"]), 16)
    assert any(tb["net_input"]["top5000_labels"].any() for tb in tbatches)


def test_sampler_worker_threads_give_jax_train_batches(world, stacks):
    """load() with num_workers = 2, the sampler's thread pool building the
    train examples, gives the batches JAX's sampler builds without workers;
    close() ends the pool."""
    gold = _gold_file(world)
    js, _ = stacks["samplers"](str(world / "qa.jsonl"), gold)
    _, ts = stacks["samplers"](str(world / "qa.jsonl"), gold, num_workers=2)
    jbatches = list(js.load(stacks["jenc"], k=2, questions_per_batch=4))
    tbatches = list(ts.load(stacks["tenc"], k=2, questions_per_batch=4))
    assert ts._pool is not None and len(tbatches) > 1
    for jb, tb in zip(jbatches, tbatches, strict=True):
        _assert_batches_equal(jb, tb)
    ts.close()
    assert ts._pool is None


def test_search_padding_slots_become_minus_one(world, stacks):
    """eval_k beyond the row count: the search pads with -inf, the sampler
    turns those slots into row -1, and the id lookup and `take` clip them to
    row 0, as the JAX package does."""
    tiny = DenseIndex.from_embeddings(np.load(world / "index" / "embeddings.npy")[:3],
                                      IdMap(["p0", "p1", "p2"]), device="cpu",
                                      dtype=torch.float32)
    _, ts = stacks["samplers"]([{"question": "what is about tok1 tok2", "answer": ["tok3"]}])
    ts.index = tiny
    (batch,) = ts.eval_load(stacks["tenc"], k=5)
    _, rows, embeds = ts._retrieve(["what is about tok1 tok2"], stacks["tenc"], candidates=5)
    assert sorted(rows[0, :3].tolist()) == [0, 1, 2] and rows[0, 3:].tolist() == [-1, -1]
    np.testing.assert_array_equal(embeds[0, 3:], np.repeat(embeds[0, [rows[0].tolist().index(0)]],
                                                           2, axis=0))
    assert batch["net_input"]["input_ids"].shape == (1, 5, T)


def test_query_encoder_in_a_thread_builds_no_graph(stacks):
    out = {}
    ids = np.array([[2, 5, 6, 3, 0, 0]], np.int32)

    def run():
        with torch.enable_grad():
            out["emb"] = stacks["tenc"](ids, (ids != 0).astype(np.int32))

    th = threading.Thread(target=run)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive()
    assert out["emb"].grad_fn is None and not out["emb"].requires_grad
    assert out["emb"].dtype == torch.float32 and out["emb"].shape == (1, 128)


def test_predict_and_answer_match_jax(world, stacks):
    preds = {}
    for name in ("jax", "torch"):
        js, ts = stacks["samplers"](str(world / "qa.jsonl"))
        prefix = str(world / f"{name}_all")
        em = stacks[name].predict(js if name == "jax" else ts,
                                  save_path=str(world / f"{name}_pred.jsonl"),
                                  save_all_prefix=prefix)
        preds[name] = (em, _qa_rows(world / f"{name}_pred.jsonl"))
    (jem, jrows), (tem, trows) = preds["jax"], preds["torch"]
    assert tem == jem and 0.0 < tem < 1.0
    assert len(trows) == N_QUESTIONS
    _assert_rows_close(trows, jrows, ("rank_score", "span_score"), SCORE_ATOL)
    with open(world / "jax_all_all.json") as f:
        jall = json.load(f)
    with open(world / "torch_all_all.json") as f:
        tall = json.load(f)
    assert set(tall) == set(jall)
    for qid in jall:
        _assert_rows_close(tall[qid], jall[qid], ("rank_score", "span_score"), SCORE_ATOL)
    assert (world / "torch_all_ground.json").read_bytes() == \
        (world / "jax_all_ground.json").read_bytes()

    questions = [{"question": "what is about tok3 tok9"}, {"question": "what is about tok40"}]
    js, ts = stacks["samplers"](questions)
    jans = stacks["jax"].answer(js, alpha=[0.8, 0.3], topn=2)
    tans = stacks["torch"].answer(ts, alpha=[0.8, 0.3], topn=2)
    _assert_answers_close(tans, jans)


def _assert_rows_close(got, want, score_keys, atol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            if key in score_keys:
                assert g[key] == pytest.approx(w[key], abs=atol), key
            else:
                assert g[key] == w[key], key


def _assert_answers_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_rows_close([{k: v for k, v in g.items() if k != "candidates"}],
                           [{k: v for k, v in w.items() if k != "candidates"}], (), 0)
        _assert_rows_close(g["candidates"], w["candidates"],
                           ("score", "span_score", "rank_score"), ANSWER_ATOL)


def _run(main, argv, capsys):
    main(argv)
    return [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()
            if line.startswith("{")]


def _qa_args(world, ckpt, out):
    w = str(world)
    return ["--vocab", f"{w}/vocab.txt", "--tiny", "--f32", "--max-seq-length", str(T),
            "--max-query-length", str(TQ), "--db", f"{w}/docs.db", "--index", f"{w}/index",
            "--init-checkpoint", f"{w}/{ckpt}", "--questions-per-batch", "8",
            "--eval-k", "3", "--output-dir", f"{w}/{out}"]


def test_cli_qa_commands_match_jax(world, capsys):
    w = str(world)
    with open(world / "retrieved.jsonl", "w") as f:
        for i in range(N_QUESTIONS):
            f.write(json.dumps({"para_id": [f"p{(13 * i + j) % N_PARAS}" for j in range(300)]})
                    + "\n")
    runs = {}
    for name, main, ckpt, extra in (("jax", jax_main, "qa.msgpack", []),
                                    ("torch", torch_main, "qa.npz", ["--device", "cpu"])):
        r = runs[name] = {}
        r["eval"] = _run(main, ["eval-qa", *_qa_args(world, ckpt, f"{name}_cli"), *extra,
                                "--predict-file", f"{w}/qa.jsonl",
                                "--save-pred", f"{w}/{name}_cli_pred.jsonl"], capsys)[-1]
        r["answer"] = _run(main, ["answer", *_qa_args(world, ckpt, f"{name}_cli"), *extra,
                                  "--question", "what is about tok3 tok9",
                                  "--question", "what is about tok51", "--topn", "3"], capsys)
        r["match"] = _run(main, ["match-paras", "--retrieved", f"{w}/retrieved.jsonl",
                                 "--raw-data", f"{w}/qa.jsonl", "--output",
                                 f"{w}/{name}_matched.jsonl", "--db", f"{w}/docs.db",
                                 "--topk", "200"], capsys)[-1]
    jax_run, torch_run = runs["jax"], runs["torch"]
    assert torch_run["eval"] == jax_run["eval"] and 0.0 < torch_run["eval"]["em"] < 1.0
    _assert_rows_close(_qa_rows(f"{w}/torch_cli_pred.jsonl"), _qa_rows(f"{w}/jax_cli_pred.jsonl"),
                       ("rank_score", "span_score"), SCORE_ATOL)
    assert len(torch_run["answer"]) == 2
    assert set(torch_run["answer"][0]) == {"question", "answer", "alpha", "candidates"}
    _assert_answers_close(torch_run["answer"], jax_run["answer"])
    assert torch_run["match"] == jax_run["match"] and 0.0 < torch_run["match"]["topk_gold_coverage"]
    assert (world / "torch_matched.jsonl").read_bytes() == \
        (world / "jax_matched.jsonl").read_bytes()


def test_cli_finetune_qa_matches_jax(world, capsys):
    """finetune-qa through both CLIs at learning rate 0 from one checkpoint
    (one epoch, evals every 2 steps and at the epoch end): the same best_em
    JSON and trainer_meta.json, and the port's best-model.pt loads into
    eval-qa, which gives that EM again."""
    w = str(world)
    outs = {}
    for name, main, ckpt, extra in (("jax", jax_main, "qa.msgpack", []),
                                    ("torch", torch_main, "qa.npz", ["--device", "cpu"])):
        outs[name] = _run(main, ["finetune-qa", *_qa_args(world, ckpt, f"{name}_ft"), *extra,
                                 "--train-file", f"{w}/qa.jsonl", "--predict-file",
                                 f"{w}/qa.jsonl", "--matched-para-path", _gold_file(world),
                                 "--train-batch-size", "2", "--candidates", "16",
                                 "--learning-rate", "0", "--num-train-epochs", "1",
                                 "--eval-period", "2", "--prefetch", "0"], capsys)[-1]
    assert set(outs["torch"]) == {"best_em"}
    assert outs["torch"] == outs["jax"] and 0.0 < outs["torch"]["best_em"] < 1.0
    assert (world / "torch_ft" / "trainer_meta.json").read_text() == \
        (world / "jax_ft" / "trainer_meta.json").read_text()
    em = _run(torch_main, ["eval-qa", *_qa_args(world, "torch_ft/best-model.pt", "torch_ft_eval"),
                           "--device", "cpu", "--predict-file", f"{w}/qa.jsonl"], capsys)[-1]
    assert em == {"em": outs["torch"]["best_em"]}


@pytest.mark.parametrize("command,extra,item", [
    ("serve", ["--shard-index"], 15),
    ("eval-qa", ["--predict-file", "x.jsonl", "--use-ivf", "--shard-index"], 15),
    ("eval-qa", ["--predict-file", "x.jsonl", "--shard-index"], 15),
])
def test_cli_unported_qa_paths_raise(world, command, extra, item, monkeypatch):
    """--shard-index (ROADMAP Queue 1, item 15, once refused here as
    unported) now shards the QA commands' index, with two refusals left, both
    before any model or index is built: serve keeps live updates, so it takes
    the unsharded index; and under data parallelism each rank holds the
    whole index, beside --use-ivf too (ROADMAP Queue 3)."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    match = ("takes the unsharded index" if command == "serve"
             else "each rank holds the whole index")
    with pytest.raises(ValueError, match=match):
        torch_main([command, *_qa_args(world, "qa.npz", "never"), "--device", "cpu", *extra])
    assert not (world / "never").exists() and item == 15


def test_qa_setup_loads_each_weight_source(world):
    """--retriever-path into the retriever, --reader-path into the reader
    BERT (the span head keeps its random weights from --seed), and
    --init-checkpoint into the whole model, as .npz or .pt, with ';'
    averaging the checkpoints (models/convert.py:load_params)."""
    from proqa_tpu_torch.cli.main import _qa_setup, build_parser
    from proqa_tpu_torch.models.reader import QAModel

    w = str(world)
    tree = load_npz(w + "/qa.npz")
    save_npz(w + "/retriever_part.npz", tree["retriever"])
    save_npz(w + "/reader_part.npz", tree["bert"])
    full = params_from_jax(tree)
    torch.save({k: 2 * v for k, v in full.items()}, w + "/qa_double.pt")

    def setup(*flags):
        args = _qa_args(world, "qa.npz", "setup")
        args = args[:args.index("--init-checkpoint")] + args[args.index("--init-checkpoint") + 2:]
        parsed = build_parser().parse_args(["eval-qa", *args, "--predict-file", "x.jsonl",
                                            "--device", "cpu", *flags])
        return _qa_setup(parsed)[0].model.state_dict()

    parts = setup("--retriever-path", w + "/retriever_part.npz",
                  "--reader-path", w + "/reader_part.npz")
    seeded = QAModel(BertConfig.tiny(dtype=torch.float32), QAConfig()).reset_parameters(3)
    for name, value in parts.items():
        want = seeded.state_dict()[name] if name.startswith("qa_outputs") else full[name]
        torch.testing.assert_close(value, want, atol=0, rtol=0, msg=name)
    soup = setup("--init-checkpoint", f"{w}/qa.npz;{w}/qa_double.pt")
    for name, value in soup.items():
        torch.testing.assert_close(value, 1.5 * full[name], atol=1e-6, rtol=1e-6, msg=name)


def test_cli_answer_stdin_matches_jax(world, capsys, monkeypatch):
    """The warm `answer --stdin` loop: one JSON line out per question line
    in (plain text or {"question": ...}); a bad line gets an error line and
    the loop goes on."""
    import io

    lines = "what is about tok3 tok9\n\n{\"question\": \"what is about tok40\"}\n{\"q\": 1}\n"
    outs = {}
    for name, main, ckpt, extra in (("jax", jax_main, "qa.msgpack", []),
                                    ("torch", torch_main, "qa.npz", ["--device", "cpu"])):
        monkeypatch.setattr("sys.stdin", io.StringIO(lines))
        outs[name] = _run(main, ["answer", *_qa_args(world, ckpt, f"{name}_stdin"), *extra,
                                 "--stdin"], capsys)
    assert len(outs["torch"]) == 3 and outs["torch"][2]["error"].startswith("KeyError")
    assert outs["torch"][2] == outs["jax"][2]
    _assert_answers_close(outs["torch"][:2], outs["jax"][:2])
