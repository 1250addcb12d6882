"""The port's QA training loop against the JAX package's QATrainer.train on
one small world (the loop of tests/test_qa_pipeline.py): the best EM, the
metrics.jsonl records and trainer_meta.json; resume continuing a run; and the
CLI's rounding of --questions-per-batch."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from proqa_tpu.data.docdb import DocDB as JaxDocDB  # noqa: E402
from proqa_tpu.index.dense import DenseIndex as JaxDenseIndex  # noqa: E402
from proqa_tpu.models.bert import BertConfig as JaxBertConfig  # noqa: E402
from proqa_tpu.models.reader import QAConfig as JaxQAConfig, init_qa_params  # noqa: E402
from proqa_tpu.parallel.mesh import make_mesh  # noqa: E402
from proqa_tpu.qa.sampler import (  # noqa: E402
    OnlineSampler as JaxSampler, OnlineSamplerConfig as JaxSamplerConfig,
)
from proqa_tpu.text.wordpiece import BertTokenizer as JaxTokenizer  # noqa: E402
from proqa_tpu.train.qa_trainer import (  # noqa: E402
    QATrainer as JaxQATrainer, QATrainerConfig as JaxQATrainerConfig,
)
from proqa_tpu_torch.data.docdb import DocDB  # noqa: E402
from proqa_tpu_torch.index.dense import DenseIndex  # noqa: E402
from proqa_tpu_torch.index.idmap import IdMap  # noqa: E402
from proqa_tpu_torch.models.bert import BertConfig  # noqa: E402
from proqa_tpu_torch.models.convert import params_from_jax  # noqa: E402
from proqa_tpu_torch.models.reader import QAConfig  # noqa: E402
from proqa_tpu_torch.qa.sampler import OnlineSampler, OnlineSamplerConfig  # noqa: E402
from proqa_tpu_torch.text.wordpiece import BertTokenizer  # noqa: E402
from proqa_tpu_torch.train.qa_trainer import QATrainer, QATrainerConfig  # noqa: E402

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"tok{i}" for i in range(60)] + [
    "what", "is", "about",
]
N_PARAS, N_QUESTIONS, T, TQ = 300, 16, 48, 12
# the training losses: f32 on both sides, summed in other orders, after a few
# Adam steps (tests/test_torch_qa_train.py holds single steps to 1e-5)
LOSS_RTOL = 1e-4
KW = dict(hidden_dropout=0.0, attention_dropout=0.0, initializer_range=0.3)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Paragraphs of 1-12 words (a third one word, so EM is neither 0 nor 1),
    a random f32 index, questions with one-word gold answers, and a matched
    file naming every 5th paragraph gold."""
    root = tmp_path_factory.mktemp("qa_loop")
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
    qa = []
    for i in range(N_QUESTIONS):
        a, b = rng.integers(0, 60, size=2)
        qa.append({"question": f"what is about tok{a} tok{b}",
                   "answer": [f"tok{t}" for t in rng.choice(60, 12, replace=False)]})
    with open(root / "qa.jsonl", "w") as f:
        f.writelines(json.dumps(row) + "\n" for row in qa)
    with open(root / "matched.jsonl", "w") as f:
        for row in qa:
            f.write(json.dumps({"question": row["question"], "matched_paras": {
                f"p{i}": row["answer"][0] for i in range(0, N_PARAS, 5)}}) + "\n")
    params = jax.tree.map(np.asarray, init_qa_params(
        jax.random.PRNGKey(2), JaxBertConfig.tiny(**KW), JaxQAConfig(shared_norm=True)))
    return root, params


SAMPLER = dict(max_query_length=TQ, max_length=T, candidates=16, max_spans=4, question_batch=4,
               exact_search=True)
TRAINER = dict(learning_rate=1e-3, eval_k=2, train_k=2, questions_per_batch=4, seed=0,
               prefetch_batches=0, num_train_epochs=2, eval_period=2)


def _jax_trainer(world, out, **kw):
    root, params = world
    trainer = JaxQATrainer(JaxBertConfig.tiny(dtype=jnp.float32, **KW),
                           JaxQAConfig(shared_norm=True),
                           JaxQATrainerConfig(output_dir=str(out), fast_prng=False,
                                              **{**TRAINER, **kw}),
                           mesh=make_mesh(1), params=jax.tree.map(jnp.asarray, params))
    index = JaxDenseIndex.load(str(root / "index"), dtype=jnp.float32)
    tok, db = JaxTokenizer.from_vocab_file(str(root / "vocab.txt")), JaxDocDB(str(root / "docs.db"))
    samplers = [JaxSampler(str(root / "qa.jsonl"), tok, db, index, JaxSamplerConfig(**SAMPLER),
                           matched) for matched in (str(root / "matched.jsonl"), "")]
    return trainer, samplers


def _torch_trainer(world, out, **kw):
    root, params = world
    trainer = QATrainer(BertConfig.tiny(dtype=torch.float32, **KW), QAConfig(shared_norm=True),
                        QATrainerConfig(output_dir=str(out), **{**TRAINER, **kw}),
                        params=params_from_jax(params), device="cpu")
    index = DenseIndex.load(str(root / "index"), device="cpu", dtype=torch.float32)
    tok, db = BertTokenizer.from_vocab_file(str(root / "vocab.txt")), DocDB(str(root / "docs.db"))
    samplers = [OnlineSampler(str(root / "qa.jsonl"), tok, db, index, OnlineSamplerConfig(**SAMPLER),
                              matched) for matched in (str(root / "matched.jsonl"), "")]
    return trainer, samplers


def _records(out):
    with open(out / "metrics.jsonl") as f:
        return [json.loads(line) for line in f if line.strip()]


def test_train_loop_matches_jax(world, tmp_path):
    """Two epochs with evals every 2 steps and at each epoch end: the same
    best EM, the same metric records (losses to LOSS_RTOL, EMs equal), the
    same trainer_meta.json, and the same checkpoint files."""
    jt, (jtrain, jeval) = _jax_trainer(world, tmp_path / "jax")
    tt, (ttrain, teval) = _torch_trainer(world, tmp_path / "torch")
    want = jt.train(jtrain, jeval)
    got = tt.train(ttrain, teval)
    assert got == want and 0.0 < got < 1.0
    assert tt.state.step == int(jt.state.step) > 2
    assert ttrain.failed_retrieval == jtrain.failed_retrieval
    jrec, trec = _records(tmp_path / "jax"), _records(tmp_path / "torch")
    assert [(r["tag"], r["step"]) for r in trec] == [(r["tag"], r["step"]) for r in jrec]
    for g, w in zip(trec, jrec):
        if g["tag"] == "train_loss":
            assert g["value"] == pytest.approx(w["value"], rel=LOSS_RTOL), g
        elif g["tag"] == "dev_em":
            assert g["value"] == w["value"], g
    assert {"train_loss", "dev_em", "step_p50_ms", "steps_per_s"} <= {r["tag"] for r in trec}
    meta = [json.loads((tmp_path / name / "trainer_meta.json").read_text())
            for name in ("jax", "torch")]
    assert meta[1] == meta[0] and meta[1]["epoch"] == 2
    for name in ("checkpoint_last", "best-model"):
        assert (tmp_path / "torch" / f"{name}.pt").exists()
        assert (tmp_path / "jax" / f"{name}.msgpack").exists()


def test_resume_continues_a_run(world, tmp_path):
    """One epoch, then a new trainer resumes from checkpoint_last.pt and runs
    the second: its step count, meta, and weights equal a two-epoch run's."""
    full, (train, ev) = _torch_trainer(world, tmp_path / "full")
    full.train(train, ev)
    first, (train, ev) = _torch_trainer(world, tmp_path / "part", num_train_epochs=1)
    first.train(train, ev)
    assert json.loads((tmp_path / "part" / "trainer_meta.json").read_text())["epoch"] == 1
    second, (train, ev) = _torch_trainer(world, tmp_path / "part")
    # the sampler shuffles its questions in place each epoch (as JAX's does),
    # so the uninterrupted run's second epoch starts from the first's order
    train.shuffle(seed=TRAINER["seed"])
    second.resume(str(tmp_path / "part" / "checkpoint_last.pt"))
    assert second.state.step == first.state.step > 0
    assert second._resume_meta["epoch"] == 1
    second.train(train, ev)
    assert second.state.step == full.state.step
    assert json.loads((tmp_path / "part" / "trainer_meta.json").read_text()) == \
        json.loads((tmp_path / "full" / "trainer_meta.json").read_text())
    for name, p in full.state.params.items():
        torch.testing.assert_close(second.state.params[name], p, rtol=0, atol=1e-6, msg=name)
    # a completed run resumes as a no-op
    third, (train, ev) = _torch_trainer(world, tmp_path / "part")
    third.resume(str(tmp_path / "part" / "checkpoint_last.pt"))
    third.train(train, ev)
    assert third.state.step == full.state.step


def test_resume_rejects_other_frozen_groups(world, tmp_path):
    trainer, (train, ev) = _torch_trainer(world, tmp_path / "a", num_train_epochs=1,
                                          eval_period=-1)
    trainer.train(train, ev)
    other, _ = _torch_trainer(world, tmp_path / "b", freeze_retriever=True)
    with pytest.raises(ValueError, match="parameter groups"):
        other.resume(str(tmp_path / "a" / "checkpoint_last.pt"))


def test_epoch_end_evals_count_towards_wait(world, tmp_path):
    """eval_period -1 and an EM that never improves: wait_step 2 stops the
    run after the second epoch-end eval (tests/test_qa_pipeline.py:
    test_qa_epoch_end_early_stopping)."""
    trainer, (train, ev) = _torch_trainer(world, tmp_path / "stop", num_train_epochs=6,
                                          eval_period=-1, wait_step=2)
    calls = []
    trainer.predict = lambda sampler: calls.append(1) or 0.0
    trainer.train(train, ev)
    assert len(calls) == 2
    assert json.loads((tmp_path / "stop" / "trainer_meta.json").read_text())["wait"] == 2


def test_cli_rounds_questions_per_batch(world, tmp_path, capsys):
    """--questions-per-batch rounds up to a multiple of
    --accumulate-gradients, and the change is printed (the JAX CLI's
    rounding, proqa_tpu/cli/main.py:409-417, with one device)."""
    from proqa_tpu_torch.cli.main import _qa_setup, build_parser

    root, _ = world
    args = build_parser().parse_args([
        "finetune-qa", "--vocab", str(root / "vocab.txt"), "--tiny", "--f32",
        "--max-seq-length", str(T), "--max-query-length", str(TQ), "--db", str(root / "docs.db"),
        "--index", str(root / "index"), "--train-file", str(root / "qa.jsonl"),
        "--predict-file", str(root / "qa.jsonl"), "--questions-per-batch", "5",
        "--accumulate-gradients", "2", "--output-dir", str(tmp_path), "--device", "cpu"])
    trainer, make_sampler = _qa_setup(args)
    assert "questions-per-batch 5 -> 6" in capsys.readouterr().out
    assert trainer.tcfg.questions_per_batch == 6
    assert make_sampler(str(root / "qa.jsonl")).cfg.question_batch == 6
