"""Data-parallel training of the port (parallel/dist.py) in 2 and 4 gloo
processes on the CPU, each joined by a `file://` rendezvous in tmp_path:
the retriever's and the QA trainer's steps against the one-process step on
the global batch, distinct dropout streams per rank, rank 0 alone writing
files, and the QA predictions gathered on rank 0 in the one-process order.

The worker functions live here, so the spawned processes import this module:
it imports nothing heavier than torch at the top."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

# f32 at dropout 0: the DP step sums the same products in other groupings
# (per-rank partial gradients, then their mean), ~1e-7 relative
LOSS_TOL = 1e-6
PARAM_TOL = 1e-5
ACCUM = 2
B_GLOBAL = 8      # rows of a global batch: divides over ACCUM x 4 ranks
N_STEPS = 3
TIMEOUT_S = 120


def _entry(fn, rank, world, tmp, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world)
    try:
        fn(rank, world, tmp, *args)
    finally:
        dist.destroy_process_group()


def _run_ranks(fn, world, tmp, *args):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, str(tmp), args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * world


# ---------------------------------------------------------------------------
# retriever pretraining
# ---------------------------------------------------------------------------

def _retriever_cfg(**kw):
    from proqa_tpu_torch.models.bert import BertConfig

    return BertConfig.tiny(dtype=torch.float32, **{"hidden_dropout": 0.0,
                                                   "attention_dropout": 0.0, **kw})


def _retriever_tcfg(out, **kw):
    from proqa_tpu_torch.train.retriever_trainer import RetrieverTrainerConfig

    return RetrieverTrainerConfig(learning_rate=1e-3, weight_decay=0.01, max_grad_norm=1.0,
                                  adam_eps=1e-6, accumulate_gradients=ACCUM, seed=5,
                                  output_dir=out, num_train_epochs=1, eval_period=2,
                                  save_checkpoints_steps=-1, **kw)


def _pair_batches(n, bsz=B_GLOBAL, seed=0, vocab=128):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tok = rng.integers(5, vocab, size=bsz)
        q = np.stack([[2, t, 3, 0] for t in tok]).astype(np.int32)
        c = np.stack([[2, t, rng.integers(5, vocab), 3, 0, 0] for t in tok]).astype(np.int32)
        c[: bsz // 2, 4] = rng.integers(5, vocab, size=bsz // 2)
        out.append({"input_ids_q": q, "input_mask_q": (q != 0).astype(np.int32),
                    "input_ids_c": c, "input_mask_c": (c != 0).astype(np.int32)})
    return out


def _dropout_draw(trainer):
    """The query tower in training mode on a fixed input, with the trainer's
    dropout stream: its first dropout seeds shape the output."""
    ids = torch.tensor([[2, 9, 10, 11, 12, 3]] * 4)
    trainer.model.train()
    with torch.no_grad():
        return trainer.model.encode_query(ids, (ids != 0).int(), generator=trainer.generator)


def _retriever_run(trainer):
    """N_STEPS steps on the global batches, then train() on them (evals every
    2 steps, rank 0 writing)."""
    losses = [float(trainer.step(b)["loss"]) for b in _pair_batches(N_STEPS)]
    params = {k: p.detach().clone() for k, p in trainer.state.params.items()}
    batches = _pair_batches(4, seed=1)
    best = trainer.train(lambda epoch: [dict(b) for b in batches],
                         lambda: [dict(b) for b in _pair_batches(3, seed=2)])
    return losses, params, best


def _retriever_worker(rank, world, tmp):
    from proqa_tpu_torch.train.retriever_trainer import RetrieverTrainer

    out = os.path.join(tmp, f"rank{rank}")
    trainer = RetrieverTrainer(_retriever_cfg(), _retriever_tcfg(out), device="cpu")
    assert (trainer.dp.rank, trainer.dp.world, trainer.dp.backend) == (rank, world, "gloo")
    losses, params, best = _retriever_run(trainer)
    dropped = RetrieverTrainer(_retriever_cfg(hidden_dropout=0.1, attention_dropout=0.1),
                               _retriever_tcfg(os.path.join(tmp, f"drop{rank}")), device="cpu")
    torch.save({"losses": losses, "params": params, "best": best,
                "draw": _dropout_draw(dropped)}, os.path.join(tmp, f"out{rank}.pt"))


@pytest.mark.parametrize("world", [2, 4])
def test_dp_retriever_step_matches_one_process(tmp_path, world):
    """3 steps at accumulation 2 over 2 and 4 gloo ranks: each rank's loss is
    the one-process step's over the global microbatch (negatives span the
    ranks) and every rank ends on the one-process parameters; the train()
    loop's eval counts summed over the ranks give the same best accuracy;
    only rank 0 writes logs, metrics, checkpoints and meta; rank 0 draws the
    one-process dropout stream and the other ranks their own."""
    from proqa_tpu_torch.train.retriever_trainer import RetrieverTrainer

    _run_ranks(_retriever_worker, world, tmp_path)
    ref = RetrieverTrainer(_retriever_cfg(), _retriever_tcfg(str(tmp_path / "ref")), device="cpu")
    assert not ref.dp.grouped
    want_losses, want_params, want_best = _retriever_run(ref)
    ref_drop = RetrieverTrainer(_retriever_cfg(hidden_dropout=0.1, attention_dropout=0.1),
                                _retriever_tcfg(str(tmp_path / "ref_drop")), device="cpu")
    want_draw = _dropout_draw(ref_drop)

    outs = [torch.load(tmp_path / f"out{r}.pt") for r in range(world)]
    for r, got in enumerate(outs):
        np.testing.assert_allclose(got["losses"], want_losses, rtol=0, atol=LOSS_TOL)
        for name, p in want_params.items():
            torch.testing.assert_close(got["params"][name], p, rtol=0, atol=PARAM_TOL)
            assert torch.equal(got["params"][name], outs[0]["params"][name]), (r, name)
        assert got["best"] == want_best
    assert torch.equal(outs[0]["draw"], want_draw)
    for r in range(1, world):
        assert not torch.allclose(outs[r]["draw"], outs[0]["draw"])
    written = set(os.listdir(tmp_path / "rank0"))
    assert {"log.txt", "metrics.jsonl", "checkpoint_last.pt", "trainer_meta.json"} <= written
    assert all(not (tmp_path / f"rank{r}").exists() for r in range(1, world))
    ckpt = torch.load(tmp_path / "rank0" / "checkpoint_last.pt")
    assert not any(k.startswith("module.") for k in ckpt["params"])
    assert "data parallel: backend gloo" in (tmp_path / "rank0" / "log.txt").read_text()


# ---------------------------------------------------------------------------
# QA training and prediction
# ---------------------------------------------------------------------------

N_ROWS = 400


def _qa_trainer(out):
    from proqa_tpu_torch.index.dense import DenseIndex
    from proqa_tpu_torch.models.reader import QAConfig
    from proqa_tpu_torch.train.qa_trainer import QATrainer, QATrainerConfig

    cfg = _retriever_cfg(initializer_range=0.1)
    tcfg = QATrainerConfig(learning_rate=1e-3, weight_decay=0.01, max_grad_norm=1.0,
                           adam_eps=1e-6, accumulate_gradients=ACCUM,
                           questions_per_batch=B_GLOBAL, output_dir=out, seed=4)
    trainer = QATrainer(cfg, QAConfig(shared_norm=True, add_select=True), tcfg, device="cpu")
    rng = np.random.default_rng(9)
    trainer.set_corpus(DenseIndex.from_embeddings(
        rng.standard_normal((N_ROWS, 128)).astype(np.float32), device="cpu",
        dtype=torch.float32))
    return trainer


def _qa_batch(seed=0, vocab=128):
    """A global QA batch as __graft_entry__.py:dryrun_multichip builds one
    (k = 2 paragraphs of L = 32 after an 8-token question, 16 rank-head
    candidates as index rows, 4 span slots), its last question padded out
    by question_mask as batch_pad leaves it."""
    rng = np.random.default_rng(seed)
    b, k, length, tq, m, s = B_GLOBAL, 2, 32, 8, 16, 4
    ids = rng.integers(1, vocab, size=(b, k, length)).astype(np.int32)
    pm = np.zeros((b, k, length), np.int32)
    pm[:, :, tq:-1] = 1
    sp = rng.integers(tq, length - 2, size=(b, k, s)).astype(np.int32)
    return {
        "input_ids": ids, "input_mask": np.ones_like(ids),
        "segment_ids": np.broadcast_to((np.arange(length) >= tq).astype(np.int32),
                                       ids.shape).copy(),
        "paragraph_mask": pm,
        "input_ids_q": rng.integers(1, vocab, size=(b, tq)).astype(np.int32),
        "input_mask_q": np.ones((b, tq), np.int32),
        "para_rows": rng.integers(0, N_ROWS, size=(b, m)).astype(np.int32),
        "start_positions": sp, "end_positions": sp + 1,
        "para_targets": np.ones((b, k), np.int32),
        "top5000_labels": (rng.random((b, m)) < 0.3).astype(np.int32),
        "question_mask": (np.arange(b) < b - 1).astype(np.int32),
    }


QUESTIONS = [f"q{i}" for i in range(11)]


class _FakeSampler:
    """The questions a predict reads; _fake_predictions stands in for the
    retrieve-read-decode path, so the gather and sweep are what is tested."""

    class cfg:
        question_batch = 4

    def __init__(self, questions):
        self.questions = questions


def _fake_predictions(sampler, _b):
    from proqa_tpu_torch.train.qa_trainer import Prediction

    for q in sampler.questions:
        i = int(q[1:])
        preds = [Prediction(text=f"a{(i * 3 + j) % 5}", rank_score=float((i + j) % 4),
                            span_score=float((i * j) % 3), passage=f"p{j}", question=q)
                 for j in range(3)]
        yield q, q, ["a1"] if i % 3 else [], preds


def _qa_worker(rank, world, tmp):
    trainer = _qa_trainer(os.path.join(tmp, f"qa{rank}"))
    comp = trainer._train_step(trainer.dp.share(_qa_batch(), ACCUM))
    trainer._iter_candidate_predictions = _fake_predictions
    pred_path = os.path.join(tmp, f"pred{rank}.jsonl")
    em = trainer.predict(_FakeSampler(QUESTIONS[rank::world]), save_path=pred_path)
    torch.save({"comp": {k: float(v) for k, v in comp.items()}, "em": em,
                "params": {k: p.detach() for k, p in trainer.state.params.items()}},
               os.path.join(tmp, f"qa_out{rank}.pt"))


@pytest.mark.parametrize("world", [2, 4])
def test_dp_qa_step_and_predict_match_one_process(tmp_path, world):
    """One QA train step (accumulation 2, a padded question) over 2 and 4
    gloo ranks, each on its share of every global microbatch: the loss
    components and every parameter equal the one-process step's. predict
    over questions dealt out to the ranks: every rank returns rank 0's EM,
    which with the prediction rows rank 0 alone writes equals one process's."""
    _run_ranks(_qa_worker, world, tmp_path)
    ref = _qa_trainer(str(tmp_path / "qa_ref"))
    want = ref._train_step(_qa_batch())
    ref._iter_candidate_predictions = _fake_predictions
    want_em = ref.predict(_FakeSampler(QUESTIONS), save_path=str(tmp_path / "pred_ref.jsonl"))
    for r in range(world):
        got = torch.load(tmp_path / f"qa_out{r}.pt")
        assert set(got["comp"]) == set(want)
        for key, value in want.items():
            assert got["comp"][key] == pytest.approx(float(value), rel=0, abs=LOSS_TOL), key
        for name, p in ref.state.params.items():
            torch.testing.assert_close(got["params"][name], p.detach(), rtol=0, atol=PARAM_TOL)
        assert got["em"] == want_em
    assert (tmp_path / "pred0.jsonl").read_text() == (tmp_path / "pred_ref.jsonl").read_text()
    assert all(not (tmp_path / f"pred{r}.jsonl").exists() for r in range(1, world))
    rows = [json.loads(line) for line in open(tmp_path / "pred0.jsonl")]
    assert [row["question"] for row in rows] == QUESTIONS


# rank r's train batches: (first row, rows) slices of _qa_batch's questions;
# rank 1 runs dry after one step, so the loop steps it with nothing to add
RANK_BATCHES = {0: [(0, 4), (4, 4), (0, 2)], 1: [(5, 3)]}
QPB_LOCAL = 4


class _FakeTrainSampler:
    """A rank's train batches, as OnlineSampler.load yields them."""

    def __init__(self, rank):
        net = {k: v for k, v in _qa_batch(seed=3).items() if k != "question_mask"}
        self.batches = [{k: v[a:a + n] for k, v in net.items()} for a, n in RANK_BATCHES[rank]]
        self.failed_retrieval = 0

    def __len__(self):
        return sum(len(b["input_ids"]) for b in self.batches)

    def shuffle(self, seed=None):
        pass

    def load(self, _encoder, _k, _qpb):
        return ({"net_input": dict(b)} for b in self.batches)


def _qa_train_worker(rank, world, tmp):
    from proqa_tpu_torch.train.qa_trainer import QATrainer

    trainer = _qa_trainer(os.path.join(tmp, f"loop{rank}"))
    trainer.tcfg.questions_per_batch = QPB_LOCAL
    trainer.tcfg.num_train_epochs = 1
    trainer._iter_candidate_predictions = _fake_predictions
    assert isinstance(trainer, QATrainer)
    trainer.train(_FakeTrainSampler(rank), _FakeSampler(QUESTIONS[rank::world]))


def test_dp_qa_loop_steps_ranks_together_until_all_run_dry(tmp_path):
    """train() over 2 gloo ranks whose samplers yield 3 and 1 batches (the
    last ones short, padded and masked): rank 1 takes part in steps 2 and 3
    with nothing to add. Each step's loss and the parameters after it equal
    the one-process step on the global batch the ranks' shares make, every
    masked question left out of the global mean."""
    from proqa_tpu_torch.data.collate import batch_pad
    from proqa_tpu_torch.train.checkpoint import load_checkpoint

    _run_ranks(_qa_train_worker, 2, tmp_path)
    ref = _qa_trainer(str(tmp_path / "loop_ref"))
    samplers = [_FakeTrainSampler(r) for r in range(2)]
    want = []
    for step in range(3):
        locals_ = []
        for r in range(2):
            b = samplers[r].batches[min(step, len(samplers[r].batches) - 1)]
            net, rows = batch_pad(dict(b), QPB_LOCAL)
            if step >= len(samplers[r].batches):
                rows = 0  # run dry: its rows count for nothing
            net["question_mask"] = (np.arange(QPB_LOCAL) < rows).astype(np.int32)
            locals_.append(net)
        per = QPB_LOCAL // ACCUM
        glob = {k: np.stack([n[k].reshape(ACCUM, per, *n[k].shape[1:]) for n in locals_], 1)
                .reshape(2 * QPB_LOCAL, *locals_[0][k].shape[1:]) for k in locals_[0]}
        want.append(float(ref._train_step(glob)["loss"]))
    metrics = [json.loads(line) for line in open(tmp_path / "loop0" / "metrics.jsonl")]
    got = [m["value"] for m in metrics if m["tag"] == "train_loss"]
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_TOL)
    params = load_checkpoint(str(tmp_path / "loop0" / "checkpoint_last.pt")).params
    for name, p in ref.state.params.items():
        torch.testing.assert_close(params[name], p.detach(), rtol=0, atol=PARAM_TOL)
    assert not (tmp_path / "loop1").exists()


def test_shard_index_refused_under_data_parallel():
    """--shard-index with more than one rank raises (each rank holds the
    whole index: ROADMAP Queue 3)."""
    import argparse

    from proqa_tpu_torch.cli.main import _index_place

    args = argparse.Namespace(shard_index=True, device="cpu")
    with pytest.raises(ValueError, match="each rank holds the whole index"):
        _index_place(args, "cpu", world=2)
    assert _index_place(argparse.Namespace(shard_index=False), "cpu", world=2) == {"device": "cpu"}
    assert _index_place(args, "cpu") == {"mesh": [torch.device("cpu")]}
