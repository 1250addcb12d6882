"""Each driver rehearsed on the CPU at tiny sizes: a sound run comes out
correct; the same run with the timed path broken underneath (an answer
altered where it is produced; a step that leaves the state unchanged; half
of each microbatch left out, the mean over the rest) comes out not
correct; and the control fails the cell's comparison. The real command
still refuses to run without a card.

The tiny sizes keep the cells' traffic and arithmetic; the limits of the
pretrain cell are the tiny model's own (its near-uniform loss leaves
gradients of 1e-5, where bf16 round-off is a larger share than at
BERT-base's widths)."""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness

CPU = torch.device("cpu")
TINY_BERT = dict(vocab_size=1200, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                 intermediate_size=64, max_position_embeddings=512, projection_dim=16)
TOKENS = {"cls": 101, "sep": 102, "first_word": 999}
# the encode and pretrain drivers have no cell in BENCHMARK.json until their
# traffic's lengths come from a published source; rehearsed here on
# tiny traffic of their own
HELD = {
    "encode": ({"driver": "encode", "batch": 256, "max_length": 512, "shard_rows": 600,
                "pool": 2, "lengths": {"median": 120, "sigma": 0.7, "min": 16, "max": 512},
                "tokens": TOKENS, "kept_rows_per_call": 4, "check_rows": 12, "trace_calls": 1},
               {"embed_gap": 0.9}, "encode_tokens_per_s"),
    "pretrain": ({"driver": "pretrain", "micro": 8, "accumulate": 2, "query_width": 30,
                  "query_lengths": [10, 30], "max_length": 128,
                  "lengths": {"median": 40, "sigma": 0.7, "min": 16, "max": 128},
                  "tokens": TOKENS, "learning_rate": 1e-3, "max_grad_norm": 5.0,
                  "checked_steps": 3, "pool": 2, "trace_calls": 1},
                 {"loss_gap": 1e-4, "grad_norm_gap": 0.3, "update_norm_gap": 0.2},
                 "train_tokens_per_s"),
}
TINY = {
    "proqa.search-q2048": ({"corpus_rows": 70_000},
                           {"batch": 64, "pool": 2, "check_queries": 32}),
    "dpr.search-q2048": ({"corpus_rows": 30_000, "embed_dim": 768},
                         {"batch": 32, "pool": 2, "check_queries": 16}),
}


def tiny(name: str) -> harness.Cell:
    if name in HELD:
        traffic, limits, rate = HELD[name]
        config = json.loads((harness.ROOT / "benchmark/configs/proqa-bert-base.json").read_text())
        return harness.Cell(name=name, chips=1, config={**config, **TINY_BERT}, traffic=traffic,
                            limits=limits, per_layer=[],
                            end_to_end=[{"name": "setup_s", "unit": "s"},
                                        {"name": rate, "unit": "tokens/s"}])
    cell = harness.load_cell(name)
    cfg, tr = TINY[name]
    return dataclasses.replace(cell, config={**cell.config, **cfg},
                               traffic={**cell.traffic, **tr})


def run(cell: harness.Cell, seed: int = 2**31 + 11) -> dict:
    outcome = harness.load_driver(cell.driver).run(
        cell, seed=seed, seconds=0.5, trace=False, device=CPU, clock=harness.Clock())
    line = harness.result_line(cell, outcome, trace=False, device={"platform": "cpu"})
    assert list(line)[-1] == "checks" and outcome.attempted > 0
    return line


@pytest.mark.parametrize("name", [*TINY, *HELD])
def test_sound_run_is_correct(name):
    line = run(tiny(name))
    assert line["correct"], line["checks"]
    cell = tiny(name)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 for m in line["metrics"].values())


@pytest.mark.parametrize("name", [*TINY, *HELD])
def test_control_fails_the_comparison(name):
    cell = tiny(name)
    got = harness.load_driver(cell.driver).control(cell, 5, CPU)
    if cell.driver == "pretrain":  # the control and each planted fault
        for prefix in ("fp8", "half_batch"):
            assert any(got[f"{prefix}.{k}"] > lim for k, lim in cell.limits.items()), got
    else:
        assert any(got[k] > lim for k, lim in cell.limits.items()), got


def _altered_search(monkeypatch):
    from proqa_tpu_torch.index.dense import DenseIndex

    search = DenseIndex.search

    def altered(self, queries, k, **kw):
        vals, ids = search(self, queries, k, **kw)
        ids = ids.copy()
        ids[:, k // 2] = (ids[:, k // 2] + 1) % self.n  # one answer of each query
        return vals, ids

    monkeypatch.setattr(DenseIndex, "search", altered)


def _altered_encode(monkeypatch):
    from proqa_tpu_torch.models.retriever import Retriever

    encode = Retriever.encode_context

    def altered(self, *a, **kw):
        return encode(self, *a, **kw).roll(1, 0)  # each row gets its neighbour's answer

    monkeypatch.setattr(Retriever, "encode_context", altered)


def _unchanged_state(monkeypatch):
    from proqa_tpu_torch.train import retriever_trainer

    def unchanged(state, grads, tx):
        return state

    monkeypatch.setattr(retriever_trainer, "apply_gradients", unchanged)


def _half_batch(monkeypatch):
    from proqa_tpu_torch.train import retriever_trainer

    loss = retriever_trainer.in_batch_loss

    def half(out):
        rows = out["q"].shape[0] // 2
        return loss({k: v[:rows] for k, v in out.items()})

    monkeypatch.setattr(retriever_trainer, "in_batch_loss", half)


@pytest.mark.parametrize("name,fault", [
    ("proqa.search-q2048", _altered_search), ("dpr.search-q2048", _altered_search),
    ("encode", _altered_encode), ("pretrain", _unchanged_state), ("pretrain", _half_batch)], ids=lambda x: getattr(x, "__name__", x))
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    line = run(tiny(name))
    assert not line["correct"], line["checks"]


def _command(cwd, *extra) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(cwd), "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "proqa.search-q2048", "--seed", "3", "--seconds", "1", *extra],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_command_refuses_without_a_card(tmp_path):
    done = _command(harness.ROOT, "--trace", "0")
    assert done.returncode != 0 and done.stdout == "" and "CUDA" in done.stderr
    # a directory holding only the manifest and the benchmark's files
    shutil.copytree(harness.ROOT / "benchmark", tmp_path / "benchmark")
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    done = _command(tmp_path, "--trace", "1")
    assert done.returncode != 0 and done.stdout == ""


def test_result_line_shape():
    cell = tiny("proqa.search-q2048")
    line = run(cell)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    json.dumps(line)
    assert np.isfinite([c["value"] for c in line["checks"].values()]).all()
