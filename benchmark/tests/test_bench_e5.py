"""The cells this benchmark added after its first two, rehearsed on the CPU
at tiny sizes: the E5 decoder cell (drivers/e5_search.py) on a tiny decoder
and corpus with the cell's traffic and arithmetic, and the 32-query search
cell on a tiny corpus. A sound run comes out correct, a run with the timed
path broken underneath (the tower's rows swapped, a search answer altered)
does not, the control fails the comparison, and the E5 cell's readers read
a traced window's numbers within 0-100 and leave a metric out where the
program has nothing for it."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import harness, opcount_decoder
from benchmark.trace import TraceSummary

CPU = torch.device("cpu")
E5 = "e5.nq-search-q512"
TINY_DECODER = {"vocab_size": 512, "hidden_size": 64, "num_hidden_layers": 2,
                "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
                "intermediate_size": 160, "embed_dim": 64, "corpus_rows": 5_000}
TINY = {E5: (TINY_DECODER, {"batch": 16, "pool": 2, "check_queries": 16,
                            "tower_check_rows": 8}),
        "proqa.search-q32": ({"corpus_rows": 40_000}, {"pool": 2, "check_queries": 32})}


def tiny(name: str) -> harness.Cell:
    cell = harness.load_cell(name)
    cfg, tr = TINY[name]
    return dataclasses.replace(cell, config={**cell.config, **cfg},
                               traffic={**cell.traffic, **tr})


def run(cell: harness.Cell, seed: int = 2**31 + 17) -> tuple[dict, harness.Outcome]:
    outcome = harness.load_driver(cell.driver).run(
        cell, seed=seed, seconds=0.5, trace=False, device=CPU, clock=harness.Clock())
    line = harness.result_line(cell, outcome, trace=False, device={"platform": "cpu"})
    assert list(line)[-1] == "checks" and outcome.attempted > 0
    return line, outcome


@pytest.mark.parametrize("name", list(TINY))
def test_sound_run_is_correct(name):
    cell = tiny(name)
    line, outcome = run(cell)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 for m in line["metrics"].values())


def test_e5_run_counts_the_padding():
    cell = tiny(E5)
    _, outcome = run(cell)
    w = outcome.work
    lengths = [n for batch in w["batch_lengths"] for n in batch]
    # the counters span the whole run here (no traced window resets them)
    assert w["tower_tokens"] >= sum(lengths) and w["tower_positions"] > w["tower_tokens"]
    assert min(lengths) >= 1 + 21 + 5 + 1 and max(lengths) <= 1 + 21 + 40 + 1


@pytest.mark.parametrize("name", list(TINY))
def test_control_fails_the_comparison(name):
    cell = tiny(name)
    got = harness.load_driver(cell.driver).control(cell, 5, CPU)
    assert any(got[k] > lim for k, lim in cell.limits.items()), got
    if name == E5:
        assert got["embed_gap"] > cell.limits["embed_gap"], got


def _swapped_rows(monkeypatch):
    from proqa_tpu_torch.models.mistral import MistralRetriever

    encode = MistralRetriever.encode_query

    def swapped(self, *a, **kw):
        return encode(self, *a, **kw).roll(1, 0)  # each row gets its neighbour's embedding

    monkeypatch.setattr(MistralRetriever, "encode_query", swapped)


def _altered_search(monkeypatch):
    from proqa_tpu_torch.index.dense import DenseIndex

    search = DenseIndex.search

    def altered(self, queries, k, **kw):
        vals, ids = search(self, queries, k, **kw)
        ids = ids.copy()
        ids[:, k // 2] = (ids[:, k // 2] + 1) % self.n  # one answer of each query
        return vals, ids

    monkeypatch.setattr(DenseIndex, "search", altered)


@pytest.mark.parametrize("name,fault", [(E5, _swapped_rows), (E5, _altered_search),
                                        ("proqa.search-q32", _altered_search)],
                         ids=lambda x: getattr(x, "__name__", x))
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    line, _ = run(tiny(name))
    assert not line["correct"], line["checks"]


def _e5_window(cfg: dict, spans: bool = True) -> tuple[dict, TraceSummary]:
    """A traced window of 2 batches of 512 rows at the cell's lengths, with
    the tower at 60% of its roofline, F1 and F2 at half of theirs, and the
    search's K1 and K6 at 40%."""
    from benchmark.roofline import PEAKS, bound_s

    lengths = [28 + (i % 31) for i in range(512)]
    n, d = cfg["corpus_rows"], cfg["embed_dim"]
    work = {"calls": 2, "n": n, "d": d, "q": 512, "k": 100, "block": 16, "k6_rows": 400_000,
            "batch_lengths": [lengths, lengths], "tower_positions": 2 * 512 * 58,
            "tower_tokens": 2 * sum(lengths)}
    k1 = bound_s(2 * (n * d + 512 * d), 2.0 * n * 512 * d) / 0.4
    scored = 512 * 100 * 16
    k6 = bound_s(2 * 400_000 * d + 2 * 512 * d + 4 * scored, 2.0 * scored * d) / 0.4
    tower = bound_s(opcount_decoder.weight_bytes(cfg),
                    opcount_decoder.forward_flops(cfg, lengths)) / 0.6
    f1 = bound_s(*reversed(opcount_decoder.swiglu_work(cfg, lengths * 2)),
                 PEAKS["f32_flops"]) / 0.5
    f2 = bound_s(*reversed(opcount_decoder.rms_work(cfg, lengths * 2)), PEAKS["f32_flops"]) / 0.5
    groups = {"GEMM": tower - 0.5 * (f1 + f2), "F1 dense epilogue": f1 / 2,
              "F2 add+LayerNorm": f2 / 2}
    trace = TraceSummary(window_s=2.2 * tower, busy_s=2.1 * tower,
                         group_s={**{g: 2 * s for g, s in groups.items()},
                                  "K1 block_maxima": 2 * k1, "K6/K9 gather_score": 2 * k6},
                         launches=0, kernels=0, idle_gaps=[],
                         batch_groups=[groups, groups] if spans else [])
    return work, trace


def test_e5_readers_on_a_traced_window():
    cell = harness.load_cell(E5)
    work, trace = _e5_window(cell.config)
    outcome = harness.Outcome(attempted=1024, failed=0, end_to_end={}, checks={},
                              memory_peak_bytes=0, trace=trace, work=work)
    got = {k: v["value"] for k, v in harness.per_layer_metrics(cell, outcome).items()}
    assert set(got) == {"mfu.e5_search", "tower_roofline.e5_search", "f1_roofline.e5_search",
                        "f2_roofline.e5_search", "pad_pct.e5_search", "k1_roofline",
                        "k6_roofline", "device_idle_pct.search"}
    assert all(0 < v < 100 for v in got.values()), got
    assert got["tower_roofline.e5_search"] == pytest.approx(60.0)
    assert got["f1_roofline.e5_search"] == pytest.approx(50.0)
    assert got["f2_roofline.e5_search"] == pytest.approx(50.0)
    assert got["pad_pct.e5_search"] == pytest.approx(100 * (1 - 2 * 43 / 116), abs=0.5)
    assert got["k1_roofline"] == pytest.approx(40.0)
    assert got["k6_roofline"] == pytest.approx(40.0)
    assert got["device_idle_pct.search"] == pytest.approx(100 * (1 - 2.1 / 2.2))
    # without BATCH spans or counters those metrics are left out, not raised
    work, trace = _e5_window(cell.config, spans=False)
    work.pop("tower_positions")
    outcome = dataclasses.replace(outcome, trace=trace, work=work)
    assert set(harness.per_layer_metrics(cell, outcome)) == {
        "mfu.e5_search", "f1_roofline.e5_search", "f2_roofline.e5_search", "k1_roofline",
        "k6_roofline", "device_idle_pct.search"}


def test_e5_traced_run_counts_the_rescore_rows(monkeypatch):
    """A traced run reports K1's block and the rows K6 must read (the blocks
    its batches' embeddings select, each once), as the search cells do, so
    that k1_roofline and k6_roofline read the E5 cell. The profiler's window
    wants a card; here the window's calls run without it."""
    from proqa_tpu_torch.ops.mips import envelope_block

    cell = tiny(E5)
    cell = dataclasses.replace(cell, traffic={**cell.traffic, "trace_calls": 3})
    driver = harness.load_driver(cell.driver)
    monkeypatch.setattr(driver, "traced", lambda calls: (None, calls()))
    outcome = driver.run(
        cell, seed=2**31 + 5, seconds=0.5, trace=True, device=CPU, clock=harness.Clock())
    w, tr = outcome.work, cell.traffic
    n = cell.config["corpus_rows"]
    assert w["calls"] == 3 and w["block"] == envelope_block(n + (-n) % 1024, tr["batch"])
    # at least the k blocks one query selects, at most every selection apart
    assert tr["topk"] * w["block"] <= w["k6_rows"] <= tr["batch"] * tr["topk"] * w["block"]
    assert all(v <= lim for v, lim in outcome.checks.values()), outcome.checks


def test_decoder_operation_count():
    """The published 2 x 6.98e9 operations a token of the projections, and
    causal pairs with the window."""
    cell = harness.load_cell(E5)
    per_token = opcount_decoder.forward_flops(cell.config, [1]) - 4.0 * 32 * 32 * 128
    assert per_token == pytest.approx(2 * 6.98e9, rel=1e-3)
    assert opcount_decoder.attention_pairs(5, None) == 15
    assert opcount_decoder.attention_pairs(5, 2) == 1 + 2 * 4
    # the layers' weights in bf16 (the embedding table is read a row a token)
    assert opcount_decoder.weight_bytes(cell.config) == pytest.approx(2 * 6.98e9, rel=1e-3)
    assert np.isfinite(opcount_decoder.rms_work(cell.config, [30, 40])).all()
