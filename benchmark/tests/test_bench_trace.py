"""The trace arithmetic on synthetic traces, and the readers' roofline, MFU
and padding arithmetic on hand-worked shapes."""
from __future__ import annotations

import pytest

from benchmark import harness, opcount, trace
from benchmark.roofline import PEAKS


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1, "args": args}


def synthetic(drop_kernel: bool = False) -> dict:
    """A 100 us window: two K1 kernels (10-40, 50-70 us), one GEMM (60-80)
    overlapping the second, each launched inside a BATCH span; an aten op
    covering the idle 80-100 us, nothing on the host over 40-50 us."""
    ev = [_x("user_annotation", trace.WINDOW, 0, 100),
          _x("user_annotation", trace.BATCH, 1, 30), _x("user_annotation", trace.BATCH, 46, 30),
          _x("cuda_runtime", "cudaLaunchKernel", 2, 1, correlation=1),
          _x("cuda_runtime", "cudaLaunchKernelExC", 47, 1, correlation=2),
          _x("cuda_driver", "cuLaunchKernelEx", 48, 1, correlation=3),
          _x("cuda_runtime", "cudaMemcpyAsync", 49, 1, correlation=4),
          _x("kernel", "bmax_wgmma_wide_kernel<64, 2>", 10, 30, correlation=1),
          _x("kernel", "nvjet_hsh_128x256", 60, 20, correlation=3),
          _x("cpu_op", "aten::copy_", 78, 22), _x("cpu_op", "aten::to", 75, 25),
          _x("cpu_op", "aten::empty", 0, 9)]
    if not drop_kernel:
        ev.append(_x("kernel", "bmax_wgmma_kernel<64, 2>", 50, 20, correlation=2))
    return {"traceEvents": ev + [{"ph": "f", "name": "flow"}]}


def test_completeness_counts_launches_without_kernels():
    assert trace.missing_kernels(synthetic()["traceEvents"]) == 0
    assert trace.missing_kernels(synthetic(drop_kernel=True)["traceEvents"]) == 1


def test_summary_busy_groups_gaps_and_batches():
    s = trace.summarize(synthetic())
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(60e-6)          # 10-40 and 50-80
    assert s.group_s == pytest.approx({"K1 block_maxima": 50e-6, "GEMM": 20e-6})
    assert s.launches == 3 and s.kernels == 3
    # idle 0-10 under aten::empty, 40-50 with no op, 80-100 under aten::copy_
    assert dict(map(tuple, s.idle_gaps)) == pytest.approx(
        {"aten::copy_": 20e-6, "aten::empty": 10e-6, "(python)": 10e-6})
    assert s.batch_groups == [pytest.approx({"K1 block_maxima": 30e-6}),
                              pytest.approx({"K1 block_maxima": 20e-6, "GEMM": 20e-6})]
    b = s.breakdown()
    assert b["device_ops"][0][0] == "K1 block_maxima" and len(b["idle_gaps"]) == 3


def test_busy_union():
    assert trace.busy_us([(0, 10), (5, 15), (20, 25), (21, 22)]) == 20
    assert trace.union([(5, 15), (0, 10), (20, 25)]) == [(0, 15), (20, 25)]


def _reader(name, work, summary, config=None):
    return harness.load_reader(name).read({"work": work, "trace": summary, "config": config})


def _summary(**group_s):
    return trace.TraceSummary(window_s=0.1, busy_s=0.09, group_s=group_s, launches=0,
                              kernels=0, idle_gaps=[])


def test_search_rooflines_on_hand_worked_shapes():
    # N = 1,000,000, Q = 1,000, D = 100: 2e11 operations a batch, bound by
    # operations at 989e12/s: 0.2022 ms; K1 took 0.4 ms a batch over 4 batches
    work = {"calls": 4, "n": 1_000_000, "q": 1000, "d": 100, "k": 10, "block": 16,
            "k6_rows": 120_000}
    k1 = _reader("k1_roofline", work, _summary(**{"K1 block_maxima": 4 * 0.4e-3}))
    assert k1 == pytest.approx(100 * (2e11 / 989e12) / 0.4e-3)
    # K6: 160,000 candidate rows scored, of which 120,000 distinct, of 100
    # bf16 values (24 MB read once, 0.64 MB of scores written, 0.2 MB of
    # queries): bytes bound 7.4 us; took 20 us
    k6 = _reader("k6_roofline", work, _summary(**{"K6/K9 gather_score": 4 * 20e-6}))
    nbytes = 2 * 120_000 * 100 + 2 * 1000 * 100 + 4 * 160_000
    assert k6 == pytest.approx(100 * nbytes / 3.35e12 / 20e-6)
    # the whole window: 4 batches of 2e11 in 0.1 s at 989e12/s
    assert _reader("mfu.search", work, _summary()) == pytest.approx(100 * 8e11 / 0.1 / 989e12)
    assert _reader("device_idle_pct.search", work, _summary()) == pytest.approx(10.0)
    assert _reader("k1_roofline", work, _summary()) is None  # K1 absent: nothing to read


TINY = {"hidden_size": 4, "intermediate_size": 8, "num_hidden_layers": 2,
        "projection_dim": 2}


def test_bert_operation_counts_by_hand():
    # a row of 3 tokens: a layer's dense 2*3*(4*16 + 2*32) = 768, attention
    # 4*9*4 = 144; two layers 1,824; pooler 32, projection 16
    assert opcount.forward_flops(TINY, [3]) == 1824 + 32 + 16
    assert opcount.attention_work(TINY, [3, 1]) == (4 * 9 * 4 + 4 * 1 * 4, 8 * 4 * 4)
    # 4 tokens, 2 rows: plain elements 2*4*20 + 2*4 = 168, GELU 2*4*8 = 64
    assert opcount.epilogue_work(TINY, [3, 1]) == (168 + 25 * 64, 6 * (168 + 64) + 8 * 2 * 2)


def test_encode_readers_on_hand_worked_shapes():
    work = {"tokens": 100, "row_lengths": [60, 40], "batch_shapes": [(2, 64), (1, 128)],
            "batch_lengths": [[60, 40], [50]]}
    assert _reader("pad_pct.encode", work, _summary(), TINY) == pytest.approx(
        100 * (1 - 100 / 256))
    # K2 ran in the second batch only: its row of 50 is the work
    s = _summary(**{"K2 attention": 1e-6})
    s.batch_groups = [{"GEMM": 1.0}, {"K2 attention": 1e-6}]
    flops, nbytes = 4.0 * 50 * 50 * 4, 8.0 * 50 * 4
    want = 100 * 2 * max(nbytes / PEAKS["hbm_bytes_per_s"], flops / PEAKS["bf16_flops"]) / 1e-6
    assert _reader("k2_roofline.encode", work, s, TINY) == pytest.approx(want)
    assert _reader("k2_roofline.encode", work, _summary(), TINY) is None
    flops, nbytes = opcount.epilogue_work(TINY, [60, 40])
    f1 = _reader("f1_roofline.encode", work, _summary(**{"F1 dense epilogue": 1e-6}), TINY)
    assert f1 == pytest.approx(100 * max(nbytes / 3.35e12, flops / 67e12) / 1e-6)
    # one reader for the towers' shares, its passes from the driver
    for name, passes in (("mfu.encode", 1), ("mfu.train", 3)):
        assert _reader(name, {**work, "passes": passes}, _summary(), TINY) == pytest.approx(
            100 * passes * opcount.forward_flops(TINY, [60, 40]) / 0.1 / 989e12)
    assert _reader("device_idle_pct.train", work, _summary(), TINY) == pytest.approx(10.0)
