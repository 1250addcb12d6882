"""The port's named spans (utils/profiling.py:span) on the exact search path:
under torch.profiler each DenseIndex.search opens proqa.search and, inside
it in order, its upload, block maxima, select, rescore and download; the
results are the same bits with and without a profiler; with none running a
span is one shared null context and no record_function is made. And
profile_slice.span_times, which charges a trace's device and idle time to
those spans, on synthetic traces and on a CPU trace of a search."""
import contextlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from proqa_tpu_torch import profile_slice  # noqa: E402
from proqa_tpu_torch.index.dense import DenseIndex  # noqa: E402
from proqa_tpu_torch.utils import profiling  # noqa: E402
from proqa_tpu_torch.utils.profiling import span  # noqa: E402

STAGES = ("proqa.search.upload", "proqa.search.block_maxima", "proqa.search.select",
          "proqa.search.rescore", "proqa.search.download")
N, D, K = 5000, 16, 5  # past 4,096 rows: mips_topk_v2, its padding mask and straddler


def _index(dtype=torch.bfloat16):
    rows = np.random.default_rng(0).standard_normal((N, D)).astype(np.float32)
    return DenseIndex.from_embeddings(rows, device="cpu", dtype=dtype)


def _queries(q=8, seed=1):
    return np.random.default_rng(seed).standard_normal((q, D)).astype(np.float32)


def _spans(run, tmp_path):
    """run() under a CPU profiler: (its result, the proqa.* spans of the
    exported chrome trace as (name, start, end) in start order)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((float(e["ts"]), -float(e["dur"]), e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith("proqa."))
    return out, [(name, s, s - neg_dur) for s, neg_dur, name in spans]


def _check_call(spans):
    """One search call's spans: proqa.search, then each stage once, in
    order, inside it and each ending before the next starts."""
    (top, t0, t1), *stages = spans
    assert top == "proqa.search"
    assert [name for name, *_ in stages] == list(STAGES)
    assert all(t0 <= s <= e <= t1 for _, s, e in stages)
    assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, "int8"])
def test_search_opens_each_span_once_in_order(dtype, tmp_path):
    index = _index(dtype)
    _, spans = _spans(lambda: index.search(_queries(), K), tmp_path)
    assert len(spans) == 1 + len(STAGES)
    _check_call(spans)


def test_two_calls_open_two_of_each(tmp_path):
    index = _index()
    _, spans = _spans(lambda: [index.search(_queries(seed=s), K) for s in (1, 2)], tmp_path)
    assert len(spans) == 2 * (1 + len(STAGES))
    _check_call(spans[:6])
    _check_call(spans[6:])


def test_tombstone_over_fetch_nests_a_second_search(tmp_path):
    index = _index()
    vals, rows = index.search(_queries(), K)
    index.remove_rows(rows[:, 0])
    _, spans = _spans(lambda: index.search(_queries(), K), tmp_path)
    outer, inner = spans[0], spans[1]
    assert outer[0] == inner[0] == "proqa.search" and outer[1] <= inner[1] <= inner[2] <= outer[2]
    _check_call(spans[1:])


@pytest.mark.parametrize("dtype", [torch.bfloat16, "int8"])
def test_results_bit_identical_with_and_without_profiler(dtype, tmp_path):
    index = _index(dtype)
    queries = _queries(q=40)
    want_vals, want_rows = index.search(queries, K)
    (vals, rows), spans = _spans(lambda: index.search(queries, K), tmp_path)
    assert spans
    np.testing.assert_array_equal(vals, want_vals)
    np.testing.assert_array_equal(rows, want_rows)
    assert vals.dtype == want_vals.dtype and rows.dtype == want_rows.dtype


def test_span_off_is_one_shared_null_context_and_makes_no_record_function(monkeypatch):
    index = _index()
    want_vals, want_rows = index.search(_queries(), K)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) made with no profiler running")

    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert span("proqa.search") is span("proqa.search.select")
    assert isinstance(span("proqa.search"), contextlib.nullcontext)
    vals, rows = index.search(_queries(), K)
    np.testing.assert_array_equal(vals, want_vals)
    np.testing.assert_array_equal(rows, want_rows)


def test_span_on_is_a_profiler_range():
    with profile(activities=[ProfilerActivity.CPU]):
        s = span("proqa.search")
        assert isinstance(s, torch.profiler.record_function)
    assert isinstance(span("proqa.search"), contextlib.nullcontext)


def test_profile_slice_groups_the_decode_span():
    """profile_slice charges a kernel launched inside proqa.qa.decode, on the
    span's thread, to the span."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "proqa.qa.decode", "ts": 10, "dur": 20,
           "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::topk", "ts": 12, "dur": 2, "tid": 1,
           "args": {"External id": 7}},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 40, "dur": 2, "tid": 1,
           "args": {"External id": 8}},
          {"ph": "X", "cat": "kernel", "name": "topk_kernel", "ts": 15, "dur": 4,
           "args": {"External id": 7}},
          {"ph": "X", "cat": "kernel", "name": "nvjet_hsh", "ts": 45, "dur": 6,
           "args": {"External id": 8}}]
    got = profile_slice.trace_breakdown({"traceEvents": ev}, calls=1, wall_ms=1.0)
    assert got["ms_per_call_by_group"] == pytest.approx(
        {"proqa.qa.decode": 4e-3, "GEMM": 6e-3})


def _on(tid, cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def _with_spans() -> list[dict]:
    """A 100 us window on thread 1 holding one search call's program spans:
    proqa.search 5-95 over upload 5-15, block_maxima 15-30, select 30-60,
    rescore 60-75 and download 76-95. Thread 1 calls for a copy in the upload
    (GPU 10-12), K1 in the block maxima (20-40), two kernels in the select
    (40-50, 50-56), K6 in the rescore (64-70), a kernel between rescore and
    download (86-88) and a copy in the download (78-80); thread 2, with no
    spans, launches a kernel at 20 (82-84). Busy 50 us; idle 0-10, 12-20,
    56-64, 70-78, 80-82, 84-86 and 88-100."""
    s = "proqa.search"
    return [_on(1, "user_annotation", profile_slice.WINDOW, 0, 100),
            _on(1, "user_annotation", s, 5, 90), _on(1, "user_annotation", s + ".upload", 5, 10),
            _on(1, "user_annotation", s + ".block_maxima", 15, 15),
            _on(1, "user_annotation", s + ".select", 30, 30),
            _on(1, "user_annotation", s + ".rescore", 60, 15),
            _on(1, "user_annotation", s + ".download", 76, 19),
            _on(1, "cpu_op", "aten::copy_", 3, 9),
            _on(1, "cuda_runtime", "cudaMemcpyAsync", 8, 1, correlation=11),
            _on(1, "cuda_runtime", "cudaLaunchKernelExC", 16, 1, correlation=12),
            _on(1, "cuda_runtime", "cudaLaunchKernel", 31, 1, correlation=13),
            _on(1, "cuda_runtime", "cudaLaunchKernel", 50, 1, correlation=14),
            _on(1, "cuda_driver", "cuLaunchKernel", 62, 1, correlation=15),
            _on(1, "cuda_runtime", "cudaLaunchKernel", 75.5, 0.2, correlation=16),
            _on(1, "cuda_runtime", "cudaMemcpyAsync", 77, 1, correlation=17),
            _on(2, "cuda_runtime", "cudaLaunchKernel", 20, 1, correlation=18),
            _on(7, "gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 10, 2, correlation=11),
            _on(7, "kernel", "bmax_wgmma_kernel<64, 2>", 20, 20, correlation=12),
            _on(7, "kernel", "elementwise_kernel<128, 4>", 40, 10, correlation=13),
            _on(7, "kernel", "reduce_kernel<512, 1>", 50, 6, correlation=14),
            _on(7, "kernel", "gather_score_kernel", 64, 6, correlation=15),
            _on(7, "kernel", "elementwise_kernel<128, 2>", 86, 2, correlation=16),
            _on(7, "gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 78, 2, correlation=17),
            _on(8, "kernel", "topk_kernel", 82, 2, correlation=18)]


def test_span_device_time_charged_to_the_innermost_span_of_the_calling_thread():
    device, _ = profile_slice.span_times(_with_spans())
    # the select's two kernels go to it, not to proqa.search around it; the
    # kernel called between rescore and download to proqa.search; copies by
    # their cudaMemcpyAsync; thread 2's launch to no span
    assert device == pytest.approx({
        "proqa.search": 2e-6, "proqa.search.upload": 2e-6,
        "proqa.search.block_maxima": 20e-6, "proqa.search.select": 16e-6,
        "proqa.search.rescore": 6e-6, "proqa.search.download": 2e-6})
    assert sum(device.values()) == pytest.approx(50e-6 - 2e-6)


def test_span_idle_split_at_span_boundaries_sums_to_the_idle_time():
    _, idle = profile_slice.span_times(_with_spans())
    # 12-20 crosses upload -> block_maxima at 15; 70-78 crosses rescore ->
    # proqa.search -> download at 75 and 76; 88-100 leaves every span at 95
    assert idle == pytest.approx({
        "(none)": 10e-6, "proqa.search": 1e-6, "proqa.search.upload": 8e-6,
        "proqa.search.block_maxima": 5e-6, "proqa.search.select": 4e-6,
        "proqa.search.rescore": 9e-6, "proqa.search.download": 13e-6})
    assert sum(idle.values()) == pytest.approx(100e-6 - 50e-6, rel=1e-12)


def test_trace_breakdown_reports_the_spans_a_call():
    got = profile_slice.trace_breakdown({"traceEvents": _with_spans()}, calls=2, wall_ms=0.1)
    assert got["device_ms_per_call_by_span"]["proqa.search.select"] == pytest.approx(8e-3)
    assert got["idle_ms_per_call_by_span"]["proqa.search.download"] == pytest.approx(6.5e-3)
    assert list(got["device_ms_per_call_by_span"])[0] == "proqa.search.block_maxima"


def test_span_times_without_spans_or_window():
    events = [e for e in _with_spans() if not e["name"].startswith("proqa.")]
    device, idle = profile_slice.span_times(events)
    assert device == {} and idle == pytest.approx({"(none)": 50e-6})
    no_window = [e for e in _with_spans() if e["name"] != profile_slice.WINDOW]
    assert profile_slice.span_times(no_window) == ({}, {})


def test_span_times_on_a_cpu_trace_of_search(tmp_path):
    """A real trace: every span of the call is a key, none has device time
    on the CPU, and the idle pieces sum to the whole window."""
    index = _index()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(profile_slice.WINDOW):
            index.search(_queries(), K)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    device, idle = profile_slice.span_times(events)
    assert device == {name: 0.0 for name in ("proqa.search", *STAGES)}
    window = next(e for e in events if e["name"] == profile_slice.WINDOW)
    assert set(device) <= set(idle)
    # within the rounding of the trace's epoch timestamps (about 0.2 ns each)
    assert sum(idle.values()) == pytest.approx(float(window["dur"]) / 1e6, abs=1e-8)
