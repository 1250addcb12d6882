"""Step timing, device traces and the program's named spans.

Counterpart of proqa_tpu/utils/profiling.py:
* StepTimer: wall-clock per-step timing with a percentile summary. On a CUDA
  device it synchronises before reading the clock, since PyTorch returns
  before the device has finished.
* TraceWindow: a torch.profiler trace (CPU and CUDA activity) of a few warm
  train steps, written as a Chrome trace into `log_dir`.
* span(name): a named range in torch.profiler's trace, beside its kernel and
  copy records and on its clock, opened only while a profiler collects.

The spans, all named `proqa.*`:
* proqa.search: DenseIndex.search, the whole call (the tombstone over-fetch
  nests a second one). Below it, in order:
  - proqa.search.upload: the queries to the device in the scoring dtype, and
    their padding;
  - proqa.search.block_maxima: stage 1 of the exact search, K1/K5/K7 and
    the block and group maxima's allocation (ops/mips_kernel.py);
  - proqa.search.select: stage 2, the rest of select_blocks (the padding
    mask, in place, of the tail groups alone, the straddling block, those
    groups' maxima again, the group and block top-k);
  - proqa.search.rescore: stage 3, K6 or the `take` gather and the final
    top-k (mips_topk_v2);
  - proqa.search.download: values and rows to numpy on the host.
  The three stages open in every caller of the exact search: QA evals,
  serving, each shard of a sharded search. profile_slice.span_times
  charges a trace's device and idle time to these spans.
* proqa.qa.decode: QATrainer's span decode (profile_slice groups its kernels
  by it).
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
from torch.profiler import record_function

_profiling = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A torch.profiler range named `name` while a profiler collects, else
    one shared null context: off, a span costs a check and makes nothing.
    A span never synchronises or touches a tensor."""
    return record_function(name) if _profiling() else _NO_SPAN


class StepTimer:
    def __init__(self, window: int = 200, device: torch.device | str | None = None):
        self.window = window
        self.device = torch.device(device) if device is not None else None
        self._times: list[float] = []
        self._t0: float | None = None

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self._times.append(time.perf_counter() - self._t0)
        if len(self._times) > self.window:
            self._times = self._times[-self.window:]

    def summary(self) -> dict:
        if not self._times:
            return {}
        arr = np.asarray(self._times)
        return {
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "steps_per_s": float(1.0 / arr.mean()),
        }


class TraceWindow:
    """Trace a window of warm train steps with torch.profiler.

    Call `tick()` at the top of every train iteration and `close()` after
    the loop. The first `skip` steps (warm-up: kernel builds, allocator
    growth) are left out; the next `steps` are traced and written to
    `log_dir/trace.json` (chrome://tracing or Perfetto). A profiler that
    fails to start logs one warning and disables the window rather than
    stopping training."""

    def __init__(self, log_dir: str, steps: int = 3, skip: int = 1, logger=None):
        self.log_dir, self.steps, self.skip = log_dir, steps, skip
        self.logger = logger
        self._seen = 0
        self._prof = None
        self._done = not log_dir

    def tick(self) -> None:
        if self._done:
            return
        self._seen += 1
        if self._prof is None and self._seen == self.skip + 1:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            try:
                self._prof = profile(activities=activities)
                self._prof.__enter__()
            except RuntimeError as e:
                if self.logger:
                    self.logger.warning(f"profiler trace unavailable: {e}")
                self._prof = None
                self._done = True
        elif self._prof is not None and self._seen == self.skip + self.steps + 1:
            self.close()

    def close(self) -> None:
        if self._prof is not None:
            self._prof.__exit__(None, None, None)
            os.makedirs(self.log_dir, exist_ok=True)
            path = os.path.join(self.log_dir, "trace.json")
            self._prof.export_chrome_trace(path)
            if self.logger:
                self.logger.info(f"device trace written to {path}")
            self._prof = None
        self._done = True
