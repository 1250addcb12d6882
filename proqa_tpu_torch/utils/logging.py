"""Logging, meters and scalar metric streams.

Copy of proqa_tpu/utils/logging.py (pure Python): the port imports nothing of the JAX
package.

Replaces the reference's SummaryWriter + AverageMeter + file/stream logging
(upstream retrieval/train_retriever.py:46-61,216-220,
 retrieval/utils.py:44-60) with a tensorboard-free JSONL scalar stream
(easy to tail, diff and plot anywhere) plus standard logging.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time


def setup_logger(name: str = "proqa", log_file: str | None = None) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter(
        "%(asctime)s - %(levelname)s - %(name)s - %(message)s", "%m/%d/%Y %H:%M:%S"
    )
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MetricLogger:
    """Append-only JSONL scalar stream: {"step": s, "tag": t, "value": v, "t": wall}."""

    def __init__(self, path: str | None):
        self._f = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")

    def scalar(self, tag: str, value: float, step: int):
        if self._f is None:
            return
        self._f.write(
            json.dumps({"step": step, "tag": tag, "value": float(value), "t": time.time()}) + "\n"
        )
        self._f.flush()

    def close(self):
        if self._f:
            self._f.close()
            self._f = None
