"""Background-prefetching batch loader.

Copy of proqa_tpu/data/loader.py: the port keeps its own host code and imports
nothing of the JAX package.

Replaces torch DataLoader worker pools (reference train_retriever.py:186,
num_workers=8) with a thread that tokenizes/collates ahead of the device:
host work overlaps TPU steps, batches are handed over as numpy (device_put
happens inside the jitted step via donated buffers).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()


class BatchLoader:
    """Single-use: one pass over `batch_iter`, then the loader is spent.

    `close()` (also called when iteration ends or is abandoned mid-way via
    GC) unblocks and retires the producer thread — without it, a consumer
    that stops iterating early (early stop, exception) would leave the
    producer parked in a full queue forever, pinning the source iterator
    and its prefetched batches for process lifetime.
    """

    def __init__(self, batch_iter: Iterable, prefetch: int = 4):
        self._iter = batch_iter
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._err: BaseException | None = None
        self._closed = threading.Event()
        self._consumed = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._iter:
                while not self._closed.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._closed.is_set():
                    return
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            # blocking-with-close-check, like item puts: the queue can be
            # full of real items at normal exhaustion, and dropping the
            # sentinel then would hang the consumer
            while not self._closed.is_set():
                try:
                    self._q.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def close(self):
        """Stop the producer and drop any prefetched batches."""
        self._closed.set()
        while True:  # drain so a put()-blocked producer can observe close
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __iter__(self) -> Iterator:
        if self._consumed:
            # the sentinel was eaten by the first pass; a second pass would
            # block forever on an empty queue with no producer left
            raise RuntimeError(
                "BatchLoader is single-use; construct a new one per pass"
            )
        self._consumed = True
        try:
            while True:
                item = self._q.get()
                if item is _SENTINEL:
                    if self._err is not None:
                        raise self._err
                    return
                yield item
        finally:
            self.close()
