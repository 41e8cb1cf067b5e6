"""Deterministic, restart-safe data pipeline.

A copy of ``repro.data.pipeline`` (pure Python; the port keeps its own
copy rather than importing the reference).  The contract that makes
checkpoint/restart exact: every batch is a pure function of
``(seed, step)`` — after a failure the trainer restores step s and the
pipeline regenerates batch s+1 bit-for-bit (no skipped or repeated
data).  A small background prefetcher overlaps
host batch synthesis with device compute.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator


class StepIndexedPipeline:
    def __init__(self, make_batch: Callable[[int], dict], start_step: int = 0,
                 prefetch: int = 2):
        self.make_batch = make_batch
        self.step = start_step
        self.prefetch = prefetch
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _worker(self):
        s = self.step
        while not self._stop.is_set():
            batch = self.make_batch(s)
            while not self._stop.is_set():
                try:
                    self._q.put((s, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        if self.prefetch > 0:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
            try:
                while True:
                    yield self._q.get()
            finally:
                self._stop.set()
        else:
            s = self.step
            while True:
                yield s, self.make_batch(s)
                s += 1

    def close(self):
        self._stop.set()
