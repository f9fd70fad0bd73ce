"""Background-prefetch wrapper around the synthetic stream (the port's
copy of `repro/data/pipeline.py`).

A real deployment replaces SyntheticStream with a memmap shard reader; the
prefetch thread + bounded queue and the stateless step-indexed API stay
identical, which is the property fault-tolerant resume relies on.
"""
from __future__ import annotations

import queue
import threading

from repro_torch.data.synthetic import SyntheticStream


class PrefetchLoader:
    def __init__(self, stream: SyntheticStream, start_step: int = 0,
                 depth: int = 2):
        self.stream = stream
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._next = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._next
        while not self._stop.is_set():
            batch = self.stream.batch(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.2)
                    break
                except queue.Full:
                    continue
            step += 1

    def get(self) -> tuple[int, dict]:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
