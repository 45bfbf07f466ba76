"""Per-operator counters and timers (≙ ``blaze_tpu/runtime/metrics.py``
``MetricsSet``).  Timers measure host wall time: device work that is
still queued when a timer closes is not in it."""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict


class MetricsSet:
    """Counters + timers (nanoseconds) for one operator instance."""

    def __init__(self):
        self.values: Dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, name: str, v: int = 1) -> None:
        with self._lock:
            self.values[name] = self.values.get(name, 0) + int(v)

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.add(name, time.perf_counter_ns() - t0)
