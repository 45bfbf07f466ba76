"""Configuration knobs the port reads (its own small copy of the
entries of ``blaze_tpu/conf.py`` this slice needs, with the same key
strings and defaults).

A process-global key -> value store; ``BLAZE_<NAME>`` environment
variables override programmatic values, as in the reference.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict

_lock = threading.Lock()
_values: Dict[str, Any] = {}


class ConfEntry:
    """One typed knob: env override > programmatic set > default."""

    def __init__(self, key: str, default: Any, parse: Callable[[str], Any]):
        self.key = key
        self.default = default
        self._parse = parse
        self._env_key = (
            "BLAZE_" + key.replace("spark.blaze.", "").replace(".", "_").upper()
        )

    def get(self) -> Any:
        if self._env_key in os.environ:
            return self._parse(os.environ[self._env_key])
        with _lock:
            return _values.get(self.key, self.default)

    def set(self, value: Any) -> None:
        with _lock:
            _values[self.key] = value


def _bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


# smallest padded batch capacity (capacities are powers of two above it)
MIN_CAPACITY = ConfEntry("spark.blaze.tpu.minBatchCapacity", 1024, int)
# exchanges keep map output in device memory, in process; false sends
# plan.execute()'s exchanges through .data/.index shuffle files
EXCHANGE_IN_PROCESS = ConfEntry("spark.blaze.exchange.inProcess", True, _bool)
