"""Pipelined batch streams (≙ ``blaze_tpu/runtime/pipeline.py``): a
producer thread drives the upstream generator into a bounded queue, so
host work (file decode, slicing, the host-to-device copy) overlaps the
card's work on the batches already handed on.

Ordering is preserved; an exception in the producer re-raises at the
consumer and is never swallowed; closing the consumer, or cancelling
the task, stops the producer within one poll interval.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

from .. import conf

_DONE = object()


def pipelined(stream: Iterable, ctx, depth: int = 2, name: str = "pipeline") -> Iterator:
    """Run ``stream`` in a producer thread behind a ``depth``-bounded
    queue."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def put(item) -> bool:
        while True:
            if stop.is_set() or not ctx.is_task_running():
                return False
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue

    def produce():
        try:
            for item in stream:
                if not put(item):
                    return
            put(_DONE)
        except BaseException as e:  # noqa: BLE001 — forwarded to the consumer, not swallowed
            put(e)

    t = threading.Thread(target=produce, name=f"blaze-torch-{name}", daemon=True)

    def consume():
        # started lazily: a stream that is never iterated leaks no thread
        t.start()
        try:
            while True:
                try:
                    item = q.get(timeout=0.05)
                except queue.Empty:
                    if not ctx.is_task_running():
                        return
                    continue
                if item is _DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

    return consume()


def maybe_pipelined(stream: Iterable, ctx, name: str = "pipeline") -> Iterator:
    """``stream`` behind ``spark.blaze.pipeline.depth`` (0: as it is)."""
    depth = int(conf.PIPELINE_DEPTH.get())
    if depth <= 0:
        return iter(stream)
    return pipelined(stream, ctx, depth, name)
