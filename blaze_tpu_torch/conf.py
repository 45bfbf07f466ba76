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


# a PARTIAL agg with groupings stops aggregating once its groups pass
# ratio of its input rows, checked from minRows input rows on; its
# states then stream to the merge after the exchange
ENABLE_PARTIAL_AGG_SKIPPING = ConfEntry("spark.blaze.partialAggSkipping.enable", True, _bool)
PARTIAL_AGG_SKIPPING_RATIO = ConfEntry("spark.blaze.partialAggSkipping.ratio", 0.8, float)
PARTIAL_AGG_SKIPPING_MIN_ROWS = ConfEntry("spark.blaze.partialAggSkipping.minRows", 20000, int)
# smallest padded batch capacity (capacities are powers of two above it)
MIN_CAPACITY = ConfEntry("spark.blaze.tpu.minBatchCapacity", 1024, int)
# exchanges keep map output in device memory, in process; false sends
# plan.execute()'s exchanges through .data/.index shuffle files
EXCHANGE_IN_PROCESS = ConfEntry("spark.blaze.exchange.inProcess", True, _bool)
# the task optimizer (ops/fusion.py optimize_plan): false runs every
# plan as it was built or serialized
FUSION_ENABLE = ConfEntry("spark.blaze.fusion.enabled", True, _bool)
# a shuffle write stages each batch's host copy on a second thread,
# with at most queueDepth batches waiting for it
SHUFFLE_ASYNC_WRITE = ConfEntry("spark.blaze.shuffle.asyncWrite", True, _bool)
SHUFFLE_ASYNC_QUEUE_DEPTH = ConfEntry("spark.blaze.shuffle.asyncWrite.queueDepth", 2, int)
# map and broadcast stages of run_stages run this many tasks at a time
STAGE_TASK_CONCURRENCY = ConfEntry("spark.blaze.stage.taskConcurrency", 1, int)
# the codec of shuffle files and broadcast blobs (io/ipc_compression.py):
# zlib, zstd, lz4 or raw; another name means zlib, as in the reference
IO_COMPRESSION_CODEC = ConfEntry("spark.io.compression.codec", "zlib", str)
# rows per batch a file scan emits, and the target of CoalesceBatchesExec
BATCH_SIZE = ConfEntry("spark.blaze.batchSize", 8192, int)
# a file scan skips (and counts) a file whose metadata it cannot read
IGNORE_CORRUPT_FILES = ConfEntry("spark.files.ignoreCorruptFiles", False, _bool)
# a parquet scan prunes row groups by its predicate over chunk statistics
PARQUET_FILTER_PUSHDOWN = ConfEntry("spark.blaze.parquet.enable.pageFiltering", True, _bool)
# batches a file scan's producer thread decodes ahead of its consumer;
# 0 decodes on the consumer's thread
PIPELINE_DEPTH = ConfEntry("spark.blaze.pipeline.depth", 2, int)
# pickled payloads (a TaskDefinition's UDAFs, the opaque columns of the
# batch wire format) run arbitrary code when they are decoded: a
# deployment across a trust boundary sets this false
ALLOW_PICKLED_UDFS = ConfEntry("spark.blaze.udf.allowPickled", True, _bool)
# the element budget of a collect_list/collect_set result: the padded
# layout holds at most this many elements a group, and drops the rest
COLLECT_MAX_ELEMS = ConfEntry("spark.blaze.collect.maxElems", 64, int)

# Fault-tolerant stage execution (runtime/retry.py and the scheduler's
# attempt loop).  Total attempts a task, 1 fails fast (≙
# spark.task.maxFailures)
TASK_MAX_ATTEMPTS = ConfEntry("spark.blaze.task.maxAttempts", 4, int)
# first retry delay in seconds, doubling each attempt with a
# deterministic jitter (RetryPolicy.backoff); 0 sleeps never
TASK_RETRY_BACKOFF = ConfEntry("spark.blaze.task.retryBackoff", 0.1, float)
# seconds a task may run, checked between its output batches; 0: no limit
TASK_TIMEOUT = ConfEntry("spark.blaze.task.timeout", 0.0, float)
# a task whose heartbeat (an operator's output batch) is older than
# this many ms is cancelled and retried as a timeout
# (runtime/speculation.py); 0: off
TASK_WEDGE_MS = ConfEntry("spark.blaze.task.wedgeMs", 0, int)
# regenerations of a producing stage a fetching task may ask for
STAGE_MAX_ATTEMPTS = ConfEntry("spark.blaze.stage.maxAttempts", 4, int)
# speculative attempts (≙ spark.speculation): once quantile of a
# stage's tasks are done, a task running longer than multiplier x their
# median (and at least minRuntime seconds), or whose heartbeat is older
# than wedgeMs ms (0: off), gets one backup attempt; the first commit wins
SPECULATION_ENABLE = ConfEntry("spark.blaze.speculation.enabled", False, _bool)
SPECULATION_MULTIPLIER = ConfEntry("spark.blaze.speculation.multiplier", 1.5, float)
SPECULATION_QUANTILE = ConfEntry("spark.blaze.speculation.quantile", 0.75, float)
SPECULATION_MIN_RUNTIME = ConfEntry("spark.blaze.speculation.minRuntime", 0.1, float)
SPECULATION_WEDGE_MS = ConfEntry("spark.blaze.speculation.wedgeMs", 0, int)
# the fault schedule (runtime/faults.py grammar, e.g.
# "shuffle.fetch@2,task.compute@1@a0"); empty injects nothing.  The
# environment's BLAZE_FAULTS_SPEC overrides it
FAULTS_SPEC = ConfEntry("spark.blaze.faults.spec", "", str)

# The worker host pool (runtime/hostpool.py): persistent
# ``worker.py --serve`` processes the scheduler binds map tasks to.
# Workers a pool starts when its caller names no count; 0: no pool
POOL_WORKERS = ConfEntry("spark.blaze.pool.workers", 0, int)
# ms between a pooled worker's heartbeat frames on its stdout
POOL_HEARTBEAT_MS = ConfEntry("spark.blaze.pool.heartbeatMs", 50, int)
# heartbeat silence (ms) past which a ready worker is declared lost;
# well above heartbeatMs
POOL_LIVENESS_TIMEOUT_MS = ConfEntry("spark.blaze.pool.livenessTimeoutMs", 10000, int)
# a slot lost this many times within decaySec seconds is blacklisted
# (not respawned) until its count decays below it (≙ spark.blacklist.*)
HOST_BLACKLIST_MAX_FAILURES = ConfEntry("spark.blaze.host.blacklist.maxFailures", 2, int)
HOST_BLACKLIST_DECAY_SEC = ConfEntry("spark.blaze.host.blacklist.decaySec", 60.0, float)
# ms a query may run from its cancel scope's opening; 0: no deadline
QUERY_TIMEOUT_MS = ConfEntry("spark.blaze.query.timeoutMs", 0, int)
