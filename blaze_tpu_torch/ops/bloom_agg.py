"""Bloom-filter aggregation (≙ ``blaze_tpu/ops/bloom_agg.py``): the
GLOBAL aggregate Spark 3.5's ``InjectRuntimeFilter`` plants on a
selective join side, ``bloom_filter_agg(xxhash64(k))``.

PARTIAL lowers its long-typed expression on the batch's device, brings
the values to the host in one copy and builds one filter per partition
in numpy (the reference builds on the host too); the merge modes OR the
incoming filters' words; every mode emits the serialized filter as one
BINARY row, which ``might_contain`` probes on the device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..batch import RecordBatch, bucket_capacity, column_from_strings, column_to_pylist, tensors_to_host
from ..exprs.bloom import SparkBloomFilter, optimal_num_bits, optimal_num_hashes
from ..exprs.compile import lower
from ..exprs.ir import Expr
from ..runtime.context import TaskContext
from ..schema import DataType, Field, Schema, string_width_for
from .agg import AggMode
from .base import BatchStream, ExecNode


class BloomFilterAggExec(ExecNode):
    def __init__(self, child: ExecNode, expr: Optional[Expr], name: str, mode: AggMode,
                 expected_items: int = 1_000_000, num_bits: Optional[int] = None):
        super().__init__([child])
        self.expr = expr
        self.agg_name = name
        self.mode = mode
        self.expected_items = expected_items
        self.num_bits = num_bits or optimal_num_bits(expected_items)
        self.num_hashes = optimal_num_hashes(expected_items, self.num_bits)
        payload = 12 + self.num_bits // 8  # the stream header and the words
        self._schema = Schema([Field(name, DataType.binary(string_width_for(payload)))])

    @property
    def schema(self) -> Schema:
        return self._schema

    def _emit(self, filt: SparkBloomFilter, device) -> RecordBatch:
        dtype = self._schema.fields[0].dtype
        col = column_from_strings([filt.serialize()], capacity=bucket_capacity(1), dtype=dtype,
                                  device=device)
        return RecordBatch(self._schema, [col], 1)

    def execute(self, partition: int, ctx: TaskContext) -> BatchStream:
        child = self.children[0]
        in_schema = child.schema

        def stream():
            filt = SparkBloomFilter(self.num_bits, self.num_hashes)
            device = None
            for batch in child.execute(partition, ctx):
                if not ctx.is_task_running():
                    return
                device, n = batch.device, batch.num_rows
                with self.metrics.timer("elapsed_compute"):
                    if self.mode == AggMode.PARTIAL:
                        env = {f.name: c for f, c in zip(in_schema.fields, batch.columns)}
                        c = lower(self.expr, in_schema, env, batch.capacity)
                        data, valid = tensors_to_host([c.data[:n], c.validity[:n]])
                        vals = data[valid]
                        if vals.size:
                            filt.put_longs(vals.astype(np.int64))
                        continue
                    # the merge modes: OR the incoming serialized filters
                    for payload in column_to_pylist(batch.columns[0], n):
                        other = SparkBloomFilter.deserialize(payload)
                        if other.num_bits != filt.num_bits:
                            raise ValueError(f"bloom filter of {other.num_bits} bits merged into "
                                             f"{filt.num_bits}")
                        filt.words |= other.words
                        filt.num_hashes = other.num_hashes
            self.metrics.add("output_rows", 1)
            yield self._emit(filt, device or self.device)

        return stream()
