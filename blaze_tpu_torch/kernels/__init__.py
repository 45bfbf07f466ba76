"""Hand-written Hopper kernels (``csrc/``), their wrappers and plain
PyTorch versions (``cuda_ops``), and their build (``build``).

- murmur3_pids: shuffle partition ids of fixed-width keys (Spark
  murmur3 seed 42 + pmod), one pass over the key columns.
- pid_histogram: rows per partition, the counts of every hash
  exchange's map output.
- fused_group_sums: small-cardinality grouped float32 sums with the
  filter folded into gid -1 (the TPC-H q01 shape).
- sorted_lookup: the hash-join probe's candidate ranges in the sorted
  build-key table.

Each wrapper runs its kernel on a CUDA tensor and its plain version on
a CPU tensor; nothing falls back.
"""

from .cuda_ops import (
    fused_group_sums,
    fused_group_sums_plain,
    murmur3_pids,
    murmur3_pids_plain,
    pid_histogram,
    pid_histogram_plain,
    sorted_lookup,
    sorted_lookup_plain,
)

__all__ = [
    "fused_group_sums",
    "fused_group_sums_plain",
    "murmur3_pids",
    "murmur3_pids_plain",
    "pid_histogram",
    "pid_histogram_plain",
    "sorted_lookup",
    "sorted_lookup_plain",
]
