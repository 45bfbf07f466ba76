"""Hand-written Hopper kernels (``csrc/``), their wrappers and plain
PyTorch versions (``cuda_ops``), and their build (``build``).

- murmur3_pids: shuffle partition ids of fixed-width keys (Spark
  murmur3 seed 42 + pmod), one pass over the key columns.
- sorted_lookup: the hash-join probe's candidate ranges in the sorted
  build-key table.
"""
