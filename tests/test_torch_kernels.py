"""The port's kernel modules against the JAX package's Pallas kernels.

The same numpy inputs, made from a seed, go through the JAX kernel (in
interpret mode on the CPU, as ``tests/test_pallas.py`` runs it) and the
port's wrapper, which on a CPU tensor runs its plain version.  Partition
ids and lookup bounds are exact integers: everything compares equal.
"""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from blaze_tpu.batch import column_from_numpy as jax_column
from blaze_tpu.exprs.hash import murmur3_columns as jax_murmur3_columns
from blaze_tpu.exprs.hash import pmod as jax_pmod
from blaze_tpu.kernels import pallas_ops
from blaze_tpu.schema import DataType as JT

from blaze_tpu_torch.batch import column_from_numpy
from blaze_tpu_torch.kernels import cuda_ops
from blaze_tpu_torch.schema import DataType


def _both_columns(dtype, jdtype, vals, valid):
    n = vals.shape[0]
    jcol = jax_column(jdtype, vals, valid, capacity=n).to_device()
    tcol = column_from_numpy(dtype, vals, valid, capacity=n, device="cpu")
    return jcol, tcol


def _jax_pids(jcols, n_parts):
    planes, widths, valids = [], [], []
    for c in jcols:
        p, w = pallas_ops.column_word_planes(c)
        planes += p
        widths.append(w)
        valids.append(jnp.asarray(c.validity))
    kernel = np.asarray(pallas_ops.murmur3_pids(planes, widths, valids, n_parts))
    xla = np.asarray(jax_pmod(jax_murmur3_columns(jcols), n_parts))
    np.testing.assert_array_equal(kernel, xla)
    return kernel


def _port_pids(tcols, n_parts):
    planes, widths = zip(*(cuda_ops.column_word_planes(c) for c in tcols))
    return cuda_ops.murmur3_pids(list(planes), list(widths), [c.validity for c in tcols], n_parts).numpy()


_GENS = {
    "int32": (DataType.int32(), JT.int32(), lambda rng, n: rng.integers(-(2**31), 2**31, n).astype(np.int32)),
    "int64": (DataType.int64(), JT.int64(), lambda rng, n: rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)),
    "float64": (DataType.float64(), JT.float64(),
                lambda rng, n: np.concatenate([[0.0, -0.0, 1.5, -2.25], rng.standard_normal(n - 4)])),
    "float32": (DataType.float32(), JT.float32(),
                lambda rng, n: np.concatenate([[0.0, -0.0], rng.standard_normal(n - 2)]).astype(np.float32)),
    "decimal": (DataType.decimal(12, 2), JT.decimal(12, 2), lambda rng, n: rng.integers(-(2**40), 2**40, n)),
    "date32": (DataType.date32(), JT.date32(), lambda rng, n: rng.integers(0, 20000, n).astype(np.int32)),
    "bool": (DataType.bool_(), JT.bool_(), lambda rng, n: rng.integers(0, 2, n).astype(np.bool_)),
}


@pytest.mark.parametrize("kind", sorted(_GENS))
def test_murmur3_pids_every_key_dtype(kind):
    """Every column_word_planes branch, with nulls, N not a multiple
    of the TPU kernel's 1024-row tile."""
    dtype, jdtype, gen = _GENS[kind]
    rng = np.random.default_rng(7)
    n = 1100
    vals = gen(rng, n)
    valid = rng.random(n) > 0.15
    jcol, tcol = _both_columns(dtype, jdtype, vals, valid)
    np.testing.assert_array_equal(_port_pids([tcol], 31), _jax_pids([jcol], 31))


@pytest.mark.parametrize("n_parts", [8, 17, 200])
def test_murmur3_pids_q03_key_shape_with_nulls(n_parts):
    """(int64, date32, int32) keys, as q03's final-agg exchange has."""
    rng = np.random.default_rng(n_parts)
    n = 3000
    cols = []
    for kind in ("int64", "date32", "int32"):
        dtype, jdtype, gen = _GENS[kind]
        cols.append(_both_columns(dtype, jdtype, gen(rng, n), rng.random(n) > 0.2))
    want = _jax_pids([j for j, _ in cols], n_parts)
    np.testing.assert_array_equal(_port_pids([t for _, t in cols], n_parts), want)


_CHAIN_KINDS = ("int64", "int32", "date32", "decimal", "float64", "float32", "bool", "int64", "int32")


def _chain_columns(k, n, seed):
    """k key columns of mixed kinds with nulls: past KEYS_PER_LAUNCH
    for k > 8, where the kernel chains its launches."""
    rng = np.random.default_rng(seed)
    cols = []
    for i in range(k):
        dtype, jdtype, gen = _GENS[_CHAIN_KINDS[i % len(_CHAIN_KINDS)]]
        cols.append(_both_columns(dtype, jdtype, gen(rng, n), rng.random(n) > 0.1))
    return cols


@pytest.mark.parametrize("k", [9, 17])
def test_murmur3_pids_more_keys_than_one_launch_takes(k):
    assert k > cuda_ops.KEYS_PER_LAUNCH
    cols = _chain_columns(k, 1100, seed=k)
    want = _jax_pids([j for j, _ in cols], 13)
    np.testing.assert_array_equal(_port_pids([t for _, t in cols], 13), want)


def test_nine_key_exchange_places_rows_as_the_reference():
    """A 9-key hash exchange: every row lands in the partition the JAX
    kernel gives it, in its input order, whatever the key count."""
    from blaze_tpu_torch.batch import RecordBatch, slice_rows
    from blaze_tpu_torch.exprs.ir import col
    from blaze_tpu_torch.ops import MemoryScanExec
    from blaze_tpu_torch.parallel.exchange import NativeShuffleExchangeExec
    from blaze_tpu_torch.parallel.shuffle import HashPartitioning
    from blaze_tpu_torch.runtime.context import TaskContext
    from blaze_tpu_torch.schema import Field, Schema

    n, n_out = 1500, 5
    cols = _chain_columns(9, n, seed=99)
    want = _jax_pids([j for j, _ in cols], n_out)
    row_id = column_from_numpy(DataType.int64(), np.arange(n, dtype=np.int64), None, capacity=n, device="cpu")
    names = [f"k{i}" for i in range(9)]
    schema = Schema([Field(m, t.dtype) for m, (_, t) in zip(names, cols)] + [Field("row", DataType.int64())])
    batch = RecordBatch(schema, [t for _, t in cols] + [row_id], n)
    split = [[slice_rows(batch, 0, 700)], [slice_rows(batch, 700, n - 700)]]  # two map tasks
    exchange = NativeShuffleExchangeExec(
        MemoryScanExec(split, schema, device="cpu"),
        HashPartitioning([col(m) for m in names], n_out))
    seen = []
    for p in range(n_out):
        for b in exchange.execute(p, TaskContext(p, n_out)):
            rows = b.columns[-1].data[: b.num_rows].numpy()
            assert (want[rows] == p).all()
            assert (np.diff(rows) > 0).all()
            seen.append(rows)
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)), np.arange(n))


def test_hash_pids_takes_murmur3_pids_whatever_the_environment(monkeypatch):
    """Fixed-width exchange keys go through murmur3_pids by dtype alone:
    the retired spark.blaze.tpu.pallas.enable knob's variable, set to 0,
    changes nothing.  String keys take the plain murmur3 path."""
    from blaze_tpu_torch import conf
    from blaze_tpu_torch.batch import column_from_strings
    from blaze_tpu_torch.exprs.ir import col
    from blaze_tpu_torch.parallel.shuffle import hash_pids
    from blaze_tpu_torch.schema import Field, Schema

    monkeypatch.setenv("BLAZE_TPU_PALLAS_ENABLE", "0")
    assert not hasattr(conf, "PALLAS_ENABLE")
    calls = []
    real = cuda_ops.murmur3_pids
    monkeypatch.setattr(cuda_ops, "murmur3_pids", lambda *a: calls.append(1) or real(*a))
    n, n_out = 1100, 8
    rng = np.random.default_rng(3)
    cols = [_both_columns(*_GENS[kind][:2], _GENS[kind][2](rng, n), rng.random(n) > 0.1)
            for kind in ("int64", "date32", "int32")]
    schema = Schema([Field(f"k{i}", t.dtype) for i, (_, t) in enumerate(cols)])
    pids = hash_pids(schema, [col("k0"), col("k1"), col("k2")], [t for _, t in cols], n, n_out)
    assert calls == [1]
    np.testing.assert_array_equal(pids.numpy(), _jax_pids([j for j, _ in cols], n_out))
    strings = column_from_strings([f"s{i % 37}" for i in range(n)], device="cpu")
    hash_pids(Schema([Field("s", strings.dtype)]), [col("s")], [strings], n, n_out)
    assert calls == [1]


def test_column_word_planes_refuses_strings():
    from blaze_tpu_torch.batch import column_from_strings

    with pytest.raises(NotImplementedError):
        cuda_ops.column_word_planes(column_from_strings(["a", "bc"], device="cpu"))


def _lookup_inputs(seed, t_n, p_n):
    rng = np.random.default_rng(seed)
    # keys on both sides of 2^63, duplicates, and all-ones sentinels
    # (null-key rows) at the end of the unsigned order
    body = rng.integers(0, 2**64 - 1, t_n - 8, dtype=np.uint64)
    table = np.sort(np.concatenate([body, body[:5], np.full(3, 2**64 - 1, np.uint64)]))
    assert table.shape[0] == t_n and np.unique(table).shape[0] < t_n - 6
    probes = np.concatenate([
        rng.choice(table, p_n // 2),
        rng.integers(0, 2**64 - 1, p_n - p_n // 2, dtype=np.uint64),
        np.asarray([0, 2**63 - 1, 2**63, 2**64 - 2, 2**64 - 1], dtype=np.uint64),
        table[:1], table[-1:],
    ])
    return table, probes


def _check_lookup(table, probes):
    """The port's lookup equals np.searchsorted (left, right) and the
    JAX kernel in interpret mode."""
    lo, hi = cuda_ops.sorted_lookup(torch.from_numpy(table.view(np.int64)),
                                    torch.from_numpy(probes.view(np.int64)))
    np.testing.assert_array_equal(lo.numpy(), np.searchsorted(table, probes, side="left"))
    np.testing.assert_array_equal(hi.numpy(), np.searchsorted(table, probes, side="right"))
    jlo, jhi = pallas_ops.sorted_lookup(jnp.asarray(table), jnp.asarray(probes))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    # the TPU kernel pads its table with sentinels, which count in the
    # upper bound of a sentinel probe only (callers zero those counts)
    real = probes != np.uint64(2**64 - 1)
    np.testing.assert_array_equal(hi.numpy()[real], np.asarray(jhi)[real])


# T just below and above powers of two: where a power-of-two sample
# stride leaves a ragged last segment
@pytest.mark.parametrize("t_n,p_n", [(17, 100), (1024, 3000), (1500, 257), (1023, 500), (1025, 500),
                                     (2047, 300)])
def test_sorted_lookup_matches_jax_and_searchsorted(t_n, p_n):
    _check_lookup(*_lookup_inputs(t_n, t_n, p_n))


def _edge_table(kind, rng):
    sentinel = np.uint64(2**64 - 1)
    if kind == "one key":
        return rng.integers(0, 2**64 - 1, 1, dtype=np.uint64)
    if kind == "run of 100":
        keys = rng.integers(0, 2**64 - 1, 900, dtype=np.uint64)
        return np.sort(np.concatenate([keys, np.full(100, keys[450], np.uint64)]))
    if kind == "all one value":
        return np.full(700, rng.integers(0, 2**64 - 1, dtype=np.uint64), np.uint64)
    if kind == "all sentinel":
        return np.full(512, sentinel, np.uint64)
    assert kind == "mostly sentinel"
    return np.sort(np.concatenate([rng.integers(0, 2**64 - 1, 40, dtype=np.uint64), np.full(600, sentinel)]))


@pytest.mark.parametrize("kind", ["one key", "run of 100", "all one value", "all sentinel", "mostly sentinel"])
def test_sorted_lookup_edge_tables(kind):
    """Tables whose answers hang on runs of equal keys (a run longer
    than any segment of the kernel's sampled search) or on the sentinel,
    probed at their first key, last key, the sentinel, each key's
    neighbours and random keys."""
    rng = np.random.default_rng(len(kind))
    table = _edge_table(kind, rng)
    keys = np.unique(table)
    probes = np.concatenate([
        table[:1], table[-1:], np.asarray([0, 2**64 - 2, 2**64 - 1], np.uint64),
        keys[keys > 0] - np.uint64(1), keys[keys < np.uint64(2**64 - 1)] + np.uint64(1),
        rng.choice(table, 50), rng.integers(0, 2**64 - 1, 50, dtype=np.uint64),
    ])
    _check_lookup(table, probes)


@pytest.mark.parametrize("t", [0, 1, 30000, 2**20, 2**31 - 1])
def test_sorted_lookup_geometry_fits_its_budget(t):
    """The sample stride S is a power of two, the least whose
    ceil(t / S) keys fit the shared-memory budget."""
    log2_stride, keys = cuda_ops.sorted_lookup_geometry(t)
    stride = 1 << log2_stride
    assert keys == -(-t // stride) and 8 * keys <= cuda_ops.SAMPLE_BYTES
    assert stride == 1 or -(-t // (stride // 2)) * 8 > cuda_ops.SAMPLE_BYTES


def test_sorted_lookup_empty_table():
    lo, hi = cuda_ops.sorted_lookup(torch.zeros(0, dtype=torch.int64),
                                    torch.tensor([0, -1, 5], dtype=torch.int64))
    assert lo.tolist() == [0, 0, 0] and hi.tolist() == [0, 0, 0]


def test_cpu_tensors_never_count_a_launch():
    cuda_ops.reset_launch_counts()
    _, tcol = _both_columns(DataType.int64(), JT.int64(), np.arange(50, dtype=np.int64), None)
    _port_pids([tcol], 4)
    table, probes = _lookup_inputs(3, 64, 64)
    cuda_ops.sorted_lookup(torch.from_numpy(table.view(np.int64)), torch.from_numpy(probes.view(np.int64)))
    cuda_ops.pid_histogram(torch.zeros(10, dtype=torch.int32), 4)
    cuda_ops.fused_group_sums(torch.zeros(10, dtype=torch.int32), [torch.ones(10)], 2)
    assert cuda_ops.LAUNCHES == {"murmur3_pids": 0, "sorted_lookup": 0, "pid_histogram": 0,
                                 "fused_group_sums": 0}


def test_wrappers_check_their_inputs():
    ok = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        cuda_ops.sorted_lookup(ok.to(torch.int32), ok)
    with pytest.raises(ValueError):
        cuda_ops.murmur3_pids([ok], [1], [torch.ones(4, dtype=torch.bool)], 4)  # width 1 wants int32
    with pytest.raises(ValueError):
        cuda_ops.murmur3_pids([ok], [2], [torch.ones(3, dtype=torch.bool)], 4)
    with pytest.raises(ValueError):
        cuda_ops.murmur3_pids([ok], [2], [torch.ones(4, dtype=torch.bool)], 0)
    with pytest.raises(ValueError):
        cuda_ops.pid_histogram(ok, 4)  # int32 pids
    with pytest.raises(ValueError):
        cuda_ops.pid_histogram(ok.to(torch.int32), 0)
    with pytest.raises(ValueError):
        cuda_ops.fused_group_sums(ok.to(torch.int32), [ok.to(torch.float64)], 2)
    with pytest.raises(ValueError):
        cuda_ops.fused_group_sums(ok.to(torch.int32), [torch.ones(3)], 2)
    with pytest.raises(ValueError):
        cuda_ops.fused_group_sums(ok.to(torch.int32), [], 2)


# ----------------------------------------------------------- pid histogram


def _hist_pids(layout, n, n_parts, rng):
    """(n,) int32 pids of a layout: "random" (10% -1 rows), "hot" (90%
    in one partition, the rest spread, some -1 and some at or past
    n_parts), or "view<k>" (random, then the view that starts k
    elements into its buffer, as a slice's pids do)."""
    if layout == "hot":
        pids = np.where(rng.random(n) < 0.9, n_parts - 1, rng.integers(-1, n_parts + 3, n)).astype(np.int32)
        return torch.from_numpy(pids)
    k = int(layout[4:]) if layout.startswith("view") else 0
    pids = rng.integers(0, n_parts, n + k).astype(np.int32)
    pids[rng.random(n + k) < 0.1] = -1
    return torch.from_numpy(pids)[k:]


@pytest.mark.parametrize("n_parts, n, layout", [
    *[pytest.param(p, 3000, "random", id=str(p)) for p in (1, 8, 37, 200)],
    (32, 3000, "random"), (33, 3000, "random"),
    *[(p, 3003, "random") for p in (1, 8, 32, 33, 37, 200)],
    (8, 3001, "hot"), (200, 3001, "hot"),
    (8, 3002, "view1"), (33, 3001, "view3"),
])
def test_pid_histogram_matches_jax_and_bincount(n_parts, n, layout):
    """Pids with -1 rows (padding) sprinkled in, N not a multiple of
    the TPU kernel's tile (nor, for 3001-3003, of the CUDA kernel's
    four-row loads), bins about the register path's 32, one hot
    partition, and views that start off a 16-byte boundary."""
    rng = np.random.default_rng(n_parts * 10 + n)
    pids = _hist_pids(layout, n, n_parts, rng)
    got = cuda_ops.pid_histogram(pids, n_parts)
    assert got.dtype == torch.int32
    p = pids.numpy()
    want = np.bincount(p[(p >= 0) & (p < n_parts)], minlength=n_parts)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas_ops.pid_histogram(jnp.asarray(p), n_parts)))
    np.testing.assert_array_equal(cuda_ops.pid_histogram_plain(pids, n_parts).numpy(), want)


def _cu_constants(name):
    """The ``constexpr int`` constants of a kernel source."""
    text = (Path(cuda_ops.__file__).parent.parent / "csrc" / name).read_text()
    return {m[1]: eval(m[2]) for m in re.finditer(r"constexpr int (k\w+) = ([\d *]+);", text)}


def test_pid_histogram_constants_match_the_kernel():
    k = _cu_constants("pid_histogram.cu")
    assert (k["kThreads"], k["kLoads"], k["kRegisterBins"], k["kSharedBins"]) == (
        cuda_ops.HIST_THREADS, cuda_ops.HIST_LOADS, cuda_ops.HIST_REGISTER_BINS, cuda_ops.HIST_SHARED_BINS)
    # the shared bins fit what a block of the H100 may opt in to
    assert 4 * cuda_ops.HIST_SHARED_BINS + 1024 <= 232448


@pytest.mark.parametrize("n, n_parts, path", [
    (1, 8, "registers"), (cuda_ops.HIST_SMALL_N, 8, "registers"), (cuda_ops.HIST_SMALL_N + 1, 8, "registers"),
    (2**20, 8, "registers"), (2**20 + 3, 32, "registers"), (2**20, 33, "shared"), (2**20, 200, "shared"),
    (cuda_ops.HIST_SMALL_N - 1, 200, "shared"), (2**20, cuda_ops.HIST_SHARED_BINS, "shared"),
    (2**20, cuda_ops.HIST_SHARED_BINS + 1, "global"), (2**31 - 1, 8, "registers"),
])
def test_pid_histogram_geometry_fits_its_budget(n, n_parts, path):
    """Paths switch at 32 and at the shared-memory cap; at or under the
    small-N threshold one block and no tickets; past it a grid of at
    most SMs x resident blocks, no more than the rows need, whose
    arrivals fit a ticket's 24 high bits, and a ticket a bin (none on
    the global path)."""
    sms = 132
    got_path, blocks, tickets = cuda_ops.pid_histogram_geometry(n, n_parts, sms)
    assert got_path == path
    if n <= cuda_ops.HIST_SMALL_N:
        assert (blocks, tickets) == (1, 0)
        return
    rows_per_block = cuda_ops.HIST_THREADS * 4 * cuda_ops.HIST_LOADS
    assert 2 <= blocks <= min(-(-n // rows_per_block), sms * 2048 // cuda_ops.HIST_THREADS)
    if path == "shared":  # one block an SM: each block adds n_parts tickets
        assert blocks <= sms
    assert blocks < 2**24 and n < 2**40  # arrivals and counts fit the ticket's fields
    assert tickets == (0 if path == "global" else n_parts)


def test_pid_histogram_empty_and_out_of_range():
    """No rows gives zeros (the JAX kernel refuses an empty input, so
    this case is held to np.bincount alone); pids at or past n_parts
    are not counted either."""
    got = cuda_ops.pid_histogram(torch.zeros(0, dtype=torch.int32), 5)
    np.testing.assert_array_equal(got.numpy(), np.zeros(5, np.int32))
    pids = torch.tensor([0, 4, 5, 9, -1, -7, 4], dtype=torch.int32)
    assert cuda_ops.pid_histogram(pids, 5).tolist() == [1, 0, 0, 0, 2]


def test_sort_by_pid_counts_match_reference():
    """The exchange's per-batch counts equal the reference's
    ``_sort_by_pid_body`` counts, and rows come out in pid order."""
    from blaze_tpu.parallel.shuffle import _sort_by_pid_body
    from blaze_tpu_torch.batch import RecordBatch
    from blaze_tpu_torch.parallel.shuffle import sort_by_pid
    from blaze_tpu_torch.schema import Field, Schema

    rng = np.random.default_rng(11)
    n, n_out = 1500, 8
    pids = rng.integers(0, n_out, n).astype(np.int32)
    rows = np.arange(n, dtype=np.int64)
    tcol = column_from_numpy(DataType.int64(), rows, None, capacity=2048, device="cpu")
    batch = RecordBatch(Schema([Field("row", DataType.int64())]), [tcol], n)
    out, counts = sort_by_pid(batch, torch.from_numpy(pids), n_out)
    jcol = jax_column(JT.int64(), rows, None, capacity=2048).to_device()
    jpids = jnp.asarray(np.concatenate([pids, np.zeros(2048 - n, np.int32)]))
    _, jcounts, _ = _sort_by_pid_body((jcol,), jpids, n_out, n)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    got_rows = out.columns[0].data[:n].numpy()
    np.testing.assert_array_equal(pids[got_rows], np.sort(pids, kind="stable"))


# -------------------------------------------------------- fused group sums


def _group_sums_inputs(seed, n, k, g, all_filtered=False):
    rng = np.random.default_rng(seed)
    gids = np.full(n, -1, np.int32) if all_filtered else rng.integers(-1, g, n).astype(np.int32)
    vals = [(rng.random(n) * 100 - 20).astype(np.float32) for _ in range(k)]
    want = np.zeros((k, g), np.float64)
    for j in range(g):
        m = gids == j
        for i in range(k):
            want[i, j] = vals[i][m].sum(dtype=np.float64)
    return gids, vals, want


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("g", [1, 6, 40])
def test_fused_group_sums_matches_jax_and_float64(k, g):
    """float32 sums (gid -1 rows filtered out) within the reference
    test's rtol 2e-5 of float64 sums and of the JAX kernel."""
    gids, vals, want = _group_sums_inputs(k * 100 + g, 1500, k, g)
    got = cuda_ops.fused_group_sums(torch.from_numpy(gids), [torch.from_numpy(v) for v in vals], g)
    assert got.dtype == torch.float32 and got.shape == (k, g)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)
    jgot = np.asarray(pallas_ops.fused_group_sums(jnp.asarray(gids), [jnp.asarray(v) for v in vals], g))
    np.testing.assert_allclose(got.numpy(), jgot, rtol=2e-5)


def test_fused_group_sums_all_filtered_and_counts():
    """All gids -1 sums to zeros; a ones column counts rows exactly."""
    gids, vals, _ = _group_sums_inputs(5, 700, 2, 6, all_filtered=True)
    got = cuda_ops.fused_group_sums(torch.from_numpy(gids), [torch.from_numpy(v) for v in vals], 6)
    np.testing.assert_array_equal(got.numpy(), np.zeros((2, 6), np.float32))
    rng = np.random.default_rng(6)
    gids = rng.integers(-1, 6, 5000).astype(np.int32)
    ones = torch.ones(5000, dtype=torch.float32)
    got = cuda_ops.fused_group_sums(torch.from_numpy(gids), [ones], 6)
    np.testing.assert_array_equal(got.numpy()[0], np.bincount(gids[gids >= 0], minlength=6))
    jgot = np.asarray(pallas_ops.fused_group_sums(jnp.asarray(gids), [jnp.asarray(ones.numpy())], 6))
    np.testing.assert_array_equal(got.numpy(), jgot)


def test_kernels_package_exports_all_four():
    import blaze_tpu_torch.kernels as K

    for name in ("murmur3_pids", "pid_histogram", "fused_group_sums", "sorted_lookup"):
        assert getattr(K, name) is getattr(cuda_ops, name)
        assert getattr(K, name + "_plain") is getattr(cuda_ops, name + "_plain")
        assert name in K.__all__ and name in cuda_ops.LAUNCHES
