"""OPAQUE columns, the batch wire format's tag 3 and ObjectAggExec with
the HLL and t-digest UDAFs: the port against the JAX package.

- an opaque column's frame is the reference's byte for byte (builtin
  objects pickle alike in both packages) and decodes in the port; the
  decode is refused when ``spark.blaze.udf.allowPickled`` is false;
- PARTIAL -> hash exchange -> FINAL, in process and through the file
  shuffle, equals an exact oracle, and a global aggregate over no rows
  gives one empty state;
- ``approx_count_distinct`` (dense HLL, p=12) and ``approx_percentile``
  (t-digest, 100 centroids) keep the reference's states and results for
  the same partitioning;
- the ``object_agg`` node: the TaskDefinition equals the reference's but
  for ``udafs_payload``, which each package pickles with its own module
  path (so a TaskDefinition written by one package cannot be read by the
  other), and is refused when pickles are not allowed; the optimized
  node sequence is the reference's.
"""

import os
import pickle

import numpy as np
import pytest

from blaze_tpu import conf as jconf
from blaze_tpu.batch import batch_from_pydict as jax_from_pydict, batch_to_pydict as jax_to_pydict
from blaze_tpu.exprs import col as jcol
from blaze_tpu.io import serialize_batch as jax_serialize
from blaze_tpu.ops import AggMode as JMode, GroupingExpr as JGroup, MemoryScanExec as JaxScan
from blaze_tpu.ops import ObjectAggExec as JObjectAgg, Udaf as JUdaf
from blaze_tpu.ops import udafs as JU
from blaze_tpu.ops.fusion import optimize_plan as jax_optimize
from blaze_tpu.parallel import HashPartitioning as JHash, NativeShuffleExchangeExec as JExchange
from blaze_tpu.runtime.context import RESOURCES as JAX_RESOURCES, TaskContext as JaxContext
from blaze_tpu.schema import DataType as JT, Field as JF, Schema as JSchema
from blaze_tpu.serde import to_proto as jax_to_proto

import blaze_tpu_torch
from blaze_tpu_torch import conf
from blaze_tpu_torch.batch import batch_from_pydict, batch_to_pydict
from blaze_tpu_torch.exprs import col
from blaze_tpu_torch.io.batch_serde import deserialize_batch, serialize_batch
from blaze_tpu_torch.ops import AggMode, GroupingExpr, MemoryScanExec, ObjectAggExec, Udaf
from blaze_tpu_torch.ops import udafs as U
from blaze_tpu_torch.ops.fusion import optimize_plan
from blaze_tpu_torch.parallel.exchange import NativeShuffleExchangeExec
from blaze_tpu_torch.parallel.shuffle import HashPartitioning, SinglePartitioning
from blaze_tpu_torch.runtime import scheduler as S
from blaze_tpu_torch.runtime.context import RESOURCES, TaskContext
from blaze_tpu_torch.schema import DataType as TT, Field as TF, Schema as TSchema
from blaze_tpu_torch.serde import from_proto, to_proto, wire

from test_torch_fusion import node_classes
from test_torch_serde import _scan_ids_normalized

SCHEMA = TSchema([TF("k", TT.int64()), TF("v", TT.int64()), TF("x", TT.float64())])
JSCHEMA = JSchema([JF("k", JT.int64()), JF("v", JT.int64()), JF("x", JT.float64())])
N_PARTS = 3


@pytest.fixture(autouse=True)
def on_cpu():
    prev = blaze_tpu_torch._default_device
    blaze_tpu_torch.set_default_device("cpu")
    yield
    blaze_tpu_torch.set_default_device(prev)


def _set_init():
    return set()


def _set_update(s, v):
    return s if v is None else s | {v}


def _set_merge(a, b):
    return a | (b or set())


def _set_finish(s):
    return len(s)


def distinct_set():
    return Udaf("distinct_set", _set_init, _set_update, _set_merge, _set_finish, [col("v")], TT.int64())


@pytest.fixture(scope="module")
def raw():
    """Three partitions of two batches: keys 0-5, values with nulls."""
    rng = np.random.RandomState(5)
    parts = []
    for _ in range(N_PARTS):
        batches = []
        for n in (700, 500):
            batches.append({
                "k": [int(x) for x in rng.randint(0, 6, n)],
                "v": [int(x) if x % 9 else None for x in rng.randint(0, 3000, n)],
                "x": [float(x) for x in rng.gamma(3.0, 100.0, n)],
            })
        parts.append(batches)
    return parts


def scans(raw):
    return (MemoryScanExec([[batch_from_pydict(b, SCHEMA, device="cpu") for b in p] for p in raw], SCHEMA,
                           device="cpu"),
            JaxScan([[jax_from_pydict(b, JSCHEMA) for b in p] for p in raw], JSCHEMA))


def run(plan, ctx=TaskContext):
    n = plan.num_partitions()
    to_pydict = batch_to_pydict if ctx is TaskContext else jax_to_pydict
    out = {}
    for p in range(n):
        for b in plan.execute(p, ctx(p, n)):
            for k, v in to_pydict(b).items():
                out.setdefault(k, []).extend(v)
    return out


def by_key(rows, *cols):
    return {k: tuple(rows[c][i] for c in cols) for i, k in enumerate(rows["k"])}


def two_stage(scan, udafs, parts=2, grouped=True):
    g = [GroupingExpr(col("k"), "k")] if grouped else []
    partial = ObjectAggExec(scan, AggMode.PARTIAL, g, udafs)
    part = HashPartitioning([col("k")], parts) if grouped else SinglePartitioning()
    return ObjectAggExec(NativeShuffleExchangeExec(partial, part), AggMode.FINAL, g, udafs)


def jax_two_stage(scan, udafs, parts=2):
    g = [JGroup(jcol("k"), "k")]
    partial = JObjectAgg(scan, JMode.PARTIAL, g, udafs)
    return JObjectAgg(JExchange(partial, JHash([jcol("k")], parts)), JMode.FINAL, g, udafs)


# ---------------------------------------------------------- wire format


def test_opaque_frames_equal_the_reference_and_round_trip():
    values = [{1, 2}, None, {"x": [3]}, (4, 5), "s", 7]
    t = batch_from_pydict({"s": values, "k": list(range(6))}, TSchema([TF("s", TT.opaque()), TF("k", TT.int64())]))
    j = jax_from_pydict({"s": values, "k": list(range(6))}, JSchema([JF("s", JT.opaque()), JF("k", JT.int64())]))
    raw = serialize_batch(t)
    assert raw == jax_serialize(j)
    back = deserialize_batch(raw, t.schema)
    assert batch_to_pydict(back) == {"s": values, "k": list(range(6))}
    assert back.columns[0].device.type == "cpu" and back.capacity == t.capacity


def test_opaque_decoding_is_gated_by_allow_pickled():
    schema = TSchema([TF("s", TT.opaque())])
    raw = serialize_batch(batch_from_pydict({"s": [{1}]}, schema))
    conf.ALLOW_PICKLED_UDFS.set(False)
    try:
        with pytest.raises(PermissionError):
            deserialize_batch(raw, schema)
    finally:
        conf.ALLOW_PICKLED_UDFS.set(True)
    assert batch_to_pydict(deserialize_batch(raw, schema)) == {"s": [{1}]}


def test_a_nested_frame_still_raises():
    """A nested frame (tag 2) where the schema's field is flat raises,
    as in the reference (an assertion there, a ValueError here)."""
    raw = b"\x01\x00\x00\x00\x02\x01"
    with pytest.raises(ValueError, match="wire tag 2"):
        deserialize_batch(raw, TSchema([TF("a", TT.int64())]))
    from blaze_tpu.io.batch_serde import deserialize_batch as jax_deserialize
    from blaze_tpu.schema import DataType as JT, Field as JF, Schema as JS

    with pytest.raises(AssertionError):
        jax_deserialize(raw, JS([JF("a", JT.int64())]))


# ------------------------------------------------------- object agg


def _oracle(raw):
    out = {}
    for p in raw:
        for b in p:
            for k, v in zip(b["k"], b["v"]):
                s = out.setdefault(k, set())
                if v is not None:
                    s.add(v)
    return {k: (len(s),) for k, s in out.items()}


@pytest.mark.parametrize("in_process", [True, False], ids=["in_process", "file_shuffle"])
def test_two_stage_object_agg_equals_the_oracle(raw, in_process):
    conf.EXCHANGE_IN_PROCESS.set(in_process)
    try:
        rows = run(two_stage(scans(raw)[0], [distinct_set()]))
    finally:
        conf.EXCHANGE_IN_PROCESS.set(True)
    assert by_key(rows, "distinct_set") == _oracle(raw)
    assert len(rows["k"]) == 6


def test_global_object_agg_over_no_rows_is_one_empty_state():
    empty = MemoryScanExec([[]], SCHEMA, device="cpu")
    rows = run(two_stage(empty, [U.approx_count_distinct(col("v"), "n")], grouped=False))
    assert rows == {"n": [0]}


@pytest.fixture(scope="module")
def sketches(raw):
    """Both packages' PARTIAL states and FINAL results of the two
    sketches over the same partitions."""
    t_udafs = [U.approx_count_distinct(col("v"), "ndv"), U.approx_percentile(col("x"), 0.5, "p50"),
               U.approx_percentile(col("x"), 0.9, "p90")]
    j_udafs = [JU.approx_count_distinct(jcol("v"), "ndv"), JU.approx_percentile(jcol("x"), 0.5, "p50"),
               JU.approx_percentile(jcol("x"), 0.9, "p90")]
    tscan, jscan = scans(raw)
    t_states = run(ObjectAggExec(tscan, AggMode.PARTIAL, [GroupingExpr(col("k"), "k")], t_udafs))
    j_states = run(JObjectAgg(jscan, JMode.PARTIAL, [JGroup(jcol("k"), "k")], j_udafs), JaxContext)
    tscan, jscan = scans(raw)
    return (t_states, j_states, run(two_stage(tscan, t_udafs)),
            run(jax_two_stage(jscan, j_udafs), JaxContext))


def test_hll_and_tdigest_states_equal_the_reference(sketches):
    t_states, j_states, _, _ = sketches
    assert t_states["k"] == j_states["k"]
    for a, b in zip(t_states["ndv#state"], j_states["ndv#state"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for name in ("p50#state", "p90#state"):
        for a, b in zip(t_states[name], j_states[name]):
            assert (a.means, a.weights, a.count) == (b.means, b.weights, b.count)


def test_hll_and_tdigest_results_equal_the_reference_and_their_bounds(raw, sketches):
    _, _, t_rows, j_rows = sketches
    assert by_key(t_rows, "ndv", "p50", "p90") == by_key(j_rows, "ndv", "p50", "p90")
    exact = _oracle(raw)
    xs = {}
    for p in raw:
        for b in p:
            for k, x in zip(b["k"], b["x"]):
                xs.setdefault(k, []).append(x)
    for k, (ndv, p50, p90) in by_key(t_rows, "ndv", "p50", "p90").items():
        assert abs(ndv - exact[k][0]) / exact[k][0] < 0.05
        assert abs(p50 - np.percentile(xs[k], 50)) / np.percentile(xs[k], 50) < 0.02
        assert abs(p90 - np.percentile(xs[k], 90)) / np.percentile(xs[k], 90) < 0.02


# ------------------------------------------------------------- serde


def _without_payload(raw: bytes) -> bytes:
    td = wire.TaskDefinition.decode(_scan_ids_normalized(raw))
    node = td.plan
    while not node.has_field("object_agg"):
        node = getattr(node, node.which_oneof("node")).input
    node.object_agg.udafs_payload = b""
    return td.encode()


def test_object_agg_task_definition_equals_the_reference_but_for_the_pickle(raw):
    tscan, jscan = scans(raw)
    t = ObjectAggExec(tscan, AggMode.PARTIAL, [GroupingExpr(col("k"), "k")],
                      [U.approx_count_distinct(col("v"), "ndv")])
    j = JObjectAgg(jscan, JMode.PARTIAL, [JGroup(jcol("k"), "k")], [JU.approx_count_distinct(jcol("v"), "ndv")])
    before = set(JAX_RESOURCES._map)
    jraw = jax_to_proto.task_definition(j, "t", 0, 0)
    for key in set(JAX_RESOURCES._map) - before:
        JAX_RESOURCES.discard(key)
    traw = to_proto.task_definition(t, "t", 0, 0)
    assert _without_payload(traw) == _without_payload(jraw)
    # the pickles name their own packages' modules
    payload = wire.TaskDefinition.decode(traw).plan.object_agg.udafs_payload
    assert b"blaze_tpu_torch.ops.udafs" in payload and b"blaze_tpu_torch.ops.udafs" not in \
        wire.TaskDefinition.decode(jraw).plan.object_agg.udafs_payload
    rows = {}
    for b in from_proto.run_task(traw):
        rows = batch_to_pydict(b)
    assert len(rows["k"]) == 6 and len(RESOURCES) == 0


def test_object_agg_node_is_refused_without_allow_pickled(raw):
    t = ObjectAggExec(scans(raw)[0], AggMode.PARTIAL, [GroupingExpr(col("k"), "k")], [distinct_set()])
    msg = to_proto.plan_to_proto(t)
    conf.ALLOW_PICKLED_UDFS.set(False)
    try:
        with pytest.raises(PermissionError):
            from_proto.plan_from_proto(msg)
    finally:
        conf.ALLOW_PICKLED_UDFS.set(True)
        for key in list(RESOURCES._map):
            RESOURCES.discard(key)


def test_object_agg_through_run_stages_equals_in_process(raw):
    udafs = [distinct_set(), U.approx_count_distinct(col("v"), "ndv")]
    stages, manager = S.split_stages(two_stage(scans(raw)[0], udafs))
    rows = {}
    for b in S.run_stages(stages, manager):
        for k, v in batch_to_pydict(b).items():
            rows.setdefault(k, []).extend(v)
    assert len(RESOURCES) == 0 and not os.path.exists(manager.root)
    assert by_key(rows, "distinct_set", "ndv") == by_key(run(two_stage(scans(raw)[0], udafs)),
                                                         "distinct_set", "ndv")


def test_optimized_object_agg_plans_keep_the_reference_node_sequence(raw):
    tscan, jscan = scans(raw)
    t = optimize_plan(two_stage(tscan, [distinct_set()]))
    j = jax_optimize(jax_two_stage(jscan, [JU.approx_count_distinct(jcol("v"), "distinct_set")]))
    assert node_classes(t) == node_classes(j)


def test_reference_object_agg_scales_a_decimal_key_twice():
    """Reference defect 15 (ROADMAP queue C): the reference's
    ObjectAggExec reads its keys with ``column_to_pylist`` (a decimal
    unscaled) and builds its output with ``batch_from_pydict``, which
    scales a decimal value again.  The port keeps the key: decimal(12,2)
    1.25 comes back 1.25, where the reference's is 125.00."""
    from blaze_tpu.batch import column_from_numpy as jax_column
    from blaze_tpu.batch import RecordBatch as JBatch
    from blaze_tpu_torch.batch import RecordBatch, column_from_numpy

    keys = np.array([125, 125, -7], np.int64)
    tschema = TSchema([TF("k", TT.decimal(12, 2)), TF("v", TT.int64())])
    jschema = JSchema([JF("k", JT.decimal(12, 2)), JF("v", JT.int64())])
    tb = RecordBatch(tschema, [column_from_numpy(TT.decimal(12, 2), keys, device="cpu"),
                               column_from_numpy(TT.int64(), np.arange(3), device="cpu")], 3)
    jb = JBatch(jschema, [jax_column(JT.decimal(12, 2), keys).to_device(),
                          jax_column(JT.int64(), np.arange(3)).to_device()], 3)
    t = ObjectAggExec(MemoryScanExec([[tb]], tschema, device="cpu"), AggMode.PARTIAL,
                      [GroupingExpr(col("k"), "k")], [distinct_set()])
    j = JObjectAgg(JaxScan([[jb]], jschema), JMode.PARTIAL, [JGroup(jcol("k"), "k")],
                   [JUdaf("distinct_set", _set_init, _set_update, _set_merge, _set_finish, [jcol("v")],
                          JT.int64())])
    assert sorted(run(t)["k"]) == [-7, 125]
    assert sorted(run(j, JaxContext)["k"]) == [-700, 12500]
