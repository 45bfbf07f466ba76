"""The bloom-filter runtime join filter: ``exprs/bloom.py``,
``BloomFilterAggExec``, ``might_contain`` and TPC-H q03 with the filter
Spark 3.5's InjectRuntimeFilter plants, against the JAX package.

- a filter's serialized bytes equal the reference's (Spark's stream
  format), and the device probe equals the host probe and the
  reference's probe, for long and string keys, nulls false;
- the two-stage aggregate's payload equals the reference's, and its
  TaskDefinition equals the reference's byte for byte;
- ``might_contain`` in a projection equals the reference's;
- ``q3_runtime_filter`` at SF 0.002 equals q03's oracle in process and
  through ``run_stages``, with no false negative, and its optimized
  node sequence is that of the reference's q03 with the same filter.
"""

import os

import numpy as np
import pytest
import torch

from blaze_tpu.batch import batch_from_pydict as jax_from_pydict, batch_to_pydict as jax_to_pydict
from blaze_tpu.batch import column_from_numpy as jax_column_from_numpy, column_from_strings as jax_strings
from blaze_tpu.exprs import col as jcol, lit as jlit
from blaze_tpu.exprs.bloom import SparkBloomFilter as JBloom
from blaze_tpu.exprs.ir import func as jfunc
from blaze_tpu.ops import AggMode as JMode, FilterExec as JFilter, MemoryScanExec as JaxScan
from blaze_tpu.ops import ProjectExec as JProject
from blaze_tpu.ops.bloom_agg import BloomFilterAggExec as JBloomAgg
from blaze_tpu.ops.fusion import optimize_plan as jax_optimize
from blaze_tpu.parallel import NativeShuffleExchangeExec as JExchange, SinglePartitioning as JSingle
from blaze_tpu.runtime.context import RESOURCES as JAX_RESOURCES, TaskContext as JaxContext
from blaze_tpu.schema import DataType as JT, Field as JF, Schema as JSchema
from blaze_tpu.serde import to_proto as jax_to_proto
from blaze_tpu.tpch import TPCH_SCHEMAS as JAX_SCHEMAS
from blaze_tpu.tpch import queries as JQ
from blaze_tpu.tpch.datagen import table_to_batches as jax_table_to_batches

import blaze_tpu_torch
from blaze_tpu_torch.batch import (
    batch_from_pydict, batch_to_pydict, column_from_numpy, column_from_strings, table_to_batches,
)
from blaze_tpu_torch.exprs import col, func, lit
from blaze_tpu_torch.exprs.bloom import SparkBloomFilter
from blaze_tpu_torch.ops import AggMode, BloomFilterAggExec, MemoryScanExec, ProjectExec
from blaze_tpu_torch.ops.fusion import optimize_plan
from blaze_tpu_torch.parallel.exchange import NativeShuffleExchangeExec
from blaze_tpu_torch.parallel.shuffle import SinglePartitioning
from blaze_tpu_torch.runtime import scheduler as S
from blaze_tpu_torch.runtime.context import RESOURCES, TaskContext
from blaze_tpu_torch.schema import DataType as TT, Field as TF, Schema as TSchema
from blaze_tpu_torch.serde import to_proto
from blaze_tpu_torch.tpch import TPCH_SCHEMAS
from blaze_tpu_torch.tpch import oracle as O
from blaze_tpu_torch.tpch import queries as Q
from blaze_tpu_torch.tpch.datagen import generate_all

from test_torch_fusion import node_classes
from test_torch_serde import _scan_ids_normalized

SCALE = 0.002
N_PARTS = 2
# the runtime filter's expected items in these tests: a 18 KB filter
# (the smoke runs the reference's default, 1,000,000: 0.9 MB)
ITEMS = 20_000


@pytest.fixture(autouse=True)
def on_cpu():
    prev = blaze_tpu_torch._default_device
    blaze_tpu_torch.set_default_device("cpu")
    yield
    blaze_tpu_torch.set_default_device(prev)


def _values(n=3000, seed=3):
    rng = np.random.RandomState(seed)
    v = rng.randint(-(2**62), 2**62, n, dtype=np.int64)
    v[:5] = [0, -1, 2**63 - 1, -(2**63), 1]
    return v


def _filters():
    t, j = SparkBloomFilter.create(1000), JBloom.create(1000)
    t.put_longs(_values()[:1000])
    j.put_longs(_values()[:1000])
    return t, j


def test_filter_bytes_equal_the_reference():
    t, j = _filters()
    assert (t.num_bits, t.num_hashes) == (j.num_bits, j.num_hashes)
    assert t.serialize() == j.serialize()
    back = SparkBloomFilter.deserialize(t.serialize())
    assert np.array_equal(back.words, t.words) and back.num_hashes == t.num_hashes


def test_long_probe_equals_the_host_probe_and_the_reference():
    t, j = _filters()
    v = _values(4000, seed=4)
    v[:1000] = _values()[:1000]  # members: no false negative
    valid = np.arange(len(v)) % 11 != 0
    tc = column_from_numpy(TT.int64(), v, valid, device="cpu")
    jc = jax_column_from_numpy(JT.int64(), v, valid).to_device()
    got = t.might_contain_device(tc)[: len(v)].numpy()
    assert np.array_equal(got, t.might_contain_longs(v) & valid)
    assert np.array_equal(got, np.asarray(j.might_contain_device(jc))[: len(v)])
    assert got[:1000][valid[:1000]].all()
    assert 0 < got[1000:].sum() < 0.1 * (len(v) - 1000)  # false positives near fpp 0.03


def test_string_probe_equals_the_reference():
    t, j = _filters()
    words = [None if i % 7 == 0 else f"k{i * 37}é" for i in range(500)]
    got = t.might_contain_device(column_from_strings(words, width=16, device="cpu"))[:500].numpy()
    want = np.asarray(j.might_contain_device(jax_strings(words, width=16).to_device()))[:500]
    assert np.array_equal(got, want) and not got[::7].any()


SCHEMA = TSchema([TF("k", TT.int64())])
JSCHEMA = JSchema([JF("k", JT.int64())])


def _parts():
    v = _values(6000, seed=9)
    return [[{"k": [int(x) for x in v[p * 2000 + b * 1000: p * 2000 + b * 1000 + 1000]]} for b in range(2)]
            for p in range(3)]


def _bloom_plans(expr_t=None, expr_j=None):
    parts = _parts()
    tscan = MemoryScanExec([[batch_from_pydict(b, SCHEMA, device="cpu") for b in p] for p in parts], SCHEMA,
                           device="cpu")
    jscan = JaxScan([[jax_from_pydict(b, JSCHEMA) for b in p] for p in parts], JSCHEMA)
    tp = BloomFilterAggExec(tscan, expr_t or func("xxhash64", col("k")), "bloom", AggMode.PARTIAL, 5000)
    jp = JBloomAgg(jscan, expr_j or jfunc("xxhash64", jcol("k")), "bloom", JMode.PARTIAL, 5000)
    return (BloomFilterAggExec(NativeShuffleExchangeExec(tp, SinglePartitioning()), None, "bloom",
                               AggMode.FINAL, 5000),
            JBloomAgg(JExchange(jp, JSingle()), None, "bloom", JMode.FINAL, 5000))


def _payload(plan, ctx, to_pydict):
    return [v for b in plan.execute(0, ctx(0, 1)) for v in to_pydict(b)["bloom"]]


def test_bloom_agg_payload_equals_the_reference():
    t, j = _bloom_plans()
    got = _payload(t, TaskContext, batch_to_pydict)
    assert got == _payload(j, JaxContext, jax_to_pydict) and len(got) == 1
    assert t.schema.fields[0].dtype.string_width == j.schema.fields[0].dtype.string_width
    filt = SparkBloomFilter.deserialize(got[0])
    hashes = batch_to_pydict(ProjectExec(MemoryScanExec(
        [[batch_from_pydict(b, SCHEMA, device="cpu") for b in p] for p in _parts()], SCHEMA, device="cpu"),
        [func("xxhash64", col("k"))], ["h"]).execute(0, TaskContext(0, 3)).__next__())["h"]
    assert filt.might_contain_longs(np.array(hashes, np.int64)).all()


def test_bloom_agg_task_definition_equals_the_reference():
    t, j = _bloom_plans()
    before = set(JAX_RESOURCES._map)
    jraw = jax_to_proto.task_definition(j.children[0].children[0], "t", 0, 1)
    for key in set(JAX_RESOURCES._map) - before:
        JAX_RESOURCES.discard(key)
    traw = to_proto.task_definition(t.children[0].children[0], "t", 0, 1)
    assert _scan_ids_normalized(traw) == _scan_ids_normalized(jraw)
    for key in list(RESOURCES._map):
        RESOURCES.discard(key)


def test_might_contain_in_a_projection_equals_the_reference():
    t, j = _bloom_plans()
    payload = _payload(t, TaskContext, batch_to_pydict)[0]
    v = _values(3000, seed=10)
    v[::3] = _values(6000, seed=9)[: len(v[::3])]
    rows = {"k": [None if i % 13 == 0 else int(x) for i, x in enumerate(v)]}
    bt = TT.binary(1 << (len(payload) - 1).bit_length())
    bj = JT.binary(bt.string_width)
    tp = ProjectExec(MemoryScanExec([[batch_from_pydict(rows, SCHEMA, device="cpu")]], SCHEMA, device="cpu"),
                     [func("might_contain", lit(payload, bt), func("xxhash64", col("k")))], ["hit"])
    jp = JProject(JaxScan([[jax_from_pydict(rows, JSCHEMA)]], JSCHEMA),
                  [jfunc("might_contain", jlit(payload, bj), jfunc("xxhash64", jcol("k")))], ["hit"])
    got = batch_to_pydict(next(tp.execute(0, TaskContext(0, 1))))["hit"]
    assert got == jax_to_pydict(next(jp.execute(0, JaxContext(0, 1))))["hit"]
    assert all(got[i] for i in range(0, len(v), 3) if i % 13)


# ------------------------------------------------------ q03, runtime filter


@pytest.fixture(scope="module")
def data():
    return generate_all(SCALE)


def _scans(data):
    return {name: MemoryScanExec(table_to_batches(data[name], TPCH_SCHEMAS[name], N_PARTS, 4096, "cpu"),
                                 TPCH_SCHEMAS[name], device="cpu") for name in TPCH_SCHEMAS}


def _rows(batches):
    out = {}
    for b in batches:
        for k, v in batch_to_pydict(b).items():
            out.setdefault(k, []).extend(v)
    return out


def _check_q3(rows, data):
    exp = O.oracle_q3(data)
    assert {(k, r) for k, r in zip(rows["l_orderkey"], rows["revenue"])} == {(r[0], r[1]) for r in exp}
    assert len(rows["l_orderkey"]) == 10


def test_q3_runtime_filter_equals_the_q3_oracle_on_both_paths(data):
    plan = optimize_plan(Q.q3_runtime_filter(_scans(data), N_PARTS, ITEMS))
    n = plan.num_partitions()
    _check_q3(_rows(b for p in range(n) for b in plan.execute(p, TaskContext(p, n))), data)
    stages, manager = S.split_stages(Q.q3_runtime_filter(_scans(data), N_PARTS, ITEMS))
    _check_q3(_rows(S.run_stages(stages, manager)), data)
    assert len(RESOURCES) == 0 and not os.path.exists(manager.root)


def test_q3_runtime_filter_has_no_false_negative_and_filters_lineitem(data):
    payload = Q.q3_bloom_payload(_scans(data), N_PARTS, ITEMS)
    filt = SparkBloomFilter.deserialize(payload)
    keys = set()
    scans = _scans(data)
    co = ProjectExec(Q._q3_customer_orders(scans), [col("o_orderkey")], ["k"])
    for p in range(co.num_partitions()):
        for b in co.execute(p, TaskContext(p, co.num_partitions())):
            keys.update(batch_to_pydict(b)["k"])
    lk = data["lineitem"]["l_orderkey"][0]
    hit = torch.from_numpy(np.isin(lk, list(keys)))
    probe = func("xxhash64", col("l_orderkey"))
    hashed = batch_to_pydict(ProjectExec(MemoryScanExec(
        table_to_batches({"l_orderkey": data["lineitem"]["l_orderkey"]},
                         TSchema([TF("l_orderkey", TT.int64())]), 1, len(lk), "cpu"),
        TSchema([TF("l_orderkey", TT.int64())]), device="cpu"), [probe], ["h"]).execute(0, TaskContext(0, 1))
        .__next__())["h"]
    passed = filt.might_contain_longs(np.array(hashed, np.int64))
    assert passed[hit.numpy()].all()
    assert passed.sum() < 0.5 * len(lk)


def test_q3_runtime_filter_keeps_the_reference_node_sequence(data):
    payload = Q.q3_bloom_payload(_scans(data), N_PARTS, ITEMS)
    jt = {name: JaxScan(jax_table_to_batches({k: v for k, v in data[name].items()}, JAX_SCHEMAS[name], N_PARTS,
                                             batch_rows=4096), JAX_SCHEMAS[name]) for name in JAX_SCHEMAS}
    bj = JT.binary(1 << (len(payload) - 1).bit_length())
    jt["lineitem"] = JFilter(jt["lineitem"], jfunc("might_contain", jlit(payload, bj),
                                                   jfunc("xxhash64", jcol("l_orderkey"))))
    assert node_classes(optimize_plan(Q.q3_runtime_filter(_scans(data), N_PARTS, ITEMS))) == \
        node_classes(jax_optimize(JQ.q3(jt, N_PARTS)))
