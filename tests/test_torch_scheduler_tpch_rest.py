"""The rest of TPC-H (q02, q07-q09, q11, q13, q15-q18, q20-q22) through
the port's stage scheduler, and the plan contract's new nodes.

Each query runs through ``split_stages`` / ``run_stages`` with two
partitions: every task from TaskDefinition bytes (each decoded and
re-encoded byte for byte in the port's codec and in the reference's
generated ``plan_pb2``), hash exchanges through ``.data``/``.index``
files.  Each equals its oracle and its in-process rows, and
``RESOURCES`` is empty after it.  The tables come from
``generate_all`` with ``with_spec_columns``, at the smallest scale where
the query selects rows (as in the in-process tests).  The scalar
subqueries of q11, q15 and q22 run in process while the plan is built
and reach the tasks as literals (q15's and q22's decimals unscaled).

The ``cast`` and ``scalar_func`` expression nodes, and every join type,
encode byte for byte as the reference's ``to_proto`` does and decode
back to the same tree.
"""

import os

import numpy as np
import pytest

from blaze_tpu.exprs import col as jcol, lit as jlit
from blaze_tpu.exprs.ir import func as jfunc
from blaze_tpu.serde import plan_pb2
from blaze_tpu.serde import to_proto as jax_to_proto
from blaze_tpu.schema import DataType as JT

import blaze_tpu_torch
import blaze_tpu_torch.batch as TB
from blaze_tpu_torch.exprs import col, func, lit
from blaze_tpu_torch.exprs.compile import lower
from blaze_tpu_torch.ops import MemoryScanExec
from blaze_tpu_torch.ops.joins import BroadcastJoinExec, HashJoinExec, JoinType
from blaze_tpu_torch.runtime import scheduler as S
from blaze_tpu_torch.runtime.context import RESOURCES, TaskContext
from blaze_tpu_torch.schema import DataType as TT, Field as TF, Schema as TSchema
from blaze_tpu_torch.serde import from_proto, to_proto, wire
from blaze_tpu_torch.tpch import TPCH_SCHEMAS, build_query
from blaze_tpu_torch.tpch import oracle as O
from blaze_tpu_torch.tpch.datagen import generate_all, with_spec_columns

N_PARTS = 2
SCALES = {"q2": 0.01, "q7": 0.002, "q8": 0.02, "q9": 0.002, "q11": 0.002, "q13": 0.002, "q15": 0.002,
          "q16": 0.002, "q17": 0.01, "q18": 0.05, "q20": 0.002, "q21": 0.002, "q22": 0.002}
# expression nodes and join types each query's tasks must carry
NODES = {"q2": ("like {",), "q7": ("scalar_func {", "in_list {"), "q8": ("scalar_func {", "cast {", "case {"),
         "q9": ("scalar_func {", "like {"), "q11": ("cast {",), "q13": ("like {", "join_type: LEFT\n"),
         "q15": (), "q16": ("like {", "in_list {", "join_type: LEFT_ANTI"), "q17": ("cast {",), "q18": (),
         "q20": ("cast {", "like {"), "q21": (), "q22": ("scalar_func {", "cast {", "join_type: LEFT_ANTI")}


@pytest.fixture(autouse=True)
def on_cpu():
    prev = blaze_tpu_torch._default_device
    blaze_tpu_torch.set_default_device("cpu")
    yield
    blaze_tpu_torch.set_default_device(prev)


@pytest.fixture(scope="module")
def tables():
    return {sf: with_spec_columns(generate_all(sf), sf) for sf in sorted(set(SCALES.values()))}


def _rows(batches):
    out = {}
    for b in batches:
        for k, v in TB.batch_to_pydict(b).items():
            out.setdefault(k, []).extend(v)
    return out


def run_port(plan_fn, monkeypatch):
    """(rows through run_stages, rows in process, the TaskDefinitions
    run); every TaskDefinition is checked byte for byte on the way."""
    seen = []
    real = from_proto.run_task

    def run_task(td, *a, **kw):
        seen.append(td)
        assert wire.TaskDefinition.decode(td).encode() == td
        assert plan_pb2.TaskDefinition.FromString(td).SerializeToString() == td
        return real(td, *a, **kw)

    monkeypatch.setattr(from_proto, "run_task", run_task)
    stages, manager = S.split_stages(plan_fn())
    rows = _rows(S.run_stages(stages, manager))
    assert len(RESOURCES) == 0 and not os.path.exists(manager.root)
    plan = plan_fn()
    n = plan.num_partitions()
    inproc = _rows([b for p in range(n) for b in plan.execute(p, TaskContext(p, n))])
    return rows, inproc, seen


def check(q, rows, data):
    """``rows`` against the oracle of TPC-H ``q``, on a nonempty result."""
    exp = getattr(O, f"oracle_{q}")(data)
    assert exp
    if q == "q2":
        assert list(zip(rows["s_acctbal"], rows["s_name"], rows["n_name"], rows["p_partkey"], rows["p_mfgr"])) == exp
    elif q == "q7":
        keys = list(zip(rows["supp_nation"], rows["cust_nation"], rows["l_year"]))
        assert dict(zip(keys, rows["revenue"])) == exp and keys == sorted(exp)
    elif q == "q8":
        assert rows["o_year"] == sorted(exp)
        assert all(abs(s - exp[y]) < 1e-9 for y, s in zip(rows["o_year"], rows["mkt_share"]))
    elif q == "q9":
        assert dict(zip(zip(rows["nation"], rows["o_year"]), rows["sum_profit"])) == exp
    elif q == "q11":
        assert dict(zip(rows["ps_partkey"], rows["value"])) == exp
    elif q == "q13":
        assert dict(zip(rows["c_count"], rows["custdist"])) == exp and 0 in exp
    elif q == "q15":
        assert list(zip(rows["s_suppkey"], rows["s_name"], rows["total_revenue"])) == exp
    elif q == "q16":
        assert {(b, t, s): c for b, t, s, c in zip(rows["p_brand"], rows["p_type"], rows["p_size"],
                                                    rows["supplier_cnt"])} == exp
    elif q == "q17":
        assert abs(rows["avg_yearly"][0] - exp) / exp < 1e-9
    elif q == "q18":
        assert list(zip(rows["c_name"], rows["c_custkey"], rows["o_orderkey"], rows["o_orderdate"],
                        rows["o_totalprice"], rows["qsum"])) == exp
    elif q == "q20":
        assert list(zip(rows["s_name"], rows["s_address"])) == exp
    elif q == "q21":
        assert dict(zip(rows["s_name"], rows["numwait"])) == exp
    else:
        assert rows["cntrycode"] == sorted(exp)
        assert {c: [n, t] for c, n, t in zip(rows["cntrycode"], rows["numcust"], rows["totacctbal"])} == exp


@pytest.mark.parametrize("q", list(SCALES))
def test_query_through_run_stages_equals_the_oracle(tables, monkeypatch, q):
    data = tables[SCALES[q]]

    def plan_fn():
        scans = {n: MemoryScanExec(TB.table_to_batches(data[n], TPCH_SCHEMAS[n], N_PARTS, 4096, "cpu"),
                                   TPCH_SCHEMAS[n], device="cpu") for n in TPCH_SCHEMAS}
        return build_query(q, scans, N_PARTS)

    rows, inproc, tds = run_port(plan_fn, monkeypatch)
    assert rows == inproc
    check(q, rows, data)
    text = [str(plan_pb2.TaskDefinition.FromString(td).plan) for td in tds]
    for node in NODES[q]:
        assert any(node in t for t in text), node


# ----------------------------------------------------- the contract's nodes

_EXPRS = [
    (col("d").cast(TT.decimal(10, 0)), jcol("d").cast(JT.decimal(10, 0))),
    (col("m").cast(TT.float64()), jcol("m").cast(JT.float64())),
    (col("m").cast(TT.int32()), jcol("m").cast(JT.int32())),
    ((col("m") * col("d").cast(TT.decimal(10, 0))).cast(TT.float64()) > lit(0.0001),
     (jcol("m") * jcol("d").cast(JT.decimal(10, 0))).cast(JT.float64()) > jlit(0.0001)),
    (func("year", col("t")), jfunc("year", jcol("t"))),
    (func("month", col("t")) + func("day", col("t")), jfunc("month", jcol("t")) + jfunc("day", jcol("t"))),
    (func("substring", col("s"), lit(1), lit(2)), jfunc("substring", jcol("s"), jlit(1), jlit(2))),
    (func("substring", col("s"), lit(-3)).isin("13", "31"), jfunc("substring", jcol("s"), jlit(-3)).isin("13", "31")),
]


@pytest.mark.parametrize("i", range(len(_EXPRS)))
def test_cast_and_scalar_func_round_trip_byte_for_byte(i):
    texpr, jexpr = _EXPRS[i]
    b = to_proto.expr_to_proto(texpr).encode()
    assert b == jax_to_proto.expr_to_proto(jexpr).SerializeToString()
    back = from_proto.expr_from_proto(wire.ExprNode.decode(b))
    assert to_proto.expr_to_proto(back).encode() == b
    assert plan_pb2.ExprNode.FromString(b).SerializeToString() == b
    # the decoded tree lowers to the same column as the built one
    schema = TSchema([TF("d", TT.int32()), TF("m", TT.decimal(12, 2)), TF("t", TT.date32()), TF("s", TT.string(16))])
    rng = np.random.default_rng(90 + i)
    env = {"d": TB.column_from_numpy(TT.int32(), rng.integers(1, 10**4, 64).astype(np.int32), capacity=64,
                                     device="cpu"),
           "m": TB.column_from_numpy(TT.decimal(12, 2), rng.integers(-(10**9), 10**9, 64), rng.random(64) > 0.2,
                                     capacity=64, device="cpu"),
           "t": TB.column_from_numpy(TT.date32(), rng.integers(-9000, 20000, 64).astype(np.int32), capacity=64,
                                     device="cpu"),
           "s": TB.column_from_strings([f"{k}-555-0100" for k in rng.integers(10, 35, 64)], width=16,
                                       capacity=64, device="cpu")}
    want, got = lower(texpr, schema, env, 64), lower(back, schema, env, 64)
    assert TB.column_to_pylist(got, 64) == TB.column_to_pylist(want, 64)


@pytest.mark.parametrize("broadcast", [False, True], ids=["hash_join", "broadcast_join"])
@pytest.mark.parametrize("kind", [t.name for t in JoinType])
def test_every_join_type_round_trips(kind, broadcast):
    schema = TSchema([TF("k", TT.int64()), TF("v", TT.int32())])
    parts = TB.table_to_batches({"k": (np.arange(4), None), "v": (np.arange(4, dtype=np.int32), None)},
                                schema, 1, 4, "cpu")
    build, probe = MemoryScanExec(parts, schema, device="cpu"), MemoryScanExec(parts, schema, device="cpu")
    Exec = BroadcastJoinExec if broadcast else HashJoinExec
    node = Exec(build, probe, [col("k")], [col("k")], JoinType[kind], build_is_left=False)
    staged = []
    token = to_proto.STAGED_RIDS.set(staged)
    try:
        b = to_proto.plan_to_proto(node).encode()
    finally:
        to_proto.STAGED_RIDS.reset(token)
        for rid in staged:
            RESOURCES.discard(rid)
    msg = plan_pb2.PhysicalPlanNode.FromString(b)
    assert msg.SerializeToString() == b
    join = msg.broadcast_join if broadcast else msg.hash_join
    assert plan_pb2.JoinTypeProto.Name(join.join_type) == kind
    assert wire.PhysicalPlanNode.decode(b).encode() == b
