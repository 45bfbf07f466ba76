"""Real null foreign keys through the port (``tpcds.datagen.with_null_fks``:
the generator's -1 stand-ins exposed as nulls, the same draws).

(a) The reference's own end-to-end checks (``tests/test_tpcds.py``
``test_null_foreign_keys_end_to_end``), run on both packages through
``split_stages``/``run_stages`` and held to numpy: an ``IS NULL``
count; a group by the nullable key with exactly one null group (its
hash exchange hashes null keys to the seed); an INNER join that drops
the null keys (its probe keeps them from the lookup); a LEFT join that
null-extends them.

(b) TPC-DS q10 and q80 over null keys: ``test_torch_tpcds_union_channels.py``.
"""

import shutil

import numpy as np
import pytest

from blaze_tpu.batch import batch_to_pydict as jax_to_pydict
from blaze_tpu.exprs import col as jcol
from blaze_tpu.ops import AggFunction as JAgg, FilterExec as JFilter, GroupingExpr as JGroup
from blaze_tpu.ops import MemoryScanExec as JaxScan
from blaze_tpu.ops.joins.core import JoinType as JJoinType
from blaze_tpu.runtime import scheduler as JS
from blaze_tpu.tpcds import TPCDS_SCHEMAS as JAX_SCHEMAS
from blaze_tpu.tpch import queries as JQ
from blaze_tpu.tpch.datagen import table_to_batches as jax_table_to_batches

from blaze_tpu_torch.batch import batch_to_pydict, table_to_batches
from blaze_tpu_torch.exprs import col
from blaze_tpu_torch.ops import AggFunction, FilterExec, GroupingExpr, MemoryScanExec
from blaze_tpu_torch.ops.joins import JoinType
from blaze_tpu_torch.runtime import scheduler as S
from blaze_tpu_torch.runtime.context import RESOURCES
from blaze_tpu_torch.tpcds import TPCDS_SCHEMAS
from blaze_tpu_torch.tpcds.datagen import with_null_fks
from blaze_tpu_torch.tpch import queries as Q

from test_torch_tpcds_window_share import N_PARTS, data, on_cpu  # noqa: F401


class _Port:
    scan = staticmethod(lambda t, s, parts, rows: MemoryScanExec(table_to_batches(t, s, parts, rows, device="cpu"),
                                                                 s, device="cpu"))
    schemas, col, Agg, Group, Filter, J, two_stage_agg, broadcast_join = (
        TPCDS_SCHEMAS, col, AggFunction, GroupingExpr, FilterExec, JoinType, Q.two_stage_agg, Q.broadcast_join)

    @staticmethod
    def run_stages(plan):
        stages, manager = S.split_stages(plan)
        try:
            return _rows(S.run_stages(stages, manager), plan, batch_to_pydict)
        finally:
            manager.cleanup()


class _Reference:
    scan = staticmethod(lambda t, s, parts, rows: JaxScan(jax_table_to_batches(t, s, parts, batch_rows=rows), s))
    schemas, col, Agg, Group, Filter, J, two_stage_agg, broadcast_join = (
        JAX_SCHEMAS, jcol, JAgg, JGroup, JFilter, JJoinType, JQ.two_stage_agg, JQ.broadcast_join)

    @staticmethod
    def run_stages(plan):
        stages, manager = JS.split_stages(plan)
        try:
            return _rows(JS.run_stages(stages, manager), plan, jax_to_pydict)
        finally:
            shutil.rmtree(manager.root, ignore_errors=True)


def _rows(batches, plan, to_pydict):
    out = {f.name: [] for f in plan.schema.fields}
    for b in batches:
        for k, v in to_pydict(b).items():
            out[k].extend(v)
    return out


def _check_plan(pkg, check, ss, customer):
    """The plan of one of the four checks in package ``pkg``."""
    c, count = pkg.col, [pkg.Agg("count_star", None, "n")]
    scan = pkg.scan(ss, pkg.schemas["store_sales"], N_PARTS, 4096)
    cust = pkg.scan(customer, pkg.schemas["customer"], 1, 65536)
    if check == "is null":
        return pkg.two_stage_agg(pkg.Filter(scan, c("ss_customer_sk").is_null()), [], count, 1)
    if check == "null group":
        return pkg.two_stage_agg(scan, [pkg.Group(c("ss_customer_sk"), "k")], count, N_PARTS)
    j = pkg.broadcast_join(cust, scan, [c("c_customer_sk")], [c("ss_customer_sk")],
                           pkg.J.INNER if check == "inner join" else pkg.J.LEFT, build_is_left=False)
    if check == "left join":
        j = pkg.Filter(j, c("c_customer_sk").is_null())
    return pkg.two_stage_agg(j, [], count, 1)


def _expected(check, fk, valid, customer_keys):
    if check == "is null":
        return {None: int((~valid).sum())}
    if check == "null group":
        keys, n = np.unique(fk[valid], return_counts=True)
        return {**dict(zip(keys.tolist(), n.tolist())), None: int((~valid).sum())}
    known = valid & np.isin(fk, customer_keys)
    return {None: int(known.sum() if check == "inner join" else (~known).sum())}


CHECKS = ["is null", "null group", "inner join", "left join"]


@pytest.mark.parametrize("package", ["port", "reference"])
@pytest.mark.parametrize("check", CHECKS)
def test_null_foreign_keys_end_to_end(data, check, package):
    ss = with_null_fks(data["store_sales"], ["ss_customer_sk"])
    fk, valid = ss["ss_customer_sk"][0], ss["ss_customer_sk"][2]
    assert valid.any() and not valid.all()
    pkg = _Port if package == "port" else _Reference
    got = pkg.run_stages(_check_plan(pkg, check, ss, data["customer"]))
    keys = got["k"] if check == "null group" else [None] * len(got["n"])
    assert dict(zip(keys, got["n"])) == _expected(check, fk, valid, data["customer"]["c_customer_sk"][0])
    assert len(keys) == len(set(keys))
    assert not len(RESOURCES)


def test_null_keys_hash_to_the_seed(data):
    """The exchange's pids of the nullable key: a null row keeps the
    seed (42), whatever its data word, so every null lands in one
    partition."""
    from blaze_tpu_torch.batch import column_from_numpy
    from blaze_tpu_torch.kernels import cuda_ops
    from blaze_tpu_torch.schema import DataType

    ss = with_null_fks(data["store_sales"], ["ss_customer_sk"])
    fk, valid = ss["ss_customer_sk"][0], ss["ss_customer_sk"][2]
    garbage = np.where(valid, fk, np.arange(fk.shape[0]))  # a null's data word is not read
    for words in (fk, garbage):
        c = column_from_numpy(DataType.int64(), words, valid, capacity=fk.shape[0], device="cpu")
        plane, width = cuda_ops.column_word_planes(c)
        pids = cuda_ops.murmur3_pids([plane], [width], [c.validity], 8).numpy()
        assert set(pids[~valid].tolist()) == {42 % 8}
        assert len(set(pids[valid].tolist())) == 8
