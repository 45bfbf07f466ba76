"""The port's TPC-DS q03 and q07 (BASELINE config 4) against the JAX
package and the numpy oracles.

Both packages generate SF 0.01 from one seed; the port's generator must
give the same arrays for every table.  q03 (two broadcast joins into
``store_sales``, a 3-key group, a top 100) and q07 (four broadcast
joins, decimal and int averages) run in process with two partitions
and equal the reference's rows and the oracles; q07's decimal averages
are held to the oracle within one unit at the HALF_UP boundary and its
int average within 1e-9, as ``tests/test_tpcds.py`` does.  q03 also
runs through the port's ``run_stages`` (see
``tests/test_torch_tpch_joins.py`` for the TPC-H ones).
"""

import numpy as np
import pytest

from blaze_tpu.batch import batch_to_pydict as jax_to_pydict
from blaze_tpu.ops import MemoryScanExec as JaxScan
from blaze_tpu.runtime.context import TaskContext as JaxContext
from blaze_tpu.tpcds import TPCDS_SCHEMAS as JAX_SCHEMAS
from blaze_tpu.tpcds import build_query as jax_build_query
from blaze_tpu.tpcds import generate_all as jax_generate_all
from blaze_tpu.tpcds import oracle as jax_oracle
from blaze_tpu.tpch.datagen import table_to_batches as jax_table_to_batches

from blaze_tpu_torch.batch import batch_to_pydict, table_to_batches
from blaze_tpu_torch.ops import MemoryScanExec
from blaze_tpu_torch.runtime.context import TaskContext
from blaze_tpu_torch.tpcds import TPCDS_SCHEMAS, build_query, generate_all, generate_table
from blaze_tpu_torch.tpcds import oracle as O

SCALE = 0.01
N_PARTS = 2
TABLES = ("date_dim", "store_sales", "item", "customer_demographics", "promotion")


@pytest.fixture(scope="module")
def data():
    return generate_all(SCALE)


@pytest.fixture(scope="module")
def jax_data():
    return jax_generate_all(SCALE)


def _run(plan, to_pydict, context):
    out = {f.name: [] for f in plan.schema.fields}
    for p in range(plan.num_partitions()):
        for b in plan.execute(p, context(p, plan.num_partitions())):
            for k, v in to_pydict(b).items():
                out[k].extend(v)
    return out


def scans(data):
    return {name: MemoryScanExec(table_to_batches(data[name], TPCDS_SCHEMAS[name], N_PARTS, 4096, device="cpu"),
                                 TPCDS_SCHEMAS[name], device="cpu") for name in TABLES}


def _both(data, jax_data, q):
    jscans = {name: JaxScan(jax_table_to_batches(jax_data[name], JAX_SCHEMAS[name], N_PARTS, batch_rows=4096),
                            JAX_SCHEMAS[name]) for name in TABLES}
    return (_run(build_query(q, scans(data), N_PARTS), batch_to_pydict, TaskContext),
            _run(jax_build_query(q, jscans, N_PARTS), jax_to_pydict, JaxContext))


def test_schemas_equal_reference():
    assert {k: repr(v) for k, v in TPCDS_SCHEMAS.items()} == {k: repr(v) for k, v in JAX_SCHEMAS.items()}


def test_datagen_equals_reference(data, jax_data):
    assert data.keys() == jax_data.keys()
    for name in data:
        assert data[name].keys() == jax_data[name].keys(), name
        for c in data[name]:
            for a, b in zip(data[name][c], jax_data[name][c]):
                if a is None or b is None:
                    assert a is b, (name, c)
                else:
                    np.testing.assert_array_equal(a, b, err_msg=f"{name}.{c}")


def test_datagen_column_subset_is_a_projection(data):
    sub = generate_table("store_sales", SCALE, columns={"ss_item_sk", "ss_coupon_amt"})
    assert set(sub) == {"ss_item_sk", "ss_coupon_amt"}
    for c in sub:
        np.testing.assert_array_equal(sub[c][0], data["store_sales"][c][0])


def check_q3(got, exp):
    """Every row equals the oracle's group; the top 100 in (year,
    descending sum, brand id) order."""
    rows = list(zip(got["d_year"], got["brand_id"], got["brand"], got["sum_agg"]))
    assert len(rows) == min(len(exp), 100) and len(rows) > 5
    assert all(exp[r[:3]] == r[3] for r in rows)
    assert rows == sorted(rows, key=lambda r: (r[0], -r[3], r[1]))


def check_q7(got, exp):
    assert got["i_item_id"] == sorted(got["i_item_id"])
    assert len(got["i_item_id"]) == min(len(exp), 100) and len(exp) > 5
    for i, iid in enumerate(got["i_item_id"]):
        e = exp[iid]
        assert abs(got["agg1"][i] - e[0]) < 1e-9, (iid, got["agg1"][i], e[0])
        for k, m in enumerate(("agg2", "agg3", "agg4"), start=1):
            assert abs(got[m][i] - e[k]) <= 1, (iid, m, got[m][i], e[k])


def test_q3_equals_reference_and_oracle(data, jax_data):
    got, want = _both(data, jax_data, "q3")
    exp = O.oracle_q3(data)
    assert exp == jax_oracle.oracle_q3(jax_data)
    check_q3(got, exp)
    assert got == want


def test_q7_equals_reference_and_oracle(data, jax_data):
    got, want = _both(data, jax_data, "q7")
    exp = O.oracle_q7(data)
    assert exp == jax_oracle.oracle_q7(jax_data)
    check_q7(got, exp)
    assert got == want
