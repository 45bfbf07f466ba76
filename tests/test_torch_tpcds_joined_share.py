"""TPC-DS's multi-fact, shuffled and self joins through the port
(``JOINED_QUERIES``): the helpers of ``test_torch_tpcds_joined_*.py``,
the check that the port's ``QUERIES`` are the reference's 103, and the
check of the four plans that keep a shared exchange one node.  The
other 22 are held node for node to the reference's, built and
optimized, by ``test_torch_fusion.py``.

Each query (a) equals the reference's rows in process and (b) equals
the port's oracle on a nonempty result, optimized in process and
through ``split_stages``/``run_stages``, as
``test_torch_tpcds_window_share.py`` describes, at SF 0.002 (every one
of the 26 selects rows there). The generated tables and the
reference's rows are kept once per worker
(``test_torch_tpcds_report_share.py`` ``tables``).

q72 (catalog lines of one buyer profile shuffle-joined to all of
``inventory`` on the item, the heaviest join of the port, then filtered
on the week and the quantity on hand) runs here, one of the family's
longest tests beside its quickest, so that pytest-xdist (which hands
out the files with the most tests first) does not start it last."""

import pytest

import blaze_tpu.tpcds.queries as RQ
from test_torch_fusion import _ds_plans, node_classes
from test_torch_tpcds_report_share import _exchanges, tables
from test_torch_tpcds_window_share import check_both_paths, check_reference, on_cpu  # noqa: F401

from blaze_tpu_torch.ops.fusion import optimize_plan
from blaze_tpu_torch.tpcds.queries import JOINED_QUERIES, QUERIES

#: the queries whose optimized plan keeps an exchange under two consumers
#: one node (q1, q30, q81: the per-customer sums under the location
#: average and the join back; q59: the weekly pivot under both years)
SHARED_EXCHANGE = ("q1", "q30", "q81", "q59")
#: the queries whose reference run is held with its plan cache off (the
#: reference's plan cache scales a decimal scalar subquery twice, ROADMAP
#: queue C, reference defect 9: they select no row with it on)
PLAN_CACHE_OFF = ("q24a", "q24b", "q14b")
SCALE = 0.002


def data():
    return tables(SCALE)


def check(q, plan_cache=True):
    """Both halves of a query's test: the reference's rows in process, then
    the oracle on both paths; returns the stages' kinds."""
    check_reference(data(), q, plan_cache)
    return check_both_paths(data(), q)


def test_the_port_runs_every_query_of_the_reference():
    assert set(QUERIES) == set(RQ.QUERIES) and len(QUERIES) == 103
    assert len(JOINED_QUERIES) == 26 and len(set(JOINED_QUERIES)) == 26


@pytest.mark.parametrize("q", SHARED_EXCHANGE)
def test_keeps_its_shared_exchange_one_node(q):
    """As q65 (``test_torch_tpcds_report_share.py``): the built plans are
    node for node; after optimizing, the port's pruning keeps the
    exchange that two consumers share one node, where the reference
    narrows the shared subtree once per consumer and stacks a second
    projection over the first."""
    port, ref = _ds_plans(q)
    assert node_classes(port) == node_classes(ref)
    ex = _exchanges(optimize_plan(port), [])
    assert len(ex) > len({id(e) for e in ex})


@pytest.mark.parametrize("q", ["q72"])
def test_equals_the_reference_and_the_oracle_on_both_paths(q):
    kinds = check(q)
    assert kinds.count("map") >= 2 and kinds[-1] == "result"
