"""TPC-DS's single-fact reports through the port (``REPORT_QUERIES``:
broadcast joins into one fact table, subqueries run while the plan is
built, CASE pivots): the helpers of ``test_torch_tpcds_report_*.py``,
and the check of q65's optimized plan.  The other 30 are held node for
node to the reference's, built and optimized, by
``test_torch_fusion.py``.

Each query (a) equals the reference's rows in process and (b) equals
the port's oracle on a nonempty result, optimized in process and
through ``split_stages``/``run_stages``, as
``test_torch_tpcds_window_share.py`` describes.  The generated tables
and the reference's rows are kept once per scale and query for every
file a worker runs (:func:`tables`).  q96, q13, q48 and q73 select
nothing at SF 0.002, nor does q61's promotional half: they run at SF
0.01.  The reference's plan cache
scales a decimal scalar subquery twice (ROADMAP queue C, reference
defect 9): q9, q28 and q61 are held to the reference run with it off,
and ``test_torch_tpcds_report_subqueries.py`` pins the defect."""

from test_torch_fusion import _ds_plans, node_classes
from test_torch_tpcds_window_share import on_cpu  # noqa: F401

from blaze_tpu_torch.ops.fusion import optimize_plan
from blaze_tpu_torch.parallel.exchange import NativeShuffleExchangeExec
from blaze_tpu_torch.tpcds import generate_all

_TABLES = {}

#: the queries that select nothing at SF 0.002 (q61: no promotional sale)
AT_SF_001 = ("q96", "q13", "q48", "q73", "q61")
#: the queries whose reference run is held with its plan cache off
PLAN_CACHE_OFF = ("q9", "q28", "q61")


def tables(scale: float):
    """The generated tables at ``scale``, made once per worker: the
    reference's rows (``reference_rows``) are kept by their id."""
    if scale not in _TABLES:
        _TABLES[scale] = generate_all(scale)
    return _TABLES[scale]


def data_of(q: str):
    return tables(0.01 if q in AT_SF_001 else 0.002)


def _exchanges(node, out):
    if isinstance(node, NativeShuffleExchangeExec):
        out.append(node)
    for c in node.children:
        _exchanges(c, out)
    return out


def test_q65_keeps_its_shared_exchange_one_node():
    """q65's per-(store, item) sums feed both the per-store average and
    the join back to it: the port's pruning keeps their exchange one
    node (both consumers need its every column), where the reference
    narrows the shared subtree once per consumer and stacks a second
    projection over the first.  The built plans are node for node."""
    port, ref = _ds_plans("q65")
    assert node_classes(port) == node_classes(ref)
    ex = _exchanges(optimize_plan(port), [])
    assert len(ex) > len({id(e) for e in ex})
