"""``stddev_samp`` and ``var_samp`` of the port's ``AggExec``, part 2: the
decimal(7,2) input (divided by ``10**scale`` before any moment), the
values near 1e9 (within 1e-9: see ``test_torch_agg_stddev.py``), one
value and two values alone, and the three state columns across the
``.data`` files of ``split_stages``/``run_stages``.  The table, the
plans and the exact oracle are ``test_torch_agg_stddev.py``'s."""

import pytest

import blaze_tpu_torch
from blaze_tpu_torch.batch import batch_to_pydict
from blaze_tpu_torch.ops import AggExec, AggMode
from blaze_tpu_torch.ops.fusion import optimize_plan
from blaze_tpu_torch.runtime.context import RESOURCES, TaskContext
from blaze_tpu_torch.runtime.scheduler import run_stages, split_stages

from test_torch_agg_stddev import CPU, N, _close, _oracle, _plans, _rows, _run, _table, case_ids, check_case

CASES = [(c, g, N) for c in ("dec", "big", "fbig") for g in (True, False)]
CASES += [("dec", False, 1), ("big", True, 2)]


@pytest.mark.parametrize("column,grouped,n", CASES, ids=case_ids(CASES))
def test_stddev_and_variance_equal_the_reference_and_the_exact_oracle(column, grouped, n):
    check_case(column, grouped, n)


def test_state_columns_cross_the_shuffle_files():
    """The optimized plan through split_stages/run_stages: the
    ``#cnt``/``#fsum``/``#m2`` states survive pruning, the tier-5 write
    and the ``.data`` files."""
    prev = blaze_tpu_torch._default_device
    blaze_tpu_torch.set_default_device(CPU)
    try:
        table = _table(N)
        port, _ = _plans(table, "dec", True)
        partial = port.children[0].children[0]
        assert isinstance(partial, AggExec) and partial.mode == AggMode.PARTIAL
        assert [f.name for f in partial.schema.fields] == ["g", "sd#cnt", "sd#fsum", "sd#m2", "var#cnt", "var#fsum",
                                                           "var#m2"]
        inproc = _rows(_run(optimize_plan(_plans(table, "dec", True)[0]), batch_to_pydict, TaskContext), True)
        stages, manager = split_stages(port)
        out = {"g": [], "sd": [], "var": []}
        for b in run_stages(stages, manager):
            for k, v in batch_to_pydict(b).items():
                out[k].extend(v)
        staged = _rows(out, True)
        exact = _oracle(table, "dec", True)
        assert set(staged) == set(inproc) == set(exact)
        assert all(_close(a, b) and _close(a, c) for k in staged
                   for a, b, c in zip(staged[k], inproc[k], exact[k]))
        assert not len(RESOURCES)
    finally:
        blaze_tpu_torch.set_default_device(prev)


