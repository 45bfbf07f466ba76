"""Seeded tables and two-package projections for the scalar function
tests (``test_torch_functions.py``, ``test_torch_host_functions.py``,
``test_torch_string_casts.py``, ``test_torch_first.py``): the same host table goes into the port
and the JAX package, a family's expressions run as one ProjectExec in
each (one reference compile per family), and the cases compare columns.
"""

import datetime

import numpy as np

from blaze_tpu.batch import batch_to_pydict as jax_to_pydict
from blaze_tpu.exprs import col as jcol, lit as jlit
from blaze_tpu.exprs.ir import Cast as JCast, func as jfunc
from blaze_tpu.ops import MemoryScanExec as JaxScan, ProjectExec as JProject
from blaze_tpu.runtime.context import TaskContext as JaxContext
from blaze_tpu.schema import DataType as JT, Field as JF, Schema as JSchema
from blaze_tpu.tpch.datagen import table_to_batches as jax_table_to_batches

from blaze_tpu_torch.batch import batch_to_pydict, table_to_batches
from blaze_tpu_torch.exprs import col as tcol, lit as tlit
from blaze_tpu_torch.exprs.ir import Cast as TCast, func as tfunc
from blaze_tpu_torch.ops import MemoryScanExec, ProjectExec
from blaze_tpu_torch.runtime.context import TaskContext
from blaze_tpu_torch.schema import DataType as TT, Field as TF, Schema as TSchema


class Side:
    """One package's expression constructors, so a case is written once."""

    def __init__(self, col, lit, func, cast, T):
        self.col, self.lit, self.func, self.T = col, lit, func, T
        self._cast = cast

    def cast(self, e, t):
        return self._cast(e, t)


PORT = Side(tcol, tlit, tfunc, TCast, TT)
REF = Side(jcol, jlit, jfunc, JCast, JT)


def strings_matrix(values, width):
    data = np.zeros((len(values), width), np.uint8)
    lengths = np.zeros(len(values), np.int32)
    for i, v in enumerate(values):
        b = (v or "").encode("utf-8")
        data[i, :len(b)] = np.frombuffer(b, np.uint8)
        lengths[i] = len(b)
    return data, lengths


def host_table(columns):
    """{name: (kind, values, validity)} -> the host table both
    generators' ``table_to_batches`` take; kind is ``("string", W)`` or
    a numpy dtype."""
    out = {}
    for name, (kind, values, valid) in columns.items():
        if isinstance(kind, tuple):
            data, lengths = strings_matrix(values, kind[1])
            out[name] = (data, lengths, valid)
        else:
            out[name] = (np.asarray(values, kind), None, valid)
    return out


def run_family(table, fields, cases, n_parts=2, batch_rows=256):
    """Both packages' rows of one family: ``fields`` are (name, port
    type, reference type), ``cases`` (case id, make(side) -> expr)."""
    tschema = TSchema([TF(n, t) for n, t, _ in fields])
    jschema = JSchema([JF(n, j) for n, _, j in fields])
    names = [cid for cid, _ in cases]
    tscan = MemoryScanExec(table_to_batches(table, tschema, n_parts, batch_rows, "cpu"), tschema, device="cpu")
    jscan = JaxScan(jax_table_to_batches(table, jschema, n_parts, batch_rows=batch_rows), jschema)
    tplan = ProjectExec(tscan, [b(PORT) for _, b in cases], names)
    jplan = JProject(jscan, [b(REF) for _, b in cases], names)
    return (_collect(tplan, TaskContext, batch_to_pydict), _collect(jplan, JaxContext, jax_to_pydict))


def _collect(plan, ctx, to_pydict):
    out = {}
    n = plan.num_partitions()
    for p in range(n):
        for b in plan.execute(p, ctx(p, n)):
            for k, v in to_pydict(b).items():
                out.setdefault(k, []).extend(v)
    return out


def ulps(a: float, b: float) -> int:
    """Distance in units of the last place between two float64s (0
    when both are NaN or equal)."""
    if a == b or (np.isnan(a) and np.isnan(b)):
        return 0
    if np.isnan(a) or np.isnan(b) or np.isinf(a) or np.isinf(b):
        return 2**63
    ia = np.array([a]).view(np.int64)[0]
    ib = np.array([b]).view(np.int64)[0]
    ia = ia if ia >= 0 else -(ia & 0x7FFFFFFFFFFFFFFF)
    ib = ib if ib >= 0 else -(ib & 0x7FFFFFFFFFFFFFFF)
    return abs(int(ia) - int(ib))


def date(y, m, d):
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days
