"""Nested ORC fields in the port against the JAX package (≙ the nested
cases of the reference's ``tests/test_orc_real.py``).

pyarrow writes LIST, MAP, STRUCT and nested LIST files; both packages'
scans read them to the same rows.  The port's writer gives the
reference's writer's bytes for the same values (a compound column's
decimals are unscaled ints in the port, logical decimals in the
reference), and the reference's reader reads the port's files.
"""

import decimal
import random

import numpy as np
import pyarrow as pa
import pyarrow.orc as paorc
import pytest
import torch

from blaze_tpu import schema as RS
from blaze_tpu.batch import batch_to_pydict as jax_to_pydict, concat_batches as jax_concat
from blaze_tpu.exprs import ir as JI
from blaze_tpu.io import orc as rorc
from blaze_tpu.ops import FilterExec as JaxFilter
from blaze_tpu.ops.orc_scan import OrcScanExec as JaxOrcScan
from blaze_tpu.runtime.context import TaskContext as JaxContext

from blaze_tpu_torch import schema as PS
from blaze_tpu_torch.batch import batch_to_pydict, concat_batches
from blaze_tpu_torch.exprs import ir as TI
from blaze_tpu_torch.io import orc as porc
from blaze_tpu_torch.ops import FilterExec, OrcScanExec
from blaze_tpu_torch.runtime.context import TaskContext


def _port(scan) -> dict:
    bs = [b for p in range(scan.num_partitions()) for b in scan.execute(p, TaskContext(p, scan.num_partitions()))]
    assert all(b.device == torch.device("cpu") for b in bs)
    return batch_to_pydict(concat_batches(bs))


def _ref(scan) -> dict:
    bs = [b for p in range(scan.num_partitions()) for b in scan.execute(p, JaxContext(p, scan.num_partitions()))]
    return jax_to_pydict(jax_concat(bs))


def _lists(rng, n):
    return [None if rng.random() < 0.1 else [] if rng.random() < 0.15 else
            [None if rng.random() < 0.15 else rng.randrange(-10**9, 10**9) for _ in range(rng.randrange(1, 7))]
            for _ in range(n)]


def _maps(rng, n):
    return [None if rng.random() < 0.1 else {} if rng.random() < 0.1 else
            {f"k{j}": rng.randrange(-1000, 1000) for j in range(rng.randrange(1, 5))} for _ in range(n)]


def _structs(rng, n):
    return [None if rng.random() < 0.12 else
            {"a": None if rng.random() < 0.2 else rng.randrange(0, 999),
             "s": None if rng.random() < 0.2 else f"s{rng.randrange(30)}",
             "d": None if rng.random() < 0.2 else decimal.Decimal(rng.randrange(-99999, 99999)) / 100}
            for _ in range(n)]


def _nested_lists(rng, n):
    return [None if rng.random() < 0.1 else
            [None if rng.random() < 0.1 else [rng.randrange(100) for _ in range(rng.randrange(0, 4))]
             for _ in range(rng.randrange(0, 4))] for _ in range(n)]


def _string_lists(rng, n):
    return [None if rng.random() < 0.1 else
            [None if rng.random() < 0.15 else f"w{rng.randrange(20)}" for _ in range(rng.randrange(0, 5))]
            for _ in range(n)]


def _type(S, case):
    T, F = S.DataType, S.Field
    return {"list": T.array(T.int64(), 8), "map": T.map(T.string(8), T.int64(), 8),
            "struct": T.struct([F("a", T.int64()), F("s", T.string(8)), F("d", T.decimal(7, 2))]),
            "nested-lists": T.array(T.array(T.int64(), 8), 8), "string-lists": T.array(T.string(8), 8)}[case]


PA_TYPES = {"list": pa.list_(pa.int64()), "map": pa.map_(pa.string(), pa.int64()),
            "struct": pa.struct([("a", pa.int64()), ("s", pa.string()), ("d", pa.decimal128(7, 2))]),
            "nested-lists": pa.list_(pa.list_(pa.int64())), "string-lists": pa.list_(pa.string())}
MAKERS = {"list": _lists, "map": _maps, "struct": _structs, "nested-lists": _nested_lists,
          "string-lists": _string_lists}


def _expected(case, rows):
    if case == "struct":  # decimals come back unscaled
        return [None if r is None else {**r, "d": None if r["d"] is None else int(r["d"] * 100)} for r in rows]
    return rows


@pytest.mark.parametrize("compression", ["UNCOMPRESSED", "ZLIB", "SNAPPY"])
@pytest.mark.parametrize("case", list(MAKERS))
def test_pyarrow_nested_column_reads_as_the_reference(tmp_path, case, compression):
    rng = random.Random(list(MAKERS).index(case) + 7)
    n = 300
    rows = MAKERS[case](rng, n)
    pa_rows = [None if r is None else list(r.items()) for r in rows] if case == "map" else rows
    path = str(tmp_path / f"{case}.orc")
    paorc.write_table(pa.table({"id": pa.array(range(n), pa.int64()), "v": pa.array(pa_rows, PA_TYPES[case])}),
                      path, compression=compression, stripe_size=4096)
    schema = lambda S: S.Schema([S.Field("id", S.DataType.int64()), S.Field("v", _type(S, case))])
    got = _port(OrcScanExec([[path]], schema(PS), batch_rows=128, device="cpu"))
    assert got == _ref(JaxOrcScan([[path]], schema(RS), batch_rows=128))
    assert got["id"] == list(range(n)) and got["v"] == _expected(case, rows)


def _write_inputs(n=200, seed=3):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 5, n).astype(np.int32)
    valid = rng.random(n) > 0.1
    edata = rng.integers(-10**6, 10**6, (n, 4))
    evalid = rng.random((n, 4)) > 0.2
    pyr = random.Random(seed)
    maps = [None if pyr.random() < 0.1 else {pyr.randrange(100): pyr.randrange(-50, 50) for _ in range(pyr.randrange(4))}
            for _ in range(n)]
    structs = [None if pyr.random() < 0.1 else {"dt": pyr.randrange(0, 20000), "p": pyr.randrange(-10**6, 10**6),
                                                "s": None if pyr.random() < 0.2 else f"x{pyr.randrange(9)}"}
               for _ in range(n)]
    lol = _nested_lists(pyr, n)
    return (np.arange(n, dtype=np.int64), (None, valid, lens, (edata, evalid)), maps, structs, lol)


def _write_schema(S):
    T, F = S.DataType, S.Field
    return S.Schema([F("id", T.int64()), F("l", T.array(T.int64(), 4)), F("m", T.map(T.int32(), T.int64(), 4)),
                     F("st", T.struct([F("dt", T.date32()), F("p", T.decimal(12, 2)), F("s", T.string(8))])),
                     F("ll", T.array(T.array(T.int64(), 8), 8))])


@pytest.mark.parametrize("compression", ["none", "zlib", "snappy", "lz4"])
def test_writer_bytes_equal_the_reference_and_read_both_ways(tmp_path, compression):
    ids, lst, maps, structs, lol = _write_inputs()
    port_cols = {"id": (ids, None, None), "l": lst, "m": maps, "st": structs, "ll": lol}
    # the reference's compound values take logical decimals
    ref_structs = [None if s is None else {**s, "p": decimal.Decimal(s["p"]).scaleb(-2)} for s in structs]
    ref_cols = {**port_cols, "st": ref_structs}
    a, b = tmp_path / "ref.orc", tmp_path / "port.orc"
    rorc.write_orc(str(a), _write_schema(RS), ref_cols, stripe_rows=70, compression=compression)
    porc.write_orc(str(b), _write_schema(PS), port_cols, stripe_rows=70, compression=compression)
    assert a.read_bytes() == b.read_bytes()
    port = _port(OrcScanExec([[str(b)]], _write_schema(PS), batch_rows=64, device="cpu"))
    assert port == _ref(JaxOrcScan([[str(b)]], _write_schema(RS), batch_rows=64))
    _, valid, lens, (edata, evalid) = lst
    want_l = [[int(edata[i, j]) if evalid[i, j] else None for j in range(lens[i])] if valid[i] else None
              for i in range(len(ids))]
    assert port["l"] == want_l and port["m"] == maps and port["st"] == structs and port["ll"] == lol


def test_read_metadata_and_stripes_match_the_reference(tmp_path):
    ids, lst, maps, structs, lol = _write_inputs(150, seed=9)
    path = str(tmp_path / "p.orc")
    porc.write_orc(path, _write_schema(PS), {"id": (ids, None, None), "l": lst, "m": maps, "st": structs, "ll": lol},
                   stripe_rows=60)
    pm, rm = porc.read_metadata(path, list_elems=4), rorc.read_metadata(path, list_elems=4)
    assert [f.name for f in pm.schema.fields] == [f.name for f in rm.schema.fields]
    assert pm.field_ids == rm.field_ids and pm.type_tree == rm.type_tree
    for ps, rs_ in zip(pm.stripes, rm.stripes):
        assert (ps.rows, ps.stats) == (rs_.rows, rs_.stats)
        got, want = porc.read_stripe(path, pm, ps), rorc.read_stripe(path, rm, rs_)
        for u, v in zip(got["l"][1:3] + got["l"][3], want["l"][1:3] + want["l"][3]):
            assert np.array_equal(u, v)
        assert got["m"] == want["m"] and got["ll"] == want["ll"]


def test_list_exceeding_max_elems_is_gated(tmp_path):
    path = str(tmp_path / "long.orc")
    paorc.write_table(pa.table({"v": pa.array([[1, 2, 3, 4, 5]], pa.list_(pa.int64()))}), path)
    schema = lambda S: S.Schema([S.Field("v", S.DataType.array(S.DataType.int64(), 4))])
    with pytest.raises(NotImplementedError, match="max_elems"):
        _port(OrcScanExec([[path]], schema(PS), device="cpu"))
    with pytest.raises(NotImplementedError, match="max_elems"):
        _ref(JaxOrcScan([[path]], schema(RS)))


def test_missing_nested_field_reads_as_nulls(tmp_path):
    path = str(tmp_path / "flat.orc")
    paorc.write_table(pa.table({"id": pa.array([1, 2, 3], pa.int64())}), path)
    schema = lambda S: S.Schema([S.Field("id", S.DataType.int64()), S.Field("l", S.DataType.array(S.DataType.int64(), 4)),
                                 S.Field("st", S.DataType.struct([S.Field("a", S.DataType.int32())]))])
    got = _port(OrcScanExec([[path]], schema(PS), device="cpu"))
    assert got == {"id": [1, 2, 3], "l": [None] * 3, "st": [None] * 3}


def test_filter_keeps_nested_children(tmp_path):
    rng = random.Random(5)
    rows = _lists(rng, 100)
    path = str(tmp_path / "f.orc")
    paorc.write_table(pa.table({"id": pa.array(range(100), pa.int64()), "v": pa.array(rows, pa.list_(pa.int64()))}),
                      path)
    schema = lambda S: S.Schema([S.Field("id", S.DataType.int64()), S.Field("v", S.DataType.array(S.DataType.int64(), 8))])
    port = _port(FilterExec(OrcScanExec([[path]], schema(PS), device="cpu"), TI.col("id") % TI.lit(3) == TI.lit(0)))
    ref = _ref(JaxFilter(JaxOrcScan([[path]], schema(RS)), JI.col("id") % JI.lit(3) == JI.lit(0)))
    assert port == ref and port["v"] == rows[::3]
