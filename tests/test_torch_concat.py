"""``concat`` of the port (``blaze_tpu_torch/exprs/functions.py``) against
the JAX package's and Python's string concatenation.

Seeded string columns with nulls, empty strings and non-ASCII bytes go
through both packages' lowering: the result type
(``string(string_width_for(sum of widths))``), the values (null where
any argument is null), the padded bytes and the lengths are equal, row
for row, including widths that sum past any one argument's and strings
that fill their whole width.  A string literal's width is its own
(``", "``: string(8)), as in TPC-DS q84's ``concat(last, ", ", first)``.
"""

import numpy as np
import pytest

from blaze_tpu.batch import column_from_strings as jax_column_from_strings
from blaze_tpu.batch import column_to_pylist as jax_column_to_pylist
from blaze_tpu.exprs import col as jcol, lit as jlit
from blaze_tpu.exprs import compile as JC
from blaze_tpu.exprs.ir import func as jfunc
from blaze_tpu.schema import DataType as JT, Field as JF, Schema as JSchema

from blaze_tpu_torch.batch import column_from_strings, column_to_pylist
from blaze_tpu_torch.exprs import col as tcol, compile as TC, func as tfunc, lit as tlit
from blaze_tpu_torch.schema import DataType as TT, Field as TF, Schema as TSchema

CPU = "cpu"
N = 300
WORDS = ["", "a", "Jones", "Linda", "é", "日本語", "ß-ü", "x" * 8, "y" * 16, "abcdefgh" * 4, ", "]


def _column(rng, width):
    """Words that fit ``width``, about one in eight null."""
    fits = [w for w in WORDS if len(w.encode()) <= width]
    return [fits[i] if rng.random() > 0.125 else None for i in rng.integers(0, len(fits), N)]


def _lower_both(args, widths, seed):
    """``concat(args)`` in both packages over columns s0, s1, ... of the
    given widths; ``args`` holds column indices and string literals."""
    rng = np.random.default_rng(seed)
    cols = [_column(rng, w) for w in widths]
    tschema = TSchema([TF(f"s{i}", TT.string(w)) for i, w in enumerate(widths)])
    jschema = JSchema([JF(f"s{i}", JT.string(w)) for i, w in enumerate(widths)])
    tenv = {f"s{i}": column_from_strings(c, width=w, capacity=N, device=CPU)
            for i, (c, w) in enumerate(zip(cols, widths))}
    jenv = {f"s{i}": jax_column_from_strings(c, width=w, capacity=N).to_device()
            for i, (c, w) in enumerate(zip(cols, widths))}
    targs = [tcol(f"s{a}") if isinstance(a, int) else tlit(a) for a in args]
    jargs = [jcol(f"s{a}") if isinstance(a, int) else jlit(a) for a in args]
    tc = TC.lower(tfunc("concat", *targs), tschema, tenv, N)
    jc = JC.lower(jfunc("concat", *jargs), jschema, jenv, N)
    values = [[cols[a][r] if isinstance(a, int) else a for a in args] for r in range(N)]
    assert all("" in c and None in c for c in cols)
    return tc, jc, [None if any(v is None for v in row) else "".join(row) for row in values]


CASES = [
    ((0, 1), (8, 16)),
    ((0, ", ", 1), (16, 16)),
    ((0, 0, 0), (8,)),
    ((0, 1, 2), (32, 8, 16)),
    ((0,), (16,)),
    (("<", 0, ">"), (8,)),
]


@pytest.mark.parametrize("args,widths", CASES, ids=[f"{len(a)}args-{'x'.join(map(str, w))}" for a, w in CASES])
def test_concat_equals_the_reference_and_python(args, widths):
    tc, jc, want = _lower_both(args, widths, seed=sum(widths) + len(args))
    assert repr(tc.dtype) == repr(jc.dtype)
    assert column_to_pylist(tc, N) == jax_column_to_pylist(jc, N) == want
    assert np.array_equal(tc.data.numpy(), np.asarray(jc.data))
    assert np.array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    assert any(v is None for v in want) and any(v and not v.isascii() for v in want)


def test_concat_width_is_the_power_of_two_over_the_sum():
    tc, jc, _ = _lower_both((0, ", ", 1), (16, 16), seed=3)
    # 16 + 8 (the literal's own string(8)) + 16 = 40 -> 64
    assert tc.dtype.string_width == jc.dtype.string_width == 64
    full = max(len(v.encode()) for v in column_to_pylist(tc, N) if v is not None)
    assert full > 16
