"""Built-in host UDAFs over the opaque-state tier
(≙ ``blaze_tpu/ops/udafs.py``, the port's own copy).

The aggregates Spark runs through ObjectHashAggregate's typed
imperative path (HyperLogLogPlusPlus for approx_count_distinct,
QuantileSummaries for percentile_approx): mergeable sketch states that
no fixed-width device layout expresses.  They ride
:class:`~blaze_tpu_torch.ops.object_agg.ObjectAggExec` as OPAQUE
columns through exchanges (pickle wire format).

States are plain numpy/python objects and the update/merge functions
are module-level (picklable across the TaskDefinition boundary).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from ..exprs.ir import Expr
from ..schema import DataType
from .object_agg import Udaf

# ----------------------------------------------------------------- HLL

_HLL_P = 12                      # 4096 registers, ~1.6% standard error
_HLL_M = 1 << _HLL_P


def _hll_alpha(m: int) -> float:
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / m)


def _hash64(v) -> int:
    """PROCESS-STABLE 64-bit hash of a python value (blake2b over a
    canonical byte encoding).  The builtin ``hash`` is
    PYTHONHASHSEED-randomized, which would make HLL registers disagree
    between executor processes — merged sketches would then approach
    the SUM of partials instead of the union."""
    import hashlib
    import struct

    if isinstance(v, bool):
        payload = b"b:1" if v else b"b:0"
    elif isinstance(v, float):
        if math.isnan(v):
            payload = b"f:nan"  # all NaNs are one distinct value
        elif v.is_integer():
            payload = b"i:" + str(int(v)).encode()  # 2.0 == 2
        else:
            payload = b"f:" + struct.pack("<d", v)
    elif isinstance(v, int):
        payload = b"i:" + str(v).encode()
    elif isinstance(v, str):
        payload = b"s:" + v.encode()
    elif isinstance(v, bytes):
        payload = b"y:" + v
    else:
        payload = b"r:" + repr(v).encode()
    return int.from_bytes(
        hashlib.blake2b(payload, digest_size=8).digest(), "little"
    )


def _hll_init():
    return np.zeros(_HLL_M, np.uint8)


def _hll_update(state, v):
    if v is None:
        return state
    h = _hash64(v)
    idx = h & (_HLL_M - 1)
    rest = h >> _HLL_P
    # rank = leading position of the first 1-bit in the remaining 52
    rank = (52 - rest.bit_length()) + 1 if rest else 53
    if rank > state[idx]:
        state[idx] = rank
    return state


def _hll_merge(a, b):
    if b is None:
        return a
    return np.maximum(a, b)


def _hll_finish(state) -> int:
    m = float(_HLL_M)
    est = _hll_alpha(_HLL_M) * m * m / float(np.sum(np.exp2(-state.astype(np.float64))))
    zeros = int(np.count_nonzero(state == 0))
    if est <= 2.5 * m and zeros:
        est = m * math.log(m / zeros)  # linear counting for small cardinality
    return int(round(est))


def approx_count_distinct(expr: Expr, name: str = "approx_count_distinct") -> Udaf:
    """HyperLogLog++ (dense, p=12) distinct count — mergeable across
    partitions, ~1.6% standard error."""
    return Udaf(
        name=name,
        init=_hll_init,
        update=_hll_update,
        merge=_hll_merge,
        finish=_hll_finish,
        args=[expr],
        result_dtype=DataType.int64(),
    )


# ------------------------------------------------------------- t-digest

_TD_MAX_CENTROIDS = 100


class _TDigest:
    """Tiny merging t-digest: centroids kept sorted; compression by
    scale-function-limited pairwise merging.  Mergeable and picklable."""

    __slots__ = ("means", "weights", "count")

    def __init__(self):
        self.means: List[float] = []
        self.weights: List[float] = []
        self.count = 0.0

    def add(self, x: float, w: float = 1.0):
        self.means.append(float(x))
        self.weights.append(float(w))
        self.count += w
        if len(self.means) > 4 * _TD_MAX_CENTROIDS:
            self.compress()

    def compress(self):
        if not self.means:
            return
        order = np.argsort(np.asarray(self.means), kind="stable")
        means = np.asarray(self.means)[order]
        weights = np.asarray(self.weights)[order]
        total = float(weights.sum())
        out_m: List[float] = []
        out_w: List[float] = []
        q0 = 0.0
        cur_m, cur_w = means[0], weights[0]
        for m, w in zip(means[1:], weights[1:]):
            q = q0 + (cur_w + w) / total
            # k1 scale function bound on centroid span
            limit = total * 4.0 * q * (1 - q) / _TD_MAX_CENTROIDS + 1e-9
            if cur_w + w <= limit:
                cur_m = (cur_m * cur_w + m * w) / (cur_w + w)
                cur_w += w
            else:
                out_m.append(float(cur_m))
                out_w.append(float(cur_w))
                q0 += cur_w / total
                cur_m, cur_w = m, w
        out_m.append(float(cur_m))
        out_w.append(float(cur_w))
        self.means, self.weights = out_m, out_w

    def quantile(self, q: float) -> Optional[float]:
        self.compress()
        if not self.means:
            return None
        if len(self.means) == 1:
            return self.means[0]
        cum = 0.0
        target = q * self.count
        for i, (m, w) in enumerate(zip(self.means, self.weights)):
            if cum + w >= target:
                # interpolate within the centroid neighborhood
                prev_m = self.means[i - 1] if i else m
                frac = (target - cum) / w if w else 0.0
                return prev_m + (m - prev_m) * min(max(frac, 0.0), 1.0)
            cum += w
        return self.means[-1]


def _td_init():
    return _TDigest()


def _td_update(state, v):
    if v is not None:
        state.add(float(v))
    return state


def _td_merge(a, b):
    if b is None:
        return a
    for m, w in zip(b.means, b.weights):
        a.add(m, w)  # counts accumulate inside add
    return a


def _td_finish(percentage: float, state):
    q = state.quantile(percentage)
    return None if q is None else float(q)


def approx_percentile(
    expr: Expr, percentage: float, name: str = "approx_percentile"
) -> Udaf:
    """Mergeable t-digest percentile (float64 result) — the
    percentile_approx analogue.  ``finish`` is a partial of a
    module-level function so the Udaf stays picklable across the
    TaskDefinition boundary."""
    import functools

    return Udaf(
        name=name,
        init=_td_init,
        update=_td_update,
        merge=_td_merge,
        finish=functools.partial(_td_finish, percentage),
        args=[expr],
        result_dtype=DataType.float64(),
    )
