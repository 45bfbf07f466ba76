"""Spark-compatible JSON paths: ``get_json_object`` and ``parse_json``
(≙ ``blaze_tpu/exprs/json_path.py``, the port's own copy).

Hive/Spark's GetJsonObject semantics: ``$`` root, ``.name`` member
access, ``[n]`` index, ``[*]``/``[]`` wildcard, member access flattening
through arrays one level, a single match unwrapped, several re-serialized
as a JSON array, null for any miss or parse failure.  JSON parsing is
data-dependent work with no fixed-shape device form, so these run on the
host, per batch, inside ``compile.lower`` (``functions.host_function``),
as in the reference.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

Step = Tuple  # ("key", name) | ("index", i) | ("wild",)


def parse_path(path: str) -> Optional[List[Step]]:
    """A JSON path's steps; None when it is malformed (Spark's NULL).

    ``.`` right before ``[`` is skipped (``$.a.[0].x`` is valid),
    ``[]``/``[*]`` subscripts every element, a bracket subscript must be
    an unsigned integer (no quoted keys, no whitespace), and ``.*`` is
    the literal key ``"*"`` (Hive's UDFJson has no dot wildcard)."""
    if not path or path[0] != "$":
        return None
    steps: List[Step] = []
    i, n = 1, len(path)
    while i < n:
        c = path[i]
        if c == ".":
            i += 1
            if i < n and path[i] == "[":
                continue
            j = i
            while j < n and path[j] not in ".[":
                j += 1
            name = path[i:j]
            if not name:
                return None
            steps.append(("key", name))
            i = j
        elif c == "[":
            j = path.find("]", i)
            if j < 0:
                return None
            inner = path[i + 1:j]
            if inner in ("*", ""):
                steps.append(("wild",))
            elif inner.isdigit():
                steps.append(("index", int(inner)))
            else:
                return None
            i = j + 1
        else:
            return None
    return steps


def _fold(value, steps: Sequence[Step]):
    """The steps over one JSON value; None stands for both JSON null and
    a miss.  A member step over an array maps each object element, drops
    nulls, flattens nested arrays one level and always yields an array;
    a wildcard is the identity on arrays."""
    for step in steps:
        kind = step[0]
        if kind == "key":
            name = step[1]
            if isinstance(value, dict):
                value = value.get(name)
            elif isinstance(value, list):
                vs: List = []
                for item in value:
                    v = item.get(name) if isinstance(item, dict) else None
                    if v is None:
                        continue
                    if isinstance(v, list):
                        vs.extend(v)
                    else:
                        vs.append(v)
                value = vs if vs else None
            else:
                value = None
        elif kind == "index":
            i = step[1]
            value = value[i] if isinstance(value, list) and i < len(value) else None
        elif not isinstance(value, list):
            value = None
        if value is None:
            return None
    return value


def _render_single(v) -> Optional[str]:
    if v is None:
        return None
    if isinstance(v, str):
        return v  # unquoted
    if isinstance(v, bool):
        return "true" if v else "false"
    return json.dumps(v, separators=(",", ":"), ensure_ascii=False)


def get_json_object(json_str: Optional[str], path: Optional[str],
                    path_cache: Optional[Dict[str, Optional[List[Step]]]] = None) -> Optional[str]:
    """One row of Spark's get_json_object."""
    if json_str is None or path is None:
        return None
    if path_cache is not None and path in path_cache:
        steps = path_cache[path]
    else:
        steps = parse_path(path)
        if path_cache is not None:
            path_cache[path] = steps
    if steps is None:
        return None
    try:
        obj = json.loads(json_str)
    except (ValueError, TypeError):
        return None
    return _render_single(_fold(obj, steps))


def parse_json(json_str: Optional[str]) -> Optional[str]:
    """Validate and normalize (compact re-serialization); a later
    ``get_parsed_json_object`` is ``get_json_object`` over it."""
    if json_str is None:
        return None
    try:
        return json.dumps(json.loads(json_str), separators=(",", ":"), ensure_ascii=False)
    except (ValueError, TypeError):
        return None
