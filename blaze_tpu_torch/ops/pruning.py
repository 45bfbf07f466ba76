"""Column pruning: narrow each operator's input to the columns it and
its ancestors use (≙ ``blaze_tpu/ops/pruning.py``).

Name-based column resolution makes the rewrite safe: an operator keeps
working as long as the names it references survive.  A file scan
(parquet or ORC) is narrowed at its source: it is rebuilt with the
narrowed schema, so a column no operator reads is never decoded.  Any
other narrowed child gets the free select (``ProjectExec`` of bare
columns, a host-side pick of the batch's columns), a memory scan
included, as in the reference.  An operator the pass does not know
keeps all of its children's columns.

Apply with ``prune_columns(plan)``; ``optimize_plan`` (ops/fusion.py)
runs it between the tiers.
"""

from __future__ import annotations

from typing import Optional, Set

from ..exprs.compile import expr_children
from ..exprs.ir import Col, Expr


def expr_columns(e: Expr) -> Set[str]:
    """Every column name the tree references."""
    if isinstance(e, Col):
        return {e.name}
    out: Set[str] = set()
    for c in expr_children(e):
        out |= expr_columns(c)
    return out


def _narrow(child, needed: Set[str]):
    """``child`` cut to the ``needed`` columns, in its column order: a
    file scan rebuilt to read only them, anything else under a select."""
    from ..schema import Schema
    from .orc_scan import OrcScanExec
    from .parquet_scan import ParquetScanExec
    from .project import ProjectExec

    if not needed <= set(child.schema.names):
        return child  # a needed name the child cannot provide: untouched
    names = [n for n in child.schema.names if n in needed]
    if not names and child.schema.names:
        # a consumer of no column (an all-literal projection) still
        # needs one column to carry the batch's capacity
        names = [child.schema.names[0]]
    if len(names) == len(child.schema.names):
        return child
    if isinstance(child, (ParquetScanExec, OrcScanExec)):
        return type(child)(child.file_groups, Schema([child.schema.field(n) for n in names]), child.predicate,
                           child.batch_rows, device=child.device)
    return ProjectExec(child, [Col(n) for n in names], names)


def _kept(exprs, names, required: Optional[Set[str]]):
    """The (expr, name) pairs a parent needs; at least the first."""
    pairs = list(zip(exprs, names))
    return [(e, n) for e, n in pairs if required is None or n in required] or pairs[:1]


def prune_columns(plan, required: Optional[Set[str]] = None):
    """``plan`` rewritten so every operator receives only the columns
    it or its ancestors need (``required`` by the parent; None: all of
    the plan's output).  Returns the (possibly replaced) root.  An
    exchange two parents share (TPC-DS q44's, under both ranked
    branches) stays one exchange where both require the same columns,
    so it still runs once; other nodes are pruned per parent, as in the
    reference."""
    from ..parallel.exchange import NativeShuffleExchangeExec

    memo = {}

    def prune(node, req):
        if not isinstance(node, NativeShuffleExchangeExec):
            return _prune(node, req, prune)
        key = (id(node), None if req is None else frozenset(req))
        if key not in memo:
            memo[key] = _prune(node, req, prune)
        return memo[key]

    return prune(plan, required)


def _prune(plan, required: Optional[Set[str]], prune_columns):
    """One node of :func:`prune_columns`; ``prune_columns`` prunes a
    child."""
    from ..parallel.exchange import NativeShuffleExchangeExec
    from ..parallel.shuffle import HashPartitioning, RangePartitioning
    from .agg import AggExec, AggMode
    from .coalesce import CoalesceBatchesExec
    from .filter import FilterExec
    from .joins import BroadcastJoinExec, HashJoinExec
    from .limit import LimitExec
    from .project import ProjectExec
    from .sort import SortExec
    from .union import UnionExec

    req = set(required) if required is not None else set(plan.schema.names)

    if isinstance(plan, ProjectExec):
        kept = _kept(plan.exprs, plan.names, required)
        child_req = set().union(*(expr_columns(e) for e, _ in kept))
        child = prune_columns(plan.children[0], child_req)
        return ProjectExec(_narrow(child, child_req), [e for e, _ in kept], [n for _, n in kept])

    if isinstance(plan, FilterExec):
        child_req = expr_columns(plan.predicate)
        project = plan.project
        if project is not None:
            kept = _kept(*project, required)
            project = ([e for e, _ in kept], [n for _, n in kept])
            for e, _ in kept:
                child_req |= expr_columns(e)
        else:
            child_req |= req
        child = prune_columns(plan.children[0], child_req)
        return FilterExec(_narrow(child, child_req), plan.predicate, project)

    if isinstance(plan, AggExec):
        if plan.mode != AggMode.PARTIAL:
            child_req = set(plan.children[0].schema.names)  # the state columns
        else:
            child_req = set()
            for e in [g.expr for g in plan.groupings] + [a.expr for a in plan.aggs] + [plan.pre_filter]:
                if e is not None:
                    child_req |= expr_columns(e)
            if not child_req and plan.children[0].schema.names:
                # count(*) alone: one column still carries the batch
                child_req = {plan.children[0].schema.names[0]}
        child = prune_columns(plan.children[0], child_req)
        return AggExec(
            _narrow(child, child_req), plan.mode, plan.groupings, plan.aggs,
            supports_partial_skipping=plan.supports_partial_skipping,
            pre_filter=plan.pre_filter, post_sort=plan.post_sort, post_fetch=plan.post_fetch,
        )

    if isinstance(plan, SortExec):
        child_req = req | {c for f in plan.fields for c in expr_columns(f.expr)}
        child = prune_columns(plan.children[0], child_req)
        return SortExec(_narrow(child, child_req), plan.fields, plan.fetch)

    if isinstance(plan, NativeShuffleExchangeExec):
        child_req = set(req)
        if isinstance(plan.partitioning, HashPartitioning):
            for e in plan.partitioning.exprs:
                child_req |= expr_columns(e)
        elif isinstance(plan.partitioning, RangePartitioning):
            # the range key's columns feed the pids, whatever the parent
            # reads (the reference drops them: ROADMAP queue C, defect 18)
            for f in plan.partitioning.fields:
                child_req |= expr_columns(f.expr)
        child = prune_columns(plan.children[0], child_req)
        return NativeShuffleExchangeExec(_narrow(child, child_req), plan.partitioning,
                                         plan.parallel_map_tasks)

    if isinstance(plan, (HashJoinExec, BroadcastJoinExec)):
        sides = plan.children
        side_names = [set(s.schema.names) for s in sides]
        if side_names[0] & side_names[1]:
            return plan  # ambiguous names: untouched
        new_sides = []
        for side, keys, names in zip(sides, (plan.build_keys, plan.probe_keys), side_names):
            side_req = (req & names) | {c for e in keys for c in expr_columns(e)}
            new_sides.append(_narrow(prune_columns(side, side_req), side_req))
        extra = {}
        if isinstance(plan, BroadcastJoinExec):
            extra["cached_build_id"] = plan.cached_build_id
            if plan.map_mode:
                # the serialized map's side is left as it is (its schema
                # names none of the columns): the map decodes to the data
                # schema the join declares
                extra["build_data_schema"] = plan.build_data_schema
        return type(plan)(new_sides[0], new_sides[1], plan.build_keys, plan.probe_keys,
                          plan.join_type, plan.build_is_left, **extra)

    if isinstance(plan, UnionExec):
        # every child narrowed alike; a union that must keep all of its
        # columns is left as it is, children included (as in the
        # reference)
        if req == set(plan.schema.names):
            return plan
        return UnionExec([_narrow(prune_columns(c, set(req)), set(req)) for c in plan.children])

    if isinstance(plan, (LimitExec, CoalesceBatchesExec)):
        plan.children[0] = _narrow(prune_columns(plan.children[0], req), req)
        return plan

    # an operator the pass does not know: all of its children's columns
    for i, c in enumerate(list(plan.children)):
        plan.children[i] = prune_columns(c, None)
    return plan
