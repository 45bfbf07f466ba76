"""The task optimizer (≙ ``blaze_tpu/ops/fusion.py``): five fusion
tiers and column pruning, composed by :func:`optimize_plan`, which
``serde.from_proto.run_task`` applies to every task it decodes.  The
tiers are gated on ``spark.blaze.fusion.enabled`` (default true).

Column pruning (``ops/pruning.py``) runs between tiers 3 and 4 and is
not gated, as in the reference.

1. **Agg absorption** (:func:`fuse_stages`): a PARTIAL AggExec over
   filters and projections that need no host absorbs them: a predicate
   becomes its ``pre_filter`` (the rows it drops start no group), and
   projections substitute into its expressions, so q06 becomes
   scan -> partial agg.  A projection over a filter (or a filter over a
   projection) becomes one FilterExec with a fused ``project``.
2. **No-op exchange removal** (``_drop_noop_exchanges``): an exchange
   into one partition from a child of one partition moves nothing.
3. **Final-sort folding** (``_fuse_final_sort``): ``Limit?(Sort(FINAL
   agg))`` becomes the agg's ``post_sort``/``post_fetch``: FINAL emits
   one batch per partition, so sorting it inside the agg is exact.
4. **Chain collapse** (:func:`fuse_traceable_chains`, after pruning so
   that pruning still sees the original operators): runs of unary
   operators exposing ``ExecNode.trace_fn`` with at least two that do
   device work become one :class:`FusedStageExec`, which reads the live
   row count back once per batch instead of once per filter (a
   ``GenerateExec`` joins a chain as an expanding operator: its
   ``cap * M`` output rows are re-bucketed after the chain).  A chain
   stops below an operator whose transform needs its whole partition
   in one batch (``trace_requires_buffer``: the window), which becomes
   the chain's bottom over a :class:`BufferPartitionExec`.
5. **Fused shuffle write** (:func:`fuse_shuffle_write`, last): a
   hash-partitioned ``ShuffleWriterExec`` absorbs the chain feeding it;
   per batch it runs the chain, the partition ids (``murmur3_pids``, or
   the plain murmur3 for string keys), the pid sort and the counts
   (``pid_histogram``) with no host read, and the batch's host copy is
   the one read (``ShuffleWriterExec.absorb_traceable_chain``).

Not ported from the reference: the OOM rungs of ``FusedStageExec``,
the plan verifier, the plan cache, the runtime statistics and the
dispatch counters (ROADMAP), and tier 5's fold of a FINAL agg's
finalize.
"""

from __future__ import annotations

from typing import Dict, List

from .. import conf
from ..batch import RecordBatch, bucket_capacity, concat_batches
from ..exprs.ir import (
    Alias, BinOp, Case, Cast, Col, Expr, GetIndexedField, GetMapValue, GetStructField, InList, IsNotNull, IsNull,
    Like, NamedStruct, Not, ScalarFunc,
)
from .base import BatchStream, ExecNode


def substitute(e: Expr, mapping: Dict[str, Expr]) -> Expr:
    """``e`` with its column references replaced per ``mapping``."""
    sub = lambda x: substitute(x, mapping)  # noqa: E731
    if isinstance(e, Col):
        return mapping.get(e.name, e)
    if isinstance(e, Alias):
        return Alias(sub(e.child), e.name)
    if isinstance(e, BinOp):
        return BinOp(e.op, sub(e.left), sub(e.right))
    if isinstance(e, (Not, IsNull, IsNotNull)):
        return type(e)(sub(e.child))
    if isinstance(e, Cast):
        return Cast(sub(e.child), e.to)
    if isinstance(e, Case):
        return Case([(sub(c), sub(v)) for c, v in e.branches],
                    None if e.else_ is None else sub(e.else_))
    if isinstance(e, InList):
        return InList(sub(e.child), [sub(v) for v in e.values], e.negated)
    if isinstance(e, Like):
        return Like(sub(e.child), e.pattern, e.negated)
    if isinstance(e, ScalarFunc):
        return ScalarFunc(e.name, [sub(a) for a in e.args])
    if isinstance(e, GetIndexedField):
        return GetIndexedField(sub(e.child), e.index)
    if isinstance(e, GetMapValue):
        return GetMapValue(sub(e.child), e.key)
    if isinstance(e, GetStructField):
        return GetStructField(sub(e.child), e.name)
    if isinstance(e, NamedStruct):
        return NamedStruct(list(e.names), [sub(x) for x in e.exprs])
    return e  # literals


def projection_mapping(names, exprs) -> Dict[str, Expr]:
    """name -> expression (aliases stripped), to inline a projection."""
    return {n: (e.child if isinstance(e, Alias) else e) for n, e in zip(names, exprs)}


def _apply_mapping(groupings, aggs, pre, mapping):
    from .agg import AggFunction, GroupingExpr

    groupings = [GroupingExpr(substitute(g.expr, mapping), g.name) for g in groupings]
    aggs = [AggFunction(a.fn, None if a.expr is None else substitute(a.expr, mapping), a.name)
            for a in aggs]
    return groupings, aggs, None if pre is None else substitute(pre, mapping)


def _children_rewritten(plan, rewrite):
    """Apply ``rewrite`` to the root, then to every child top-down,
    replacing each in place; returns the new root."""
    def walk(node):
        for i, c in enumerate(list(node.children)):
            node.children[i] = rewrite(c)
            walk(node.children[i])

    plan = rewrite(plan)
    walk(plan)
    return plan


# ------------------------------------------------------- tiers 1-3


def fuse_stages(plan):
    """Tiers 1-3 (see the module docstring), in place below the root;
    returns the root.  A no-op with ``spark.blaze.fusion.enabled``
    false."""
    from .agg import AggExec, AggMode
    from .filter import FilterExec
    from .project import ProjectExec

    if not bool(conf.FUSION_ENABLE.get()):
        return plan
    plan = _drop_noop_exchanges(plan)

    def try_fuse(agg):
        if agg.mode != AggMode.PARTIAL:
            return agg
        groupings, aggs, pre = list(agg.groupings), list(agg.aggs), agg.pre_filter
        child = agg.children[0]
        changed = False
        while True:
            if isinstance(child, ProjectExec) and not child.host:
                groupings, aggs, pre = _apply_mapping(groupings, aggs, pre,
                                                      projection_mapping(child.names, child.exprs))
            elif isinstance(child, FilterExec) and not child.host:
                if child.project is not None:
                    # the projection's output names first, then the
                    # predicate over the filter's input
                    proj_exprs, proj_names = child.project
                    groupings, aggs, pre = _apply_mapping(groupings, aggs, pre,
                                                          projection_mapping(proj_names, proj_exprs))
                pre = child.predicate if pre is None else BinOp("and", child.predicate, pre)
            else:
                break
            child = child.children[0]
            changed = True
        if not changed:
            return agg
        return AggExec(child, AggMode.PARTIAL, groupings, aggs,
                       supports_partial_skipping=agg.supports_partial_skipping, pre_filter=pre)

    def try_fuse_fp(node):
        """Project(Filter(x)) or Filter(Project(x)) -> one FilterExec
        with a fused projection."""
        if (isinstance(node, ProjectExec) and not node.host and node._select_names is None
                and isinstance(node.children[0], FilterExec) and not node.children[0].host
                and node.children[0].project is None):
            f = node.children[0]
            return FilterExec(f.children[0], f.predicate, project=(list(node.exprs), list(node.names)))
        if (isinstance(node, FilterExec) and node.project is None and not node.host
                and isinstance(node.children[0], ProjectExec) and not node.children[0].host):
            proj = node.children[0]
            mapping = projection_mapping(proj.names, proj.exprs)
            return FilterExec(proj.children[0], substitute(node.predicate, mapping),
                              project=(list(proj.exprs), list(proj.names)))
        return node

    def walk(node):
        for i, c in enumerate(list(node.children)):
            walk(c)
            node.children[i] = try_fuse(c) if isinstance(c, AggExec) else try_fuse_fp(c)

    walk(plan)
    plan = try_fuse(plan) if isinstance(plan, AggExec) else try_fuse_fp(plan)
    return _fuse_final_sort(plan)


def _drop_noop_exchanges(plan):
    """Tier 2: an exchange into ONE partition from a child of ONE
    partition is a pass-through."""
    from ..parallel.exchange import NativeShuffleExchangeExec

    def rewrite(node):
        while (isinstance(node, NativeShuffleExchangeExec) and node.partitioning.num_partitions == 1
               and node.children[0].num_partitions() == 1):
            node = node.children[0]
        return node

    return _children_rewritten(plan, rewrite)


def _fuse_final_sort(plan):
    """Tier 3: ``Limit?(Sort(FINAL agg))`` -> the agg with
    ``post_sort``/``post_fetch``."""
    from ..exprs.compile import needs_host
    from .agg import AggExec, AggMode
    from .limit import LimitExec
    from .pruning import expr_columns
    from .sort import SortExec

    def rewrite(node):
        limit, sort = None, node
        if isinstance(node, LimitExec) and isinstance(node.children[0], SortExec):
            limit, sort = node.limit, node.children[0]
        if not isinstance(sort, SortExec):
            return node
        agg = sort.children[0]
        if not (isinstance(agg, AggExec) and agg.mode == AggMode.FINAL and agg.post_sort is None
                and not any(needs_host(f.expr) for f in sort.fields)):
            return node
        out_names = set(agg.schema.names)
        if not all(expr_columns(f.expr) <= out_names for f in sort.fields):
            return node
        fetch = sort.fetch
        if limit is not None:
            fetch = limit if fetch is None else min(fetch, limit)
        return AggExec(agg.children[0], agg.mode, agg.groupings, agg.aggs,
                       supports_partial_skipping=agg.supports_partial_skipping,
                       pre_filter=agg.pre_filter, post_sort=list(sort.fields), post_fetch=fetch)

    return _children_rewritten(plan, rewrite)


# ------------------------------------------------ tier 4: chains


def compose(fns):
    """One transform applying ``fns`` (bottom to top) in turn."""
    def fn(cols, num_rows):
        for f in fns:
            cols, num_rows = f(cols, num_rows)
        return cols, num_rows

    return fn


class BufferPartitionExec(ExecNode):
    """The child partition's batches concatenated on the device into
    one: the prelude of a fused chain whose bottom operator needs its
    whole partition in one batch (``trace_requires_buffer``, the
    window), the same concatenation that operator's own ``execute``
    does."""

    def __init__(self, child: ExecNode):
        super().__init__([child])

    @property
    def schema(self):
        return self.children[0].schema

    @property
    def preserves_ordering(self) -> bool:
        return True  # the batches in stream order

    def execute(self, partition: int, ctx) -> BatchStream:
        child_stream = self.children[0].execute(partition, ctx)

        def stream():
            buffered = list(child_stream)
            if not buffered:
                return
            merged = concat_batches(buffered)
            self._record_batch(merged)
            yield merged

        return stream()


class FusedStageExec(ExecNode):
    """A chain of traceable unary operators, bottom to top, run as one
    transform per batch: every intermediate stays on the device, and
    the live row count is read back once per batch when some operator
    of the chain changes it.  Itself traceable (the composition), so a
    fused shuffle write absorbs a collapsed chain whole."""

    def __init__(self, child: ExecNode, ops: List[ExecNode]):
        super().__init__([child])
        self.ops = list(ops)  # bottom -> top
        self._schema = self.ops[-1].schema
        self._changes_count = any(op.trace_changes_count for op in self.ops)
        fns = [op.trace_fn() for op in self.ops]
        assert all(fn is not None for fn in fns)
        self._fn = compose(fns)
        self.metrics.add("fused_stage_len", len(self.ops))

    @property
    def schema(self):
        return self._schema

    def trace_fn(self):
        return self._fn

    def trace_key(self):
        return ("fused_stage", tuple(op.trace_key() for op in self.ops))

    @property
    def trace_changes_count(self) -> bool:
        return self._changes_count

    @property
    def preserves_ordering(self) -> bool:
        return True

    def name(self) -> str:
        return f"FusedStageExec[{'+'.join(type(op).__name__ for op in self.ops)}]"

    def execute(self, partition: int, ctx) -> BatchStream:
        child_stream = self.children[0].execute(partition, ctx)

        def stream():
            for batch in child_stream:
                with self.metrics.timer("elapsed_compute"):
                    cols, n = self._fn(batch.columns, batch.num_rows)
                    if self._changes_count:
                        n = int(n)  # the chain's one read of the device
                if n == 0:
                    continue
                out = RecordBatch(self._schema, list(cols), n)
                cap = out.capacity
                if cap != bucket_capacity(cap):
                    # an expanding operator (generate: cap * M rows) left
                    # a capacity off the buckets: cut it to n's bucket
                    b = bucket_capacity(n)
                    out = RecordBatch(self._schema, [c.head(min(b, cap)).pad(b) for c in out.columns], n)
                self._record_batch(out)
                yield out

        return stream()


def traceable_chain_from(node):
    """The chain rule tiers 4 and 5 share: walk down consecutive unary
    operators that expose ``trace_fn``, stopping after one that needs
    its whole partition in one batch (``trace_requires_buffer``): that
    operator is the chain's bottom, fed by a
    :class:`BufferPartitionExec`.  Returns (the operators top down, the
    node below them, whether the chain needs the buffer)."""
    ops_top_down = []
    cur = node
    while len(cur.children) == 1 and cur.trace_fn() is not None:
        ops_top_down.append(cur)
        buffered = cur.trace_requires_buffer
        cur = cur.children[0]
        if buffered:
            return ops_top_down, cur, True
    return ops_top_down, cur, False


def fuse_traceable_chains(plan):
    """Tier 4: maximal runs (two or more operators, two or more doing
    device work) of traceable unary operators become FusedStageExec
    nodes.  After ``prune_columns``, which rebuilds the operators it
    knows and would not see through a fused node."""
    if not bool(conf.FUSION_ENABLE.get()):
        return plan

    def rewrite(node):
        ops, bottom, buffered = traceable_chain_from(node)
        if len(ops) >= 2 and sum(1 for o in ops if o.has_kernel) >= 2:
            return FusedStageExec(BufferPartitionExec(bottom) if buffered else bottom, list(reversed(ops)))
        return node

    return _children_rewritten(plan, rewrite)


# ------------------------------------------ tier 5: shuffle write


def fuse_shuffle_write(plan):
    """Tier 5: every hash-partitioned ``ShuffleWriterExec`` absorbs the
    traceable chain feeding it (``absorb_traceable_chain``)."""
    if not bool(conf.FUSION_ENABLE.get()):
        return plan
    from ..parallel.shuffle import ShuffleWriterExec

    def walk(node):
        if isinstance(node, ShuffleWriterExec):
            node.absorb_traceable_chain()
        for c in node.children:
            walk(c)

    walk(plan)
    return plan


def optimize_plan(plan):
    """THE task optimizer: ``fuse_stages -> prune_columns ->
    fuse_traceable_chains -> fuse_shuffle_write``, in this order
    (pruning rebuilds the operators it knows, so chains collapse after
    it; the shuffle write eats the collapsed chain, so it comes last).
    ``run_task`` and the in-process runs go through it.  With
    ``spark.blaze.fusion.enabled`` false only the pruning runs, as in
    the reference."""
    from .pruning import prune_columns

    return fuse_shuffle_write(fuse_traceable_chains(prune_columns(fuse_stages(plan))))
