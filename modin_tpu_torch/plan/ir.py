"""The planner's logical-plan IR: immutable operator nodes over a shared DAG.

The port's copy of ``modin_tpu/plan/ir.py`` (it holds no device code).
Nodes are cheap metadata shells: no node touches device data or reads a
file.  Children are held by reference, so a subtree shared between two
consumers (the filter mask's predicate branch and the main spine both
hanging off one scan) is ONE node, and lowering computes it once.  Rewrites
(:mod:`modin_tpu_torch.plan.rules`) never mutate nodes in place; they
rebuild the spine with :func:`transform`, which memoizes by identity so
sharing survives every rewrite pass.

Schema answers (``columns``, ``known_dtypes``) are derived from the leaves,
so a deferred compiler can answer metadata questions without forcing the
plan; anything the IR cannot answer exactly (scan dtypes, which need a full
parse) returns ``None`` and the caller materializes instead.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import pandas

#: Longest plan chain the deferral guards build before materializing (the
#: planner's analogue of ``ops/lazy.py``'s ``_MAX_NODES``): keeps rewrite and
#: lowering recursion bounded and plan rewrites cheap.
MAX_PLAN_DEPTH = 160


#: Sentinel for "this argument position is the i-th plan child" inside a
#: :class:`Map` node's argument template.
class Ref:
    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index

    def __repr__(self) -> str:
        return f"Ref({self.index})"


class PlanNode:
    """Base class: one logical operator; ``children`` are data-flow inputs.

    ``depth`` is the longest root-to-leaf path, maintained at construction:
    the deferral guards decline to extend a plan past
    :data:`MAX_PLAN_DEPTH` (materializing instead), which also bounds every
    recursive walk (transform, structural_key, lowering, explain) well inside
    Python's recursion limit.
    """

    kind = "node"
    __slots__ = ("children", "depth")

    def __init__(self, children: Tuple["PlanNode", ...] = ()):
        self.children = tuple(children)
        self.depth = 1 + max((c.depth for c in self.children), default=0)

    # -- schema ---------------------------------------------------------- #

    @property
    def columns(self) -> pandas.Index:
        """Output column labels (exact, derived from the leaves)."""
        raise NotImplementedError

    def known_dtypes(self) -> Optional[pandas.Series]:
        """Exact output dtypes, or None when only a full parse could know."""
        return None

    def row_key(self) -> Any:
        """Row-lineage token: two nodes with equal row keys are guaranteed
        positionally aligned (same source rows in the same order)."""
        return self.children[0].row_key()

    # -- structure ------------------------------------------------------- #

    def with_children(self, children: Tuple["PlanNode", ...]) -> "PlanNode":
        """Rebuild this node over new children, preserving the payload."""
        raise NotImplementedError

    def payload_key(self) -> Any:
        """Hashable payload identity (children excluded) for CSE."""
        return ()

    def label(self) -> str:
        """One-line description for EXPLAIN rendering."""
        return self.kind


class Scan(PlanNode):
    """A deferred file read: dispatcher + original kwargs + column metadata.

    ``all_columns`` is the post-``usecols`` column set learned by the cheap
    header sniff at defer time; ``pruned`` (set by the pushdown rule) is the
    subset that actually needs parsing, kept in file order.  ``colarg`` names
    the reader kwarg that carries the projection ("usecols" for the text
    family, "columns" for parquet-shaped dispatchers).
    """

    kind = "scan"
    __slots__ = (
        "dispatcher", "read_kwargs", "all_columns", "pruned", "colarg",
        "pushed", "origin", "cache",
    )

    def __init__(
        self,
        dispatcher: type,
        read_kwargs: dict,
        all_columns: pandas.Index,
        pruned: Optional[Tuple] = None,
        colarg: str = "usecols",
        pushed: bool = False,
        origin: Optional["Scan"] = None,
    ):
        super().__init__(())
        self.dispatcher = dispatcher
        self.read_kwargs = read_kwargs
        self.all_columns = all_columns
        self.pruned = tuple(pruned) if pruned is not None else None
        self.colarg = colarg
        self.pushed = pushed
        # rewrites produce fresh (pruned) Scan objects per materialization;
        # ``origin`` anchors them to the node the user's pending plans hold,
        # and ``cache`` (on the origin) memoizes lowered reads so a source
        # shared by several plans/materializations parses once per
        # projection, never once per force()
        self.origin = origin if origin is not None else self
        self.cache = {} if origin is None else None

    @property
    def columns(self) -> pandas.Index:
        if self.pruned is None:
            return self.all_columns
        keep = set(self.pruned)
        return pandas.Index([c for c in self.all_columns if c in keep])

    def row_key(self) -> Any:
        return ("scan", id(self))

    def with_children(self, children) -> "Scan":
        return self

    def label(self) -> str:
        path = self.read_kwargs.get("filepath_or_buffer") or self.read_kwargs.get(
            "path", "?"
        )
        cols = (
            f"{len(self.pruned)}/{len(self.all_columns)} cols (pruned"
            + (f", {self.colarg} pushed into reader)" if self.pushed else ")")
            if self.pruned is not None
            else f"{len(self.all_columns)} cols"
        )
        return f"scan[{self.dispatcher.__name__}] {path} [{cols}]"


class Source(PlanNode):
    """A leaf wrapping an already-materialized eager query compiler."""

    kind = "source"
    __slots__ = ("qc",)

    def __init__(self, qc: Any):
        super().__init__(())
        self.qc = qc

    @property
    def columns(self) -> pandas.Index:
        return self.qc.get_columns()

    def known_dtypes(self) -> Optional[pandas.Series]:
        return self.qc.dtypes

    def row_key(self) -> Any:
        return ("source", id(self.qc))

    def with_children(self, children) -> "Source":
        return self

    def label(self) -> str:
        return f"source[{len(self.columns)} cols]"


class Project(PlanNode):
    """Column selection/reordering: ``child[labels]`` (or positions)."""

    kind = "project"
    __slots__ = ("keys", "numeric", "out_hint")

    def __init__(
        self,
        child: PlanNode,
        keys: Tuple,
        numeric: bool = False,
        out_hint: Optional[str] = None,
    ):
        super().__init__((child,))
        self.keys = tuple(keys)
        self.numeric = numeric
        self.out_hint = out_hint

    @property
    def columns(self) -> pandas.Index:
        if self.numeric:
            return self.children[0].columns[list(self.keys)]
        return pandas.Index(list(self.keys))

    def known_dtypes(self) -> Optional[pandas.Series]:
        child = self.children[0].known_dtypes()
        if child is None:
            return None
        if self.numeric:
            return child.iloc[list(self.keys)]
        return child.loc[list(self.keys)]

    def with_children(self, children) -> "Project":
        return Project(children[0], self.keys, self.numeric, self.out_hint)

    def payload_key(self) -> Any:
        return (self.keys, self.numeric, self.out_hint)

    def label(self) -> str:
        keys = list(self.keys)
        shown = keys if len(keys) <= 6 else keys[:6] + ["..."]
        return f"project{shown}"


class Filter(PlanNode):
    """Row selection by a boolean-mask subplan: ``child[mask]``.

    ``children == (child, mask)``; the mask is a full plan subtree (usually
    sharing the child's scan — the diamond CSE generalizes).
    """

    kind = "filter"
    __slots__ = ()

    def __init__(self, child: PlanNode, mask: PlanNode):
        super().__init__((child, mask))

    @property
    def columns(self) -> pandas.Index:
        return self.children[0].columns

    def known_dtypes(self) -> Optional[pandas.Series]:
        return self.children[0].known_dtypes()

    def row_key(self) -> Any:
        return ("filter", id(self))

    def with_children(self, children) -> "Filter":
        return Filter(children[0], children[1])

    def label(self) -> str:
        return "filter"


class Map(PlanNode):
    """A length-preserving elementwise op: one query-compiler method call.

    ``method`` is the eager QC method to invoke at lowering (``gt``, ``add``,
    ``unary_math``, ``abs``, ...); ``args``/``kwargs`` are the call template,
    with :class:`Ref` placeholders standing for lowered plan children.
    ``children[0]`` is the receiver; further children are operand subplans.
    """

    kind = "map"
    __slots__ = ("method", "args", "kwargs", "out_columns", "bool_out", "out_hint")

    def __init__(
        self,
        children: Tuple[PlanNode, ...],
        method: str,
        args: Tuple = (),
        kwargs: Optional[dict] = None,
        out_columns: Optional[pandas.Index] = None,
        bool_out: bool = False,
        out_hint: Optional[str] = None,
    ):
        super().__init__(children)
        self.method = method
        self.args = tuple(args)
        self.kwargs = dict(kwargs or {})
        self.out_columns = (
            out_columns if out_columns is not None else children[0].columns
        )
        self.bool_out = bool_out
        self.out_hint = out_hint

    @property
    def columns(self) -> pandas.Index:
        return self.out_columns

    def known_dtypes(self) -> Optional[pandas.Series]:
        if self.bool_out:
            return pandas.Series(
                [np.dtype(bool)] * len(self.out_columns), index=self.out_columns
            )
        return None

    def with_children(self, children) -> "Map":
        return Map(
            children,
            self.method,
            self.args,
            self.kwargs,
            self.out_columns,
            self.bool_out,
            self.out_hint,
        )

    def payload_key(self) -> Any:
        def arg_key(a):
            if isinstance(a, Ref):
                return ("ref", a.index)
            return (type(a).__name__, repr(a))

        return (
            self.method,
            tuple(arg_key(a) for a in self.args),
            tuple(sorted((k, repr(v)) for k, v in self.kwargs.items())),
            tuple(self.out_columns),
            self.bool_out,
            self.out_hint,
        )

    def label(self) -> str:
        shown = [
            f"${a.index}" if isinstance(a, Ref) else repr(a) for a in self.args
        ]
        return f"map:{self.method}({', '.join(shown)})"


class Reduce(PlanNode):
    """An axis reduction — a materialization point in the deferred mode.

    ``fused`` is set by the map->reduce fusion rule: the maps below stay
    deferred ``LazyExpr`` columns and the reduction consumes them through
    ``run_fused``'s tail, one launch of the fused kernel for the chain.
    """

    kind = "reduce"
    __slots__ = ("method", "call_kwargs", "fused", "fused_maps")

    def __init__(
        self,
        child: PlanNode,
        method: str,
        call_kwargs: dict,
        fused: bool = False,
        fused_maps: int = 0,
    ):
        super().__init__((child,))
        self.method = method
        self.call_kwargs = dict(call_kwargs)
        self.fused = fused
        self.fused_maps = fused_maps

    @property
    def columns(self) -> pandas.Index:
        # reductions collapse the axis; the lowered eager result carries the
        # real labels, which depend on dtype selection we don't predict here
        return self.children[0].columns

    def with_children(self, children) -> "Reduce":
        return Reduce(
            children[0], self.method, self.call_kwargs, self.fused, self.fused_maps
        )

    def payload_key(self) -> Any:
        return (
            self.method,
            tuple(sorted((k, repr(v)) for k, v in self.call_kwargs.items())),
            self.fused,
        )

    def label(self) -> str:
        tag = f" (fused over {self.fused_maps} maps)" if self.fused else ""
        return f"reduce:{self.method}{tag}"


class GroupbyAgg(PlanNode):
    """A groupby aggregation — also a materialization point.

    ``by`` is either a label list or a :class:`Ref` into ``children`` when
    the grouper is itself a deferred subplan.
    """

    kind = "groupby_agg"
    __slots__ = ("by", "agg_func", "call_kwargs")

    def __init__(
        self,
        children: Tuple[PlanNode, ...],
        by: Any,
        agg_func: Any,
        call_kwargs: dict,
    ):
        super().__init__(children)
        self.by = by
        self.agg_func = agg_func
        self.call_kwargs = dict(call_kwargs)

    @property
    def columns(self) -> pandas.Index:
        return self.children[0].columns

    def with_children(self, children) -> "GroupbyAgg":
        return GroupbyAgg(children, self.by, self.agg_func, self.call_kwargs)

    def payload_key(self) -> Any:
        return (
            repr(self.by),
            repr(self.agg_func),
            tuple(sorted((k, repr(v)) for k, v in self.call_kwargs.items())),
        )

    def label(self) -> str:
        by = f"${self.by.index}" if isinstance(self.by, Ref) else self.by
        return f"groupby_agg[by={by}, agg={self.agg_func}]"


class Sort(PlanNode):
    """Row reordering by column values (deferred; changes row lineage)."""

    kind = "sort"
    __slots__ = ("sort_columns", "ascending", "call_kwargs")

    def __init__(
        self, child: PlanNode, sort_columns: Any, ascending: Any, call_kwargs: dict
    ):
        super().__init__((child,))
        self.sort_columns = sort_columns
        self.ascending = ascending
        self.call_kwargs = dict(call_kwargs)

    @property
    def columns(self) -> pandas.Index:
        return self.children[0].columns

    def known_dtypes(self) -> Optional[pandas.Series]:
        return self.children[0].known_dtypes()

    def row_key(self) -> Any:
        return ("sort", id(self))

    def with_children(self, children) -> "Sort":
        return Sort(children[0], self.sort_columns, self.ascending, self.call_kwargs)

    def payload_key(self) -> Any:
        return (
            repr(self.sort_columns),
            repr(self.ascending),
            tuple(sorted((k, repr(v)) for k, v in self.call_kwargs.items())),
        )

    def label(self) -> str:
        return f"sort[{self.sort_columns}]"


# ---------------------------------------------------------------------- #
# DAG utilities
# ---------------------------------------------------------------------- #


def walk(root: PlanNode):
    """Yield every distinct node once, children before parents (postorder)."""
    seen = set()
    stack = [(root, False)]
    while stack:
        node, expanded = stack.pop()
        if id(node) in seen:
            continue
        if expanded:
            seen.add(id(node))
            yield node
        else:
            stack.append((node, True))
            for child in node.children:
                if id(child) not in seen:
                    stack.append((child, False))


def count_nodes(root: PlanNode) -> int:
    return sum(1 for _ in walk(root))


def transform(root: PlanNode, fn) -> Tuple[PlanNode, int]:
    """Rebuild the DAG bottom-up through ``fn``, preserving sharing.

    ``fn(node) -> PlanNode | None`` is called on each node AFTER its children
    have been rebuilt; None keeps the node.  Returns (new_root, change_count).
    Identity-memoized: a shared subtree is visited and rebuilt exactly once,
    so diamonds stay diamonds.
    """
    memo: dict = {}
    changes = 0

    def rebuild(node: PlanNode) -> PlanNode:
        nonlocal changes
        hit = memo.get(id(node))
        if hit is not None:
            return hit
        new_children = tuple(rebuild(c) for c in node.children)
        rebuilt = (
            node
            if all(a is b for a, b in zip(new_children, node.children))
            else node.with_children(new_children)
        )
        replaced = fn(rebuilt)
        if replaced is not None and replaced is not rebuilt:
            changes += 1
            rebuilt = replaced
        memo[id(node)] = rebuilt
        return rebuilt

    return rebuild(root), changes


def structural_key(root: PlanNode, memo: Optional[dict] = None) -> Any:
    """Structural identity of a subtree (leaves keyed by object identity).

    Two subtrees with equal keys compute the same values over the same
    source rows — the CSE merge criterion.
    """
    if memo is None:
        memo = {}
    # the memo holds (node, key), keeping the node alive: a bare id->key
    # map is an id-reuse hazard (a dropped intermediate node's id can be
    # recycled by a new node mid-rewrite and inherit the stale key)
    hit = memo.get(id(root))
    if hit is not None and hit[0] is root:
        return hit[1]
    if root.children:
        tail = tuple(structural_key(c, memo) for c in root.children)
    else:
        tail = ("leaf", id(root))
    key = (root.kind, root.payload_key(), tail)
    memo[id(root)] = (root, key)
    return key
