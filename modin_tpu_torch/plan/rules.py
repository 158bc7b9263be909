"""The planner's rewrite rules: pure ``Plan -> Plan | None`` functions.

The port's counterpart of ``modin_tpu/plan/rules.py``.  Each rule takes a
plan root and returns a rewritten root, or ``None`` when it has nothing to
do.  :func:`optimize` applies the catalog to fixpoint under a bounded pass
budget (``MODIN_TPU_TORCH_PLAN_MAX_PASSES``), so a rule that keeps
"improving" forever cannot wedge a query.  Rules never mutate nodes;
rebuilding goes through :func:`modin_tpu_torch.plan.ir.transform`, which
preserves DAG sharing (a diamond stays one node).  The order is fixed and
every application is kept: the reference's cost-gated ordering belongs to
its optimizer, which the port does not have yet.

Catalog (in application order):

1. ``pushdown-filter``      — ``Filter(Project(x))`` / ``Filter(Map(x))``
   commute to ``Project(Filter(x))`` / ``Map(Filter(x))``: filters migrate
   toward the scan so every operator above them touches fewer rows.  Valid
   because projects/maps are row-preserving and the mask is an independent
   subtree (it never reads its consumer's output).
2. ``cse``                  — merges structurally identical subtrees into one
   shared node (the whole-tree generalization of ``lazy._linearize``'s
   diamond sharing); downstream, lowering computes each merged node once.
3. ``prune-columns``        — reverse-topological required-column analysis:
   each scan learns exactly which of its columns any consumer (including
   filter predicates reached through mask subtrees) will ever read.
4. ``pushdown-project-into-scan`` — converts the pruning annotation into the
   reader's own projection argument (``usecols`` for the text family), so
   dropped columns are never parsed, not merely never uploaded.
5. ``fuse-map-reduce``      — tags a reduce whose input is a map chain as
   fused: lowering keeps the maps as deferred ``LazyExpr`` columns and the
   reduction consumes them through ``run_fused``'s tail, one launch.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from modin_tpu_torch.plan.ir import (
    Filter,
    Map,
    PlanNode,
    Project,
    Reduce,
    Scan,
    Sort,
    structural_key,
    transform,
    walk,
)

#: Marker for "every column of this node is required".
ALL = object()


def push_filter_down(root: PlanNode) -> Optional[PlanNode]:
    """Commute filters below projects and maps (toward the scan)."""

    def fn(node: PlanNode) -> Optional[PlanNode]:
        if not isinstance(node, Filter):
            return None
        child, mask = node.children
        if isinstance(child, Project):
            return Project(
                Filter(child.children[0], mask),
                child.keys,
                child.numeric,
                child.out_hint,
            )
        if isinstance(child, Map) and len(child.children) == 1:
            # single-input maps commute trivially; multi-input maps would
            # need the filter replicated into every operand branch, which
            # multiplies gathers instead of saving them — leave those be
            return child.with_children((Filter(child.children[0], mask),))
        return None

    new_root, changes = transform(root, fn)
    return new_root if changes else None


def common_subexpression_elimination(root: PlanNode) -> Optional[PlanNode]:
    """Merge structurally identical subtrees into one shared node."""
    canonical: Dict[Any, PlanNode] = {}
    keys: dict = {}

    def fn(node: PlanNode) -> Optional[PlanNode]:
        key = structural_key(node, keys)
        seen = canonical.get(key)
        if seen is not None and seen is not node:
            return seen
        canonical[key] = node
        return None

    new_root, changes = transform(root, fn)
    return new_root if changes else None


def _required_columns(root: PlanNode) -> Dict[int, Any]:
    """Per-node required output columns: a set of labels, or ALL.

    Reverse-topological walk (parents before children); a node consumed by
    several parents gets the union of their demands.  The root's own output
    is observable, so it always requires ALL.
    """
    order = list(walk(root))  # children before parents
    order.reverse()
    req: Dict[int, Any] = {id(root): ALL}

    def add(node: PlanNode, needed: Any) -> None:
        cur = req.get(id(node))
        if cur is ALL or needed is ALL:
            req[id(node)] = ALL
        elif cur is None:
            req[id(node)] = set(needed)
        else:
            cur.update(needed)

    for node in order:
        needed = req.get(id(node), set())
        if isinstance(node, Project):
            if node.numeric:
                add(node.children[0], ALL)
            else:
                add(node.children[0], set(node.keys))
        elif isinstance(node, Filter):
            child, mask = node.children
            add(child, needed)
            add(mask, ALL)
        elif isinstance(node, Sort):
            keys = node.sort_columns
            keys = [keys] if not isinstance(keys, (list, tuple)) else list(keys)
            if needed is ALL:
                add(node.children[0], ALL)
            else:
                add(node.children[0], set(needed) | set(keys))
        else:
            # map / reduce / groupby_agg (and anything future): conservatively
            # demand every column of every input
            for child in node.children:
                add(child, ALL)
    return req


def prune_dead_columns(root: PlanNode) -> Optional[PlanNode]:
    """Annotate each scan with the columns its consumers actually read."""
    req = _required_columns(root)

    def fn(node: PlanNode) -> Optional[PlanNode]:
        if not isinstance(node, Scan) or node.pruned is not None:
            return None
        needed = req.get(id(node), ALL)
        if needed is ALL:
            return None
        keep = tuple(c for c in node.all_columns if c in needed)
        if len(keep) >= len(node.all_columns):
            return None
        return Scan(
            node.dispatcher, node.read_kwargs, node.all_columns, keep,
            node.colarg, origin=node.origin,
        )

    # NOTE: req was computed against the ORIGINAL node identities; transform
    # rebuilds bottom-up, but scans are leaves, so their identity at fn-time
    # is unchanged and the lookup stays valid.
    new_root, changes = transform(root, fn)
    return new_root if changes else None


def pushdown_projection_into_scan(root: PlanNode) -> Optional[PlanNode]:
    """Make the pruning annotation real: narrow the reader's projection.

    This rule is a no-op for scans whose kwargs the pushdown gate rejects
    (callable usecols, index_col, converters, ...) — those keep full-width
    parses and the plan above them still prunes post-parse.  The gate lives
    in :func:`modin_tpu_torch.plan.runtime.scan_supports_pushdown` so the
    deferral and pushdown decisions share one source of truth.
    """
    from modin_tpu_torch.plan.runtime import scan_supports_pushdown

    def fn(node: PlanNode) -> Optional[PlanNode]:
        if (
            isinstance(node, Scan)
            and node.pruned is not None
            and not node.pushed
            and scan_supports_pushdown(node)
        ):
            return Scan(
                node.dispatcher,
                node.read_kwargs,
                node.all_columns,
                node.pruned,
                node.colarg,
                pushed=True,
                origin=node.origin,
            )
        return None

    new_root, changes = transform(root, fn)
    return new_root if changes else None


def fuse_map_reduce(root: PlanNode) -> Optional[PlanNode]:
    """Tag reduces fed by map chains: the chain lowers as ONE fused program.

    Mechanically the fusion is carried out by ``ops/lazy.py``: lowering a
    map produces deferred ``LazyExpr`` columns, and the eager reduction
    consumes their ``raw`` forms through ``run_fused``'s tail.  The rule
    asserts the boundary in the IR (and in EXPLAIN output), counting how
    many map nodes ride into the reduction's program.
    """

    def fn(node: PlanNode) -> Optional[PlanNode]:
        if not isinstance(node, Reduce) or node.fused:
            return None
        chain = 0
        cursor = node.children[0]
        while isinstance(cursor, Map):
            chain += 1
            cursor = cursor.children[0]
        if chain == 0:
            return None
        return Reduce(node.children[0], node.method, node.call_kwargs, True, chain)

    new_root, changes = transform(root, fn)
    return new_root if changes else None


#: The ordered rule catalog: (name, rule).
RULES: Tuple[Tuple[str, Any], ...] = (
    ("pushdown-filter", push_filter_down),
    ("cse", common_subexpression_elimination),
    ("prune-columns", prune_dead_columns),
    ("pushdown-project-into-scan", pushdown_projection_into_scan),
    ("fuse-map-reduce", fuse_map_reduce),
)


def optimize(
    root: PlanNode, max_passes: Optional[int] = None
) -> Tuple[PlanNode, List[Tuple[str, int]]]:
    """Apply the rule catalog to fixpoint under the pass budget.

    Returns ``(optimized_root, applied)`` where ``applied`` lists
    ``(rule_name, pass_index)`` in application order: the per-rule
    attribution EXPLAIN renders.
    """
    if max_passes is None:
        from modin_tpu_torch.config import PlanMaxPasses

        max_passes = PlanMaxPasses.get()
    applied: List[Tuple[str, int]] = []
    for pass_index in range(max(int(max_passes), 1)):
        changed = False
        for name, rule in RULES:
            new_root = rule(root)
            if new_root is not None:
                root = new_root
                applied.append((name, pass_index))
                changed = True
        if not changed:
            break
    return root, applied
