"""Planner lowering: optimized plan -> eager ``TorchQueryCompiler``.

The port's counterpart of ``modin_tpu/plan/lowering.py``.  Every node lowers
through the seam the eager mode already uses: a scan calls the format
dispatcher's ``read`` (with the pushed-down ``usecols``), maps call the eager
compiler's methods (whose device paths build deferred ``LazyExpr`` columns),
filters ride ``getitem_array``, and reductions consume the lazy columns
through ``run_fused``'s tail; a reduce or groupby tail first offers its whole
segment to the masked fused leg (:mod:`modin_tpu_torch.plan.fuse`).

The walk memoizes per node id: a subtree shared between the filter mask and
the main spine (or merged by CSE) is computed once.  Each scan origin keeps a
cache of its materialized reads, one entry per projection, bounded in bytes
by ``MODIN_TPU_TORCH_PLAN_SCAN_CACHE_BYTES``.

A reduce or groupby tail is first offered to the out-of-core window loop
(:func:`_maybe_stream`, ``streaming/executor.py``): where its chain is one
streamable CSV scan that ``decide_residency`` judges larger than the device
ledger's headroom, the chain runs window by window and only the partials
combine.

With the plan optimizer on (``MODIN_TPU_TORCH_OPT=Auto``) each node's
lowering runs inside its node scope (``optimizer.push_node``: the router's
residency consult and the donation rule read the node's strategy), and its
wall goes back to ``optimizer.observe``, which may re-estimate the rest of
the query.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple

from modin_tpu_torch.concurrency import named_lock
from modin_tpu_torch.logging.metrics import emit_metric
from modin_tpu_torch.observability import compile_ledger as _ledger
from modin_tpu_torch.observability import costs as _costs
from modin_tpu_torch.observability import spans as _spans
from modin_tpu_torch.serving import context as serving_context
from modin_tpu_torch.plan.ir import (
    Filter,
    GroupbyAgg,
    Map,
    PlanNode,
    Project,
    Reduce,
    Ref,
    Scan,
    Sort,
    Source,
    count_nodes,
)

_tls = threading.local()

#: one lock for every origin's read cache (the parse itself runs outside it)
_SCAN_CACHE_LOCK = named_lock("plan.scan_cache")


def kernel_launches() -> int:
    """Launches of the port's CUDA kernels so far (each wrapper's count)."""
    from modin_tpu_torch.ops.cuda import fused_kernels, groupagg_kernels, groupby_kernels, scan_kernels

    return (fused_kernels.LAUNCHES + groupagg_kernels.LAUNCHES + groupby_kernels.LAUNCHES
            + scan_kernels.LAUNCHES)


def in_lowering() -> bool:
    """Whether a lowering pass runs on this thread (the Force-mode guards
    stay eager then: lowering replays plan nodes through the same guarded
    methods)."""
    return getattr(_tls, "lowering", False)


def lower(root: PlanNode) -> Any:
    """Lower an (optimized) plan to an eager query compiler."""
    return lower_traced(root)[0]


def lower_traced(root: PlanNode, instrument: Optional[Dict[int, dict]] = None,
                 strategies: Any = None) -> Tuple[Any, Dict[int, Any]]:
    """Lower a plan; also returns the node-id -> lowered-compiler memo.

    ``instrument`` (EXPLAIN ANALYZE) is filled in place with one entry per
    lowered node id: wall seconds (total and self), the kernel launches the
    node made, and the result's rows and bytes.  A shared subtree bills its
    first consumer, which is where the work happened.

    ``strategies`` (the optimizer's :class:`~.optimizer.PlanStrategies`,
    None under ``OptMode=Off``) arms the adaptive loop: each node's wall is
    measured (one ``perf_counter`` pair) and fed to ``optimizer.observe``.
    """
    from modin_tpu_torch.plan import optimizer

    memo: Dict[int, Any] = {}
    was_lowering = in_lowering()
    _tls.lowering = True
    if instrument is not None:
        _tls.instrument = instrument
        _tls.inst_stack = []
    if strategies is not None:
        optimizer.begin(strategies, root, memo)
        _tls.opt_active = True
    try:
        with _spans.span("plan.lower", "QUERY-COMPILER", nodes=count_nodes(root)):
            result = _lower(root, memo)
    finally:
        _tls.lowering = was_lowering
        if instrument is not None:
            _tls.instrument = None
            _tls.inst_stack = None
        if strategies is not None:
            _tls.opt_active = False
            optimizer.end()
    emit_metric("plan.lower.nodes", len(memo))
    return result, memo


def _lower(node: PlanNode, memo: Dict[int, Any]) -> Any:
    hit = memo.get(id(node))
    if hit is not None:
        return hit
    if serving_context.CONTEXT_ON:
        # between plan nodes is the cheapest safe place to abort a deferred
        # query: nothing is half-lowered
        serving_context.check_deadline("plan.lower")
    instrument = getattr(_tls, "instrument", None)
    opt_active = getattr(_tls, "opt_active", False)
    if instrument is None and not opt_active:
        return _lower_node(node, memo)
    from modin_tpu_torch.plan import optimizer

    if instrument is None:
        # the adaptive loop alone: the node's wall, observed once its scope
        # is popped and it is in the memo, so a re-plan leaves it out
        optimizer.push_node(node)
        t0 = time.perf_counter()
        try:
            result = _lower_node(node, memo)
        finally:
            optimizer.pop_node()
        optimizer.observe(node, time.perf_counter() - t0)
        return result
    if opt_active:
        optimizer.push_node(node)
    stack = _tls.inst_stack
    frame = {"child_s": 0.0, "child_launches": 0}
    stack.append(frame)
    t0 = time.perf_counter()
    l0 = kernel_launches()
    # one COST_ON read: both deltas or neither
    cost_on = _costs.COST_ON
    c0 = _costs.thread_cost() if cost_on else None
    p0 = _costs.thread_padding() if cost_on else None
    x0 = _costs.thread_collective() if cost_on else None
    acc = _ledger.push_device_acc() if cost_on else None
    try:
        result = _lower_node(node, memo)
    finally:
        _ledger.pop_device_acc(acc)
        stack.pop()
        if opt_active:
            optimizer.pop_node()
        total_s = time.perf_counter() - t0
        total_launches = kernel_launches() - l0
        if stack:
            stack[-1]["child_s"] += total_s
            stack[-1]["child_launches"] += total_launches
    if opt_active:
        optimizer.observe(node, total_s)
    entry = {
        "total_s": total_s,
        "self_s": max(total_s - frame["child_s"], 0.0),
        "launches": max(total_launches - frame["child_launches"], 0),
        "rows": _result_rows(result),
        "bytes": _result_bytes(result),
    }
    if c0 is not None:
        # the bytes and operations the node's launches (its subtree's, as
        # total_s) billed, and the padding it observed
        c1, p1 = _costs.thread_cost(), _costs.thread_padding()
        entry["est_flops"] = c1[0] - c0[0]
        entry["est_bytes"] = c1[1] - c0[1]
        entry["padded_bytes"] = p1[0] - p0[0]
        entry["padding_waste_bytes"] = p1[1] - p0[1]
        entry["collective_bytes"] = _costs.thread_collective() - x0
        if acc is not None:
            # the event times of the subtree's launches, once resolved
            entry["device"] = acc
    instrument[id(node)] = entry
    return result


def _result_rows(qc: Any) -> Optional[int]:
    frame = getattr(qc, "_frame", None)
    return len(frame) if frame is not None else None


def _result_bytes(qc: Any) -> Optional[int]:
    """Bytes held by a lowered compiler's concrete columns (deferred
    columns are skipped, never forced)."""
    frame = getattr(qc, "_frame", None)
    if frame is None:
        return None
    total = 0
    for col in frame._columns:
        if col.is_device:
            data = getattr(col, "_data", None)
            total += int(data.numel() * data.element_size()) if hasattr(data, "element_size") else 0
        else:
            total += int(getattr(col.data, "nbytes", 0) or 0)
    return total


def _lower_node(node: PlanNode, memo: Dict[int, Any]) -> Any:
    try:
        result = _LOWERERS[type(node)](node, memo)
    except Exception as exc:
        # deferral moves eager-mode errors from the call site to the
        # materialization point; name the failing node
        if not getattr(exc, "_plan_node", None) and exc.args and isinstance(exc.args[0], str):
            exc._plan_node = node.label()
            exc.args = (f"{exc.args[0]} [while materializing deferred plan node {node.label()}]",) + exc.args[1:]
        raise
    memo[id(node)] = result
    return result


def scan_read_kwargs(node: Scan) -> dict:
    """The reader kwargs of a scan, with the pushed projection merged in."""
    kwargs = dict(node.read_kwargs)
    if node.pushed and node.pruned is not None:
        keep = [c for c in node.all_columns if c in set(node.pruned)]
        kwargs[node.colarg] = keep
        dtype = kwargs.get("dtype")
        if isinstance(dtype, dict):
            kwargs["dtype"] = {k: v for k, v in dtype.items() if k in set(keep)}
    return kwargs


def _lower_scan(node: Scan, memo: Dict[int, Any]) -> Any:
    from modin_tpu_torch.config import PlanScanCacheBytes

    origin = node.origin
    need = tuple(node.columns) if node.pushed and node.pruned is not None else None
    # a prior read of this source that covers the need serves it: a scan
    # shared by several plans parses once per projection, not once a force
    hit = None
    with _SCAN_CACHE_LOCK:
        for key, cached in (origin.cache or {}).items():
            if (key is None and need is None) or (need is not None and (key is None or set(need) <= set(key))):
                hit = cached[0]
                break
    if hit is not None:
        emit_metric("plan.scan.cache_hit", 1)
        return hit if need is None else hit.getitem_column_array(list(need))
    if need is not None:
        emit_metric("plan.scan.pruned_columns", len(node.all_columns) - len(node.pruned))
    qc = node.dispatcher.read(**scan_read_kwargs(node))
    budget = int(PlanScanCacheBytes.get())
    if origin.cache is not None and budget > 0:
        nbytes = _result_bytes(qc) or 0
        evicted = 0
        with _SCAN_CACHE_LOCK:
            origin.cache[need] = (qc, nbytes)
            total = sum(b for _qc, b in origin.cache.values())
            while total > budget and origin.cache:
                _dropped, dropped_bytes = origin.cache.pop(next(iter(origin.cache)))
                total -= dropped_bytes
                evicted += 1
        if evicted:
            emit_metric("plan.scan.cache_evict", evicted)
    return qc


def _lower_source(node: Source, memo: Dict[int, Any]) -> Any:
    return node.qc


def _lower_project(node: Project, memo: Dict[int, Any]) -> Any:
    child = _lower(node.children[0], memo)
    qc = child.getitem_column_array(list(node.keys), numeric=node.numeric)
    if node.out_hint is not None:
        qc._shape_hint = node.out_hint
    return qc


def _lower_filter(node: Filter, memo: Dict[int, Any]) -> Any:
    child = _lower(node.children[0], memo)
    mask = _lower(node.children[1], memo)
    return child.getitem_array(mask)


def _lower_map(node: Map, memo: Dict[int, Any]) -> Any:
    receiver = _lower(node.children[0], memo)
    args = tuple(_lower(node.children[a.index], memo) if isinstance(a, Ref) else a for a in node.args)
    qc = getattr(receiver, node.method)(*args, **node.kwargs)
    if node.out_hint is not None:
        qc._shape_hint = node.out_hint
    return qc


def _maybe_stream(node: PlanNode, memo: Dict[int, Any], groupby: bool) -> Any:
    """The out-of-core hook of a Reduce or GroupbyAgg root: its windowed
    lowering where the chain below it is one streamable scan the residency
    router judges out-of-core, else None.  One attribute read while
    streaming is off (the default)."""
    from modin_tpu_torch import streaming

    if not streaming.STREAM_ON:
        return None
    if groupby:
        return streaming.maybe_stream_groupby(node, memo)
    return streaming.maybe_stream_reduce(node, memo)


def _lower_reduce(node: Reduce, memo: Dict[int, Any]) -> Any:
    from modin_tpu_torch.plan import fuse

    streamed = _maybe_stream(node, memo, groupby=False)
    if streamed is not None:
        return streamed
    fused = fuse.maybe_fuse(node, memo, groupby=False)
    if fused is not None:
        return fused
    child = _lower(node.children[0], memo)
    return getattr(child, node.method)(**node.call_kwargs)


def _lower_groupby(node: GroupbyAgg, memo: Dict[int, Any]) -> Any:
    from modin_tpu_torch.plan import fuse

    streamed = _maybe_stream(node, memo, groupby=True)
    if streamed is not None:
        return streamed
    fused = fuse.maybe_fuse(node, memo, groupby=True)
    if fused is not None:
        return fused
    child = _lower(node.children[0], memo)
    by = node.by
    if isinstance(by, Ref):
        by = _lower(node.children[by.index], memo)
    return child.groupby_agg(by, node.agg_func, **node.call_kwargs)


def _lower_sort(node: Sort, memo: Dict[int, Any]) -> Any:
    child = _lower(node.children[0], memo)
    return child.sort_rows_by_column_values(node.sort_columns, node.ascending, **node.call_kwargs)


_LOWERERS = {
    Scan: _lower_scan,
    Source: _lower_source,
    Project: _lower_project,
    Filter: _lower_filter,
    Map: _lower_map,
    Reduce: _lower_reduce,
    GroupbyAgg: _lower_groupby,
    Sort: _lower_sort,
}
