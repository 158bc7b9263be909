"""Whole-plan fusion: a plan segment and its reduction or groupby as masked
fused launches, with no compaction.

The port's counterpart of ``modin_tpu/plan/fuse.py``.  The staged lowering
replays each plan node through the eager seams: ``read_csv(p).query(...)
[cols].agg("sum")`` compacts the filtered rows (a gather of every surviving
column and a host sync for the kept count) and then reduces them.  Here the
whole post-scan segment, the filter/map/project chain and its reduce or
groupby tail, runs on the uncompacted rows:

- the filter's mask stays a deferred bool expression, and the reduction
  folds only the kept rows (``ops/reductions.reduce_columns_masked``: the
  masked tail of the fused kernel), so the filter, the map chain and the
  reduction are one launch (two for a moments op).  The kept values are the
  values a stable compaction would have gathered, in the same order;
- a groupby by an int or bool key runs as three launches: the probe (key
  min, key max and kept rows, three masked tails of one program), the fused
  launch that writes the slot column, and the ``groupagg`` kernel
  (``ops/groupby.fused_group_probe`` and ``fused_group_agg``);
- the route gate is the kernel router's ``decide_compile``
  (``ops/router.py``): ``MODIN_TPU_TORCH_FUSE`` pins a side, and below
  ``MODIN_TPU_TORCH_FUSE_MIN_ROWS`` rows a query stays staged.  Under Auto
  a groupby fuses only where :func:`decide_groupby` says so, the gate the
  eager ``groupby_reduce`` takes ``groupagg`` by too;
- buffer donation, under a ``DeviceMemoryBudget`` only: a scan column the
  device ledger proves has a sole consumer (:func:`_donation_candidates`)
  is dropped once the fused launch that reads it is enqueued, its exact
  host copy authoritative; a later read restores it
  (``ops/reductions._mark_and_run``, ``mark_donated``).  Unlike XLA, a
  torch launch does not write its output into a donated input, so
  donating only frees the scan's memory early; with no budget nothing
  needs that memory, and the next query on the frame would pay the
  host-to-device restore.  ``core/memory.COUNTS["fuse.donated"]``,
  ``["fuse.donated_bytes"]`` and ``["fuse.donated_restore"]`` count it.

A decline (a key range wider than ``FUSED_MAX_GROUPS``, tables Auto leaves
to the staged path, no kept row, an aggregation or a dtype the fused leg
does not take) is the planner's own decision: the staged lowering proceeds,
and ``DECLINES`` counts it (both also emitted, ``fuse.dispatch``/
``fuse.decline``; a leg is a ``fuse.lower`` span, and the pow2 group table's
padding is billed to the cost layer).

A streamed reduction's window body (``streaming/executor.py``) takes the
same masked leg a window at a time (:func:`window_reduce_plan`): a filtered
window's chain and its reduction are one masked launch, its gate
``decide_compile`` on the first window's rows.  A plan whose residency the
optimizer planned windowed never takes the whole-plan leg and never
donates (the joint constraints, ``plan/optimizer.py``).

Not ported yet: the storm feedback and pad buckets (the launch ledger now
names the signatures that lower often, ``recompile_storms``; the feedback
that re-buckets them waits; the reference's ``stream_bucket`` feeds pad
buckets the port's unpadded windows do not have) and the serving
context's donation rule (with ``serving/``); ROADMAP lists where each
waits.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import pandas

from modin_tpu_torch.logging.metrics import emit_metric
from modin_tpu_torch.observability import costs as _costs
from modin_tpu_torch.observability import spans as _spans
from modin_tpu_torch.ops import router
from modin_tpu_torch.ops.route import decide_groupby  # noqa: F401  (the groupby gate of both legs)
from modin_tpu_torch.plan.ir import Filter, GroupbyAgg, Map, PlanNode, Project, Reduce, Ref, Scan, Source, walk

#: fused legs taken (one per materialized segment) and declined
DISPATCHES = 0
DECLINES = 0

#: reductions the masked tail expresses exactly (median needs a
#: data-dependent selection)
SUPPORTED_REDUCE = frozenset(
    {"sum", "prod", "mean", "min", "max", "count", "var", "std", "sem", "skew", "kurt", "any", "all"}
)

#: Map methods the masked walk may replay (each stays a deferred LazyExpr)
_SUPPORTED_MAP_METHODS = frozenset(
    {
        "add", "radd", "sub", "rsub", "mul", "rmul", "truediv", "rtruediv",
        "floordiv", "rfloordiv", "mod", "rmod", "pow", "rpow",
        "eq", "ne", "lt", "le", "gt", "ge",
        "__and__", "__or__", "__xor__", "__rand__", "__ror__", "__rxor__",
        "abs", "negative", "invert", "isna", "notna",
    }
)


def _donation_candidates(frame: Any) -> List[Any]:
    """The leaf frame's columns whose tensors a fused launch may consume,
    under a device budget: each donation-eligible (concrete, its own
    length, an exact host copy) and, by one read of the device ledger for
    the batch, the sole holder of its storage."""
    from modin_tpu_torch.core import memory
    from modin_tpu_torch.plan import optimizer

    if memory.device_ledger.budget() is None or not optimizer.donate_ok():
        return []
    candidates = [c for c in frame._columns if c.is_device and c.donation_eligible()]
    if not candidates:
        return []
    counts = memory.device_ledger.buffer_consumer_counts([c._data for c in candidates])
    return [c for c in candidates if counts.get(memory.storage_key(c._data), 0) == 1]


class _Decline(Exception):
    """This segment cannot fuse; the staged lowering proceeds."""


def _segment_leaf(root: PlanNode) -> Optional[PlanNode]:
    """The one Scan/Source leaf under a pure Project/Filter/Map interior
    (the root itself excepted), or None when the shape cannot fuse."""
    leaf = None
    for node in walk(root):
        if isinstance(node, (Scan, Source)):
            if leaf is not None and node is not leaf:
                return None
            leaf = node
        elif node is root:
            continue
        elif isinstance(node, Map):
            if node.method not in _SUPPORTED_MAP_METHODS:
                return None
        elif not isinstance(node, (Project, Filter)):
            return None
    return leaf


def _walk_masked(node: PlanNode, memo: Dict[int, Any], masked: Dict[int, Any]):
    """(unfiltered eager compiler, accumulated keep mask or None) of a node.

    Projects and Maps run through the same eager methods as the staged
    lowering (their device paths build deferred expressions), but a Filter
    never compacts: its mask, a deferred bool expression, is AND-ed into the
    accumulated keep mask and the child's columns stay full-length.  Valid
    because every interior op is elementwise.  Shared nodes memoize, which
    also makes the mask identity checks sound.
    """
    hit = masked.get(id(node))
    if hit is not None:
        return hit
    if isinstance(node, (Scan, Source)):
        from modin_tpu_torch.plan import lowering

        result = (lowering._lower(node, memo), None)
    elif isinstance(node, Project):
        child, mask = _walk_masked(node.children[0], memo, masked)
        qc = child.getitem_column_array(list(node.keys), numeric=node.numeric)
        if node.out_hint is not None:
            qc._shape_hint = node.out_hint
        result = (qc, mask)
    elif isinstance(node, Map):
        receiver, mask = _walk_masked(node.children[0], memo, masked)
        args = []
        for a in node.args:
            if isinstance(a, Ref):
                operand, operand_mask = _walk_masked(node.children[a.index], memo, masked)
                if operand_mask is not mask:
                    raise _Decline("operand filter mismatch")
                args.append(operand)
            else:
                args.append(a)
        qc = getattr(receiver, node.method)(*args, **node.kwargs)
        if node.out_hint is not None:
            qc._shape_hint = node.out_hint
        result = (qc, mask)
    elif isinstance(node, Filter):
        child, mask = _walk_masked(node.children[0], memo, masked)
        mask_qc, mask_below = _walk_masked(node.children[1], memo, masked)
        if mask_below is not mask:
            raise _Decline("mask filter mismatch")
        mframe = mask_qc._modin_frame
        if mframe.num_cols != 1:
            raise _Decline("non-column mask")
        mcol = mframe._columns[0]
        if not mcol.is_device or mcol.pandas_dtype != np.dtype(bool):
            raise _Decline("mask not a device bool column")
        from modin_tpu_torch.ops.lazy import lazy_op

        result = (child, mcol.raw if mask is None else lazy_op("__and__", mask, mcol.raw))
    else:
        raise _Decline(f"unsupported node {node.kind}")
    masked[id(node)] = result
    return result


def maybe_fuse(node: PlanNode, memo: Dict[int, Any], groupby: bool) -> Optional[Any]:
    """The fused leg of a Reduce or GroupbyAgg root, or None for staged."""
    global DISPATCHES, DECLINES
    if groupby:
        if isinstance(node.by, Ref) or not _gate_groupby_kwargs(node):
            return None
    elif node.method not in SUPPORTED_REDUCE:
        return None
    leaf = _segment_leaf(node)
    if leaf is None:
        return None
    from modin_tpu_torch.plan import lowering, optimizer

    if optimizer.planned_compile() == "staged":
        return None  # a windowed residency's joint constraint
    frame = lowering._lower(leaf, memo)._modin_frame
    n = len(frame)
    if router.decide_compile(node.label(), n) != "fused":
        return None
    if n == 0 or not all(c.is_device for c in frame._columns):
        return None  # pandas' empty and object answers live with the staged path
    try:
        qc_top, mask = _walk_masked(node.children[0], memo, {})
    except _Decline:
        DECLINES += 1
        emit_metric("fuse.decline", 1)
        return None
    donate_cols = _donation_candidates(frame)
    with _spans.span("fuse.lower", "QUERY-COMPILER", signature=node.label(), rows=n,
                     donated=len(donate_cols)) as sp:
        if groupby:
            result = _fused_groupby(node, qc_top, mask, n, donate_cols)
        else:
            result = _fused_reduce(node, qc_top, mask, donate_cols)
        if sp is not None:
            sp.attrs["fused"] = result is not None
    if result is None:
        DECLINES += 1
        emit_metric("fuse.decline", 1)
        return None
    DISPATCHES += 1
    emit_metric("fuse.dispatch", 1)
    return result


def window_reduce_plan(node: Reduce, scan_node: Any, call_kwargs: dict):
    """The per-stream part of a streamed reduction's fused window body, or
    None where the chain can never fuse.

    Returns ``run(window_qc) -> reduced compiler | None``: one window's
    chain and its reduction as one masked launch (no compaction).  The
    stream-invariant gates (the segment's shape, the kwargs) are computed
    once here, the route verdict on the first window; ``run`` answers None
    for an unfiltered window (the staged body is one launch already), a
    window with a host column, or a declined walk, and the staged body
    runs."""
    if node.method not in SUPPORTED_REDUCE or _segment_leaf(node) is None:
        return None
    kwargs = dict(call_kwargs)
    axis = kwargs.pop("axis", 0)
    skipna = kwargs.pop("skipna", True)
    numeric_only = kwargs.pop("numeric_only", False)
    if axis not in (0, None):
        return None
    # the windows share one size (the last one is smaller), so the route
    # is decided on the first and kept
    verdict: List[bool] = []

    def run(window_qc: Any) -> Optional[Any]:
        global DISPATCHES
        frame = window_qc._modin_frame
        n = len(frame)
        if not verdict:
            verdict.append(router.decide_compile(node.label(), n) == "fused")
        if not verdict[0] or n == 0 or not all(c.is_device for c in frame._columns):
            return None
        try:
            qc_top, mask = _walk_masked(node.children[0], {id(scan_node): window_qc}, {})
        except _Decline:
            return None
        if mask is None:
            return None
        with _spans.span("fuse.lower", "QUERY-COMPILER", signature=node.label(), rows=n, donated=0):
            result = qc_top._try_device_reduce(node.method, axis, skipna, numeric_only, dict(kwargs), keep=mask)
        if result is not None:
            DISPATCHES += 1
            emit_metric("fuse.dispatch", 1)
        return result

    return run


def _fused_reduce(node: Reduce, qc_top: Any, mask: Any, donate_cols: List[Any]) -> Optional[Any]:
    kwargs = dict(node.call_kwargs)
    axis = kwargs.pop("axis", 0)
    skipna = kwargs.pop("skipna", True)
    numeric_only = kwargs.pop("numeric_only", False)
    if axis not in (0, None):
        return None
    return qc_top._try_device_reduce(node.method, axis, skipna, numeric_only, kwargs, keep=mask,
                                     donate_cols=donate_cols)


def _gate_groupby_kwargs(node: GroupbyAgg) -> bool:
    """Whether this groupby is the fused path's exact semantics: axis 0,
    as_index and sort, one string aggregation of ``FUSED_GROUPBY_AGGS``
    over one label key."""
    from modin_tpu_torch.ops.groupby import FUSED_GROUPBY_AGGS

    if not isinstance(node.agg_func, str) or node.agg_func not in FUSED_GROUPBY_AGGS:
        return False
    by = node.by
    if isinstance(by, (list, tuple)):
        if len(by) != 1 or not isinstance(by[0], str):
            return False
    elif not isinstance(by, str):
        return False
    ck = node.call_kwargs
    if ck.get("axis", 0) not in (0, None):
        return False
    if ck.get("agg_args") or ck.get("series_groupby") or ck.get("selection") is not None:
        return False
    if ck.get("how", "axis_wise") != "axis_wise":
        return False
    gk = ck.get("groupby_kwargs") or {}
    if not set(gk) <= {"as_index", "sort", "dropna", "observed", "group_keys", "level"}:
        return False
    if gk.get("level") is not None or not gk.get("as_index", True) or not gk.get("sort", True):
        return False
    ak = ck.get("agg_kwargs") or {}
    if not set(ak) <= {"numeric_only", "min_count"} or ak.get("min_count", 0) not in (0, -1):
        return False
    return True


def _fused_groupby(node: GroupbyAgg, qc_top: Any, mask: Any, n: int, donate_cols: List[Any]) -> Optional[Any]:
    from modin_tpu_torch.ops import groupby as gb

    agg = node.agg_func
    by = node.by if isinstance(node.by, str) else node.by[0]
    frame = qc_top._modin_frame
    columns = list(frame.columns)
    if columns.count(by) != 1:
        return None
    key_pos = columns.index(by)
    key_col = frame._columns[key_pos]
    if not key_col.is_device or key_col.pandas_dtype.kind not in "iub":
        return None
    numeric_only = (node.call_kwargs.get("agg_kwargs") or {}).get("numeric_only", False)
    value_pos = []
    for i, col in enumerate(frame._columns):
        if i == key_pos:
            continue
        if not col.is_device or col.pandas_dtype.kind not in "iufb" or col.pandas_dtype == np.float16:
            if numeric_only and col.pandas_dtype.kind not in "iufb":
                continue  # numeric_only drops it, as the staged path does
            return None
        value_pos.append(i)
    if not value_pos or len(value_pos) > 32:
        return None
    kmin, kmax, kept = gb.fused_group_probe(key_col.raw, mask, n)
    if kept == 0:
        return None
    width = kmax - kmin + 1
    if width > gb.FUSED_MAX_GROUPS:
        return None
    buckets = gb.fused_groups_bucket(width)
    if _costs.COST_ON:
        # the group table's slots rounded up to a power of two: one count
        # row and two rows a value column, 8 bytes a slot
        rows = 1 + 2 * len(value_pos)
        _costs.note_padding("fuse.groupby.slots", rows * (buckets + 1) * 8, rows * (width + 1) * 8)
    any_float = any(frame._columns[i].pandas_dtype.kind == "f" for i in value_pos)
    if not decide_groupby(n, buckets + 1, agg, len(value_pos), any_float):
        return None
    sizes, tables, _counts = gb.fused_group_agg(
        agg, key_col.raw, [frame._columns[i].raw for i in value_pos], mask, n, kmin, buckets, donate_cols
    )
    observed = np.nonzero(sizes[:buckets] > 0)[0]
    keys = (kmin + observed).astype(key_col.pandas_dtype)
    data = {}
    for pos, table in zip(value_pos, tables):
        values = np.asarray(table[:buckets])[observed]
        dtype = frame._columns[pos].pandas_dtype
        out = gb.fused_groupby_dtype(agg, dtype, values)
        if out.kind == "u" and values.dtype == np.int64:
            data[columns[pos]] = values.view(np.uint64).astype(out)
        else:
            data[columns[pos]] = values.astype(out)
    result = pandas.DataFrame(data, index=pandas.Index(keys, name=by), columns=[columns[i] for i in value_pos])
    return type(qc_top).from_pandas(result, qc_top._device())
