"""The streaming window loop and its algebraic recombiners.

The port's counterpart of ``modin_tpu/streaming/executor.py``.  The
planner's Reduce and GroupbyAgg lowerers call :func:`maybe_stream_reduce`
and :func:`maybe_stream_groupby` (``plan/lowering._maybe_stream``): where
the plan is a linear ``scan -> filter/map/project`` chain over one
streamable source that ``decide_residency`` judges out-of-core, the chain
runs once **per window**, the lowering memo seeded with the window's
compiler (so pushdown, pruning and the device paths apply unchanged), and
only the window's partial aggregate survives its release.

:func:`window_loop` pipelines: a prefetch thread parses window ``i+1``'s
byte range and uploads it through ``TorchWrapper.put`` while the caller's
thread consumes window ``i``; the window size already reserves ``1 +
prefetch`` windows under the budget.  The upload runs on the worker's
current CUDA stream, the device's default stream, as the consumer's
kernels do: the two serialize on the card, and what overlaps is the parse
(pandas' C parser releases the interpreter lock) and the host side of the
upload.  A device failure the seams did not absorb inside one window
replays that window alone (``stream.window.replay``): its byte range is
parsed again and the chain runs again, never the dataset.

Recombination: sums, counts, min, max and products combine per partial, a
mean as (sum, count) pairs.  A float sum associates per window, so it
agrees with the resident pass to the tolerance of a reordered sum (rtol
1e-12 of the sum of magnitudes, ``PERF.md`` section 2); integer
aggregations and floats whose sums are exact agree bit for bit.  The
reference also pads each window's logical length to a power-of-two bucket
with aggregation-neutral rows (``_quantize_reduce``/``_quantize_groupby``)
and compacts filters on the host (``_seed_filters``), both so that XLA
compiles once per bucket; the port's kernels take any row count, so a
window's chain runs through the eager seams as it is.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import pandas

from modin_tpu_torch.logging.metrics import CountView, emit_counted
from modin_tpu_torch.observability import meters as _meters
from modin_tpu_torch.observability import spans as _spans
from modin_tpu_torch.streaming import GROUPBY_COMBINABLE, REDUCE_COMBINABLE, StreamDegrade, window_body
from modin_tpu_torch.streaming import windows as _windows

#: the streaming layer's always-on tally: windows (``stream.window.count``),
#: replays, degrades, spilled run bytes, window bytes and rows, and the
#: prefetch's overlap and wait seconds
COUNTS = CountView(prefixes=("stream.",))

_count = emit_counted


# ---------------------------------------------------------------------- #
# plan-shape gating
# ---------------------------------------------------------------------- #


def _single_scan_chain(roots: Tuple[Any, ...]) -> Optional[Any]:
    """The one Scan every leaf of ``roots`` resolves to, where the interior
    is per-row (Project/Filter/Map): the shape a window loop replays
    exactly.  Anything else (a second source, a nested reduce or sort, a
    Source leaf) is None, and the resident lowering proceeds."""
    from modin_tpu_torch.plan.ir import Filter, Map, Project, Scan, walk

    scan = None
    for root in roots:
        for node in walk(root):
            if isinstance(node, Scan):
                if scan is not None and node is not scan:
                    return None
                scan = node
            elif not isinstance(node, (Project, Filter, Map)):
                return None
    return scan


def _stream_source(node: Any, memo: dict, op_tag: str) -> Optional[Tuple[Any, dict]]:
    """(scan, reader kwargs) where this materialization streams, else None:
    the plan's shape, the reader's eligibility and the residency router's
    verdict on the source's size."""
    from modin_tpu_torch import streaming
    from modin_tpu_torch.ops import router
    from modin_tpu_torch.plan import lowering

    if not streaming.STREAM_ON:
        return None
    scan = _single_scan_chain(node.children)
    if scan is None or id(scan) in memo:
        return None
    kwargs = _windows.streamable_read_kwargs(scan.dispatcher, lowering.scan_read_kwargs(scan))
    if kwargs is None:
        return None
    try:
        est = int(scan.dispatcher.file_size(kwargs["filepath_or_buffer"]))
    except OSError:
        return None
    if router.decide_residency(op_tag, est) != "windowed":
        return None
    from modin_tpu_torch.plan import optimizer

    optimizer.note_stream_bytes(est)
    return scan, kwargs


# ---------------------------------------------------------------------- #
# the window loop
# ---------------------------------------------------------------------- #


def window_loop(source: "_windows.WindowSource", consume: Callable[[int, Any], None]) -> int:
    """Run ``consume(index, window_qc)`` over every window; returns the
    window count.  ``consume`` runs on the caller's thread (inside its
    lowering and tracing context); the next window's parse and upload
    overlap it while ``StreamPrefetch`` > 0.  Each window is released
    before the next is consumed; a device failure inside ``consume``
    replays that one window."""
    from modin_tpu_torch.config import StreamPrefetch

    n = len(source)
    prefetch = int(StreamPrefetch.get())
    if prefetch <= 0:
        for i in range(n):
            _consume_window(source, consume, i, source.parse_window(i))
        return n

    work: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    span_stack = _spans.snapshot_stack()
    scopes = _meters.snapshot_scopes()

    def _prefetch() -> None:
        # the worker's uploads bill the owner's spans and query scopes
        _spans.seed_thread(span_stack)
        _meters.seed_thread_scopes(scopes)
        try:
            for i in range(n):
                if stop.is_set():
                    return
                t0 = time.perf_counter()
                try:
                    qc = source.parse_window(i)
                except BaseException as exc:  # handed to the consumer, which re-raises or replays it
                    work.put(("error", i, exc, 0.0))
                    return
                work.put(("ok", i, qc, time.perf_counter() - t0))
        finally:
            _meters.seed_thread_scopes(None)
            _spans.seed_thread(None)

    worker = threading.Thread(target=_prefetch, name="stream-prefetch", daemon=True)
    worker.start()
    try:
        consumed = 0
        while consumed < n:
            w0 = time.perf_counter()
            kind, index, payload, parse_s = work.get()
            wait_s = time.perf_counter() - w0
            if kind == "error":
                from modin_tpu_torch.core.execution.resilience import classify_device_error

                if classify_device_error(payload) is None:
                    raise payload
                # a device failure while prefetching window `index`: the
                # worker is gone, and the byte ranges make everything
                # again; replay that window and finish the rest serially
                _count("stream.window.replay")
                for j in range(index, n):
                    _consume_window(source, consume, j, source.parse_window(j))
                    consumed += 1
                break
            # the share of this window's parse and upload hidden behind the
            # previous window's consume, and the consumer's wait for it
            _count("stream.prefetch.wait_s", wait_s)
            _count("stream.prefetch.overlap_s", max(parse_s - wait_s, 0.0))
            _consume_window(source, consume, index, payload)
            consumed += 1
    finally:
        stop.set()
        # unblock a worker parked on a full queue, releasing the windows it
        # already uploaded; the second drain, after the join, catches the
        # put that the first drain unblocked
        for _ in range(2):
            while True:
                try:
                    item = work.get_nowait()
                except queue.Empty:
                    break
                if item[0] == "ok":
                    _windows.release_qc(item[2])
            worker.join(timeout=30.0)
    return n


def _consume_window(source: "_windows.WindowSource", consume: Callable[[int, Any], None], index: int,
                    qc: Any) -> None:
    from modin_tpu_torch.core.execution.resilience import classify_device_error

    with _spans.span("stream.window", "QUERY-COMPILER", window=index):
        try:
            try:
                consume(index, qc)
            except Exception as exc:  # the replay point: anything not a device failure re-raises
                if classify_device_error(exc) is None:
                    raise
                # a device failure the seams did not absorb: the window's
                # tensors are gone for good, and its byte range makes them
                # again; one replay of this window
                _count("stream.window.replay")
                _windows.release_qc(qc)
                qc = source.parse_window(index)
                consume(index, qc)
        finally:
            _windows.release_qc(qc)
    _count("stream.window.count")


def _make_source(scan: Any, kwargs: dict) -> "_windows.WindowSource":
    from modin_tpu_torch.config import StreamPrefetch

    return _windows.WindowSource(scan.dispatcher, kwargs, _windows.window_bytes_for(int(StreamPrefetch.get())))


def _run_windows(source: "_windows.WindowSource", consume: Callable[[int, Any], None]) -> bool:
    """The window loop over ``source``, which it closes; False where the
    executor degraded to the resident path."""
    try:
        window_loop(source, consume)
    except StreamDegrade:
        _count("stream.degrade")
        return False
    finally:
        source.close()
    return True


def _wrap_result(scan: Any, final: pandas.DataFrame, hint: Any) -> Any:
    qc = scan.dispatcher.query_compiler_cls.from_pandas(final)
    if hint is not None:
        qc._shape_hint = hint
    return qc


# ---------------------------------------------------------------------- #
# streaming reduce
# ---------------------------------------------------------------------- #


def maybe_stream_reduce(node: Any, memo: dict) -> Optional[Any]:
    """A windowed lowering of one Reduce root, or None for resident."""
    if node.method not in REDUCE_COMBINABLE:
        return None
    ck = dict(node.call_kwargs)
    if ck.get("axis", 0) not in (0, None):
        return None
    if ck.get("min_count", 0) not in (0, -1):
        return None  # a real min_count needs whole-column valid counts
    if any(k not in ("axis", "skipna", "numeric_only", "min_count") for k in ck):
        return None  # ddof and the like have no window combiner
    matched = _stream_source(node, memo, "scan_reduce")
    if matched is None:
        return None
    scan, kwargs = matched
    method = node.method
    skipna = bool(ck.get("skipna", True))
    numeric_only = ck.get("numeric_only", False)
    source = _make_source(scan, kwargs)
    if len(source) == 0:
        source.close()
        return None  # an empty body: the resident parse answers exactly

    # partial state is keyed by window index, never appended: a replayed
    # window may already have recorded some of its partials, and its
    # replay overwrites them
    sums: Dict[int, pandas.DataFrame] = {}
    counts: Dict[int, Any] = {}
    partials: Dict[int, pandas.DataFrame] = {}
    hint: List[Any] = [None]
    template: List[Any] = [None]

    # a filtered window's chain and its reduction as one masked launch of
    # fused.cu (None where the chain can never fuse; per window the plan
    # answers None to keep the staged body)
    from modin_tpu_torch.plan import fuse, lowering

    fused_run = fuse.window_reduce_plan(node, scan, ck) if method != "mean" else None

    @window_body
    def consume(index: int, qc: Any) -> None:
        if fused_run is not None:
            fused = fused_run(qc)
            if fused is not None:
                partials[index] = _one_column(fused.to_pandas())
                if hint[0] is None:
                    hint[0] = getattr(fused, "_shape_hint", None) or "column"
                return
        child = lowering._lower(node.children[0], {id(scan): qc})
        if method == "mean":
            if template[0] is None:
                # the first window's probe: the eager mean's column
                # selection (and its TypeError on a non-numeric frame)
                # decides the labels the (sum, count) pairs answer for
                template[0] = child.mean(**ck).to_pandas()
            selection = template[0].index
            part = child.sum(axis=0, skipna=skipna, numeric_only=numeric_only)
            sums[index] = part.to_pandas().loc[selection]
            if skipna:
                counts[index] = child.count(axis=0, numeric_only=numeric_only).to_pandas().loc[selection]
            else:
                counts[index] = len(child._modin_frame)
        else:
            part = getattr(child, method)(**ck)
            partials[index] = _one_column(part.to_pandas())
        if hint[0] is None:
            hint[0] = getattr(part, "_shape_hint", None) or "column"

    if not _run_windows(source, consume):
        return None

    if method == "mean":
        total = _stack_combine([sums[i].iloc[:, 0] for i in sorted(sums)], "sum", False)
        if skipna:
            denom = _stack_combine([counts[i].iloc[:, 0] for i in sorted(counts)], "sum", False)
        else:
            denom = pandas.Series(sum(counts.values()), index=total.index)
        combined = total / denom
        head = template[0]
    else:
        series = [partials[i].iloc[:, 0] for i in sorted(partials)]
        if method in ("sum", "count"):
            combined = _stack_combine(series, "sum", False)
        elif method == "prod":
            combined = _stack_combine(series, "prod", False)
        else:  # min / max: a window can be all-NaN, and drops out under skipna
            combined = _stack_combine(series, method, skipna)
        head = partials[min(partials)]
    final = combined.to_frame(name=head.columns[0])
    final.index = head.index
    return _wrap_result(scan, final, hint[0])


def _one_column(partial: pandas.DataFrame) -> pandas.DataFrame:
    """A reduce partial must be one column (Series-shaped); anything else
    (a numeric_only selection of no column) degrades to the resident path
    instead of combining wrongly."""
    if partial.shape[1] != 1:
        raise StreamDegrade(f"reduce partial has {partial.shape[1]} columns, expected 1")
    return partial


def _stack_combine(series: List[pandas.Series], op: str, skipna: bool) -> pandas.Series:
    """Combine same-index partials across windows.  ``skipna=False`` for the
    additive ops keeps a NaN partial (a skipna=False query) poisoning the
    total; the query's skipna for min/max lets an all-NaN window drop out."""
    wide = pandas.concat(series, axis=1)
    return getattr(wide, op)(axis=1, skipna=skipna)


# ---------------------------------------------------------------------- #
# streaming groupby
# ---------------------------------------------------------------------- #


def maybe_stream_groupby(node: Any, memo: dict) -> Optional[Any]:
    """A windowed lowering of one GroupbyAgg root, or None for resident.

    Each window's aggregate goes into a host table of partial states keyed
    by group; past ``StreamMaxGroups`` distinct groups the executor raises
    :class:`StreamDegrade` (caught here, ``stream.degrade``), and the
    resident path answers."""
    agg = node.agg_func
    if not isinstance(agg, str) or agg not in GROUPBY_COMBINABLE:
        return None
    ck = dict(node.call_kwargs)
    if ck.get("axis", 0) != 0 or ck.get("how", "axis_wise") != "axis_wise" or ck.get("agg_args"):
        return None
    agg_kwargs = dict(ck.get("agg_kwargs") or {})
    if agg_kwargs.pop("min_count", 0) not in (0, -1):
        return None  # a real min_count needs per-group valid counts
    if any(k != "numeric_only" for k in agg_kwargs):
        return None
    gk = dict(ck.get("groupby_kwargs") or {})
    if gk.get("as_index", True) is not True or gk.get("level") is not None:
        return None
    matched = _stream_source(node, memo, "scan_groupby")
    if matched is None:
        return None
    scan, kwargs = matched
    sort = bool(gk.get("sort", True))
    dropna = bool(gk.get("dropna", True))
    source = _make_source(scan, kwargs)
    if len(source) == 0:
        source.close()
        return None

    from modin_tpu_torch.config import StreamMaxGroups
    from modin_tpu_torch.plan import lowering
    from modin_tpu_torch.plan.ir import Ref

    max_groups = int(StreamMaxGroups.get())
    # keyed by window index: a replayed window overwrites, never doubles
    partials: Dict[int, pandas.DataFrame] = {}
    count_partials: Dict[int, pandas.DataFrame] = {}
    seen_groups: set = set()
    hint: List[Any] = [None]
    mean_cols: List[Any] = [None]

    @window_body
    def consume(index: int, qc: Any) -> None:
        sub = {id(scan): qc}
        child = lowering._lower(node.children[0], sub)
        by = node.by
        if isinstance(by, Ref):
            by = lowering._lower(node.children[by.index], sub)

        def run(func: str, kw: dict = ck) -> Tuple[Any, pandas.DataFrame]:
            part = child.groupby_agg(by, func, **kw)
            return part, part.to_pandas()

        if agg == "mean":
            if mean_cols[0] is None:
                # the first window's probe: the eager mean's column
                # selection (and its raising on a non-numeric frame)
                # decides the labels the (sum, count) pairs answer for
                mean_cols[0] = run("mean")[1].columns
            part, part_pd = run("sum")
            partials[index] = part_pd[mean_cols[0]]
            count_kwargs = dict(ck, agg_kwargs={})  # a grouped count takes no numeric_only
            count_partials[index] = run("count", count_kwargs)[1][mean_cols[0]]
        else:
            part, part_pd = run(agg)
            partials[index] = part_pd
        if hint[0] is None:
            hint[0] = getattr(part, "_shape_hint", None)
        seen_groups.update(part_pd.index)
        if len(seen_groups) > max_groups:
            raise StreamDegrade(
                f"the streamed groupby passed MODIN_TPU_TORCH_STREAM_MAX_GROUPS={max_groups} distinct groups"
            )

    if not _run_windows(source, consume):
        return None

    combiner = "sum" if agg in ("sum", "count", "mean") else agg
    final = _group_combine([partials[i] for i in sorted(partials)], combiner, sort, dropna)
    if agg == "mean":
        denom = _group_combine([count_partials[i] for i in sorted(count_partials)], "sum", sort, dropna)
        final = final / denom
    return _wrap_result(scan, final, hint[0])


def _group_combine(partials: List[pandas.DataFrame], op: str, sort: bool, dropna: bool) -> pandas.DataFrame:
    """Fold the windows' group tables: stacked in window order (which keeps
    the global first-appearance order for sort=False) and grouped again by
    the full key."""
    stacked = pandas.concat(partials)
    levels = list(range(stacked.index.nlevels))
    grouped = stacked.groupby(level=levels, sort=sort, dropna=dropna)
    return getattr(grouped, op)()
