"""Spans: nestable, timed, attributed intervals with a thread-local stack.

The port's counterpart of ``modin_tpu/observability/spans.py``.  Every
instrumented call becomes a **span** (name, layer tag, span id, parent id,
host-clock interval, attributes); spans nest through a thread-local stack,
and finished spans go to the active ``profile()`` collectors and to the
flight recorder's ring (``observability/flight_recorder.py``).

Layer tags are the ``modin_layer`` of the ``ClassLogger`` mixin
(``PANDAS-API``, ``QUERY-COMPILER``, ``CORE-FRAME``, ``CORE-IO``,
``TORCH-ENGINE``), plus the seams' own (``MEMORY``, ``ROUTER``, ``PLAN``,
``VIEWS``, ``RECOVERY``, ``SHUFFLE``).

Clocks.  A span's ``dur_us`` is the host clock: around a kernel launch it
is the enqueue.  Device time comes from CUDA event pairs, recorded while
tracing is on at the four kernel wrappers and at each engine-seam attempt,
and inside a ``profile()`` over each root span
(``observability/compile_ledger.py``), and resolved with one synchronize
when a ``profile()`` exits or a record is read; they land in a span's
``device_ms`` (its launches), ``engine_device_ms`` (an engine attempt) and
``device_interval_ms`` (a root span, first to last event).

Disabled contract (the default, ``MODIN_TPU_TORCH_TRACE=0``): an
instrumented call reads ``TRACE_ON`` and nothing else; no span is made
(``span_alloc_count()``) and ``span()`` returns a shared no-op context.
``TRACE_ON`` follows the ``TraceEnabled`` setting and any open ``profile()``.

Span names emitted with a static (or f-string) name are declared in
``SPANS``; the tests scan the port's sources and hold every literal name
to a pattern and every pattern to a site.  The per-method spans of the
logging decorator (``layer_span``) carry runtime names (``<Class>.<method>``).
"""

from __future__ import annotations

import contextlib
import itertools
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

from modin_tpu_torch.concurrency import named_lock

#: the one attribute an instrumented site reads first: while False no span
#: is ever made.  Written only by :func:`_refresh_enabled`.
TRACE_ON: bool = False

#: every span family emitted with a static name (``*``: a runtime segment)
SPANS = (
    (
        "engine.*.attempt",
        "one engine-seam attempt (deploy/put/materialize/wait) under the "
        "resilience policy; retries appear as sibling attempt spans with "
        "attempt/failure_kind attributes; engine_device_ms is the attempt's "
        "event-timed device interval",
    ),
    (
        "fallback.*",
        "a device-path family declining to the pandas fallback (CPU only): "
        "reason is the classified failure kind, or short_circuit when the "
        "family's breaker is open",
    ),
    (
        "raised.*",
        "a device-path family raising on the card: reason is the failure "
        "kind, or breaker_open",
    ),
    (
        "io.read",
        "one FileDispatcher read (format dispatcher class in attributes)",
    ),
    (
        "recovery.reseat",
        "one lineage-recovery pass re-seating lost device columns after a "
        "DeviceLost (reason in attributes)",
    ),
    (
        "memory.device.spill",
        "one admission-control / evict-then-retry spill pass dropping cold "
        "device tensors to host (byte target in attributes)",
    ),
    (
        "router.decide",
        "one kernel-router decision: op family, rows, predicted device/host "
        "costs and the chosen side in attributes",
    ),
    (
        "router.calibrate",
        "the one-shot kernel-router micro-benchmark pass for this card",
    ),
    (
        "sortcache.build",
        "one batched sorted-representation build; column count in attributes",
    ),
    (
        "view.fold",
        "one incremental fold of an appended tail into a cached artifact; op "
        "and row counts in attributes",
    ),
    (
        "plan.optimize",
        "one rewrite pass to fixpoint over a pending plan (node count and "
        "passes in attributes)",
    ),
    (
        "plan.lower",
        "one lowering pass: optimized plan nodes replayed through the eager "
        "query-compiler seams (node count in attributes)",
    ),
    (
        "opt.choose",
        "one joint strategy pass over an optimized plan (a re-plan's too: "
        "replanning in attributes)",
    ),
    (
        "opt.replan",
        "one mid-query re-plan of the not-yet-lowered nodes (trigger, "
        "remaining nodes and the re-plan's wall in attributes)",
    ),
    (
        "fuse.lower",
        "one masked fused leg: the filter/map chain and its reduction or "
        "groupby tail run as one fused-kernel launch (rows in attributes)",
    ),
    (
        "fusion.lower",
        "one host lowering of a fused program (a program-cache miss): the "
        "expression forest compiled into the kernel's encoding",
    ),
    (
        "kernel.build",
        "one nvcc build of the port's kernel sources (names in attributes)",
    ),
    (
        "stream.window",
        "one resident window of the out-of-core executor: parse, upload, "
        "consume and drop of a record-aligned byte range (scan loop), or one "
        "external-sort window slice (window index in attributes)",
    ),
    (
        "stream.merge",
        "one k-way fold of the external sort's spilled sorted runs into the "
        "final permutation (run count in attributes)",
    ),
    (
        "shuffle.sample_pivots",
        "the strided key sample fetched to the host and its quantile pivots, "
        "ahead of a range shuffle",
    ),
    (
        "shuffle.range_shuffle",
        "one range-partition shuffle over the row-shard mesh: bucketize, "
        "count and pack per shard, the block exchange, compaction and the "
        "gather back; shards, capacity and slack retries in attributes",
    ),
    (
        "serving.admit",
        "one admission decision of the serving gate: tenant, queue wait and "
        "the degraded-route flag in attributes; error status means the query "
        "was shed or its deadline expired while queued",
    ),
    (
        "serving.query",
        "one admitted query's execution under its serving context (tenant, "
        "label, degraded in attributes); everything it launched nests under it",
    ),
)

_EPOCH_PERF = time.perf_counter()
_EPOCH_WALL = time.time()

_span_ids = itertools.count(1)
_alloc_count = 0  # Span objects ever made (the zero-alloc assertion)

_tls = threading.local()

_collectors: List[list] = []  # active profile() collectors
_state_lock = named_lock("spans.state")

#: bounded ring of recently finished spans (the flight recorder's memory)
_RING: Optional[deque] = None

#: bounded ring of counter samples ``(ts_us, (device_bytes, host_bytes,
#: live_spans, padding_waste_bytes, achieved_bw))`` taken at each span
#: finish while tracing is on (Chrome-trace counter tracks)
_COUNTERS: Optional[deque] = None

_live_spans = 0
_live_lock = named_lock("spans.live")

_env_enabled = False

#: the device clock of root spans: ``(begin, end)`` set by the launch
#: ledger while tracing is on and a CUDA context exists
_root_clock: Optional[tuple] = None


class Span:
    """One timed, attributed interval on the query path."""

    __slots__ = (
        "name",
        "layer",
        "span_id",
        "parent_id",
        "start_us",
        "dur_us",
        "wall_start_s",
        "attrs",
        "thread_id",
        "thread_name",
        "status",
        "_counted",
        "_dev",
    )

    def __init__(self, name: str, layer: str, attrs: Optional[dict], parent_id: Optional[int]):
        t = threading.current_thread()
        self.name = name
        self.layer = layer
        self.span_id = next(_span_ids)
        self.parent_id = parent_id
        self.start_us = (time.perf_counter() - _EPOCH_PERF) * 1e6
        self.wall_start_s = _EPOCH_WALL + self.start_us / 1e6
        self.dur_us = 0.0
        self.attrs = attrs if attrs is not None else {}
        self.thread_id = t.ident or 0
        self.thread_name = t.name
        self.status = "open"
        self._counted = False
        self._dev = None  # a root span's start event

    def __repr__(self) -> str:
        return (
            f"<Span {self.name} [{self.layer}] id={self.span_id} "
            f"parent={self.parent_id} dur={self.dur_us / 1e3:.3f}ms {self.status}>"
        )


# ---------------------------------------------------------------------- #
# enable/disable plumbing
# ---------------------------------------------------------------------- #


def _refresh_enabled() -> None:
    """Recompute TRACE_ON (and size the ring) from the setting and the
    collectors; tell the modules that gate on it."""
    global TRACE_ON, _RING, _COUNTERS, _live_spans
    on = _env_enabled or bool(_collectors)
    if on:
        from modin_tpu_torch.config import TraceFlightRecorderSize

        size = int(TraceFlightRecorderSize.get())
        if size <= 0:
            _RING = None
            _COUNTERS = None
            with _live_lock:
                _live_spans = 0
        elif _RING is None or _RING.maxlen != size:
            if _RING is None:
                with _live_lock:
                    _live_spans = 0
            _RING = deque(_RING or (), maxlen=size)
            _COUNTERS = deque(_COUNTERS or (), maxlen=size)
    TRACE_ON = on
    for mod in ("modin_tpu_torch.observability.compile_ledger", "modin_tpu_torch.logging.logger_decorator"):
        refresh = getattr(sys.modules.get(mod), "refresh", None)
        if refresh is not None:  # None while it is still being imported
            refresh()


def _on_trace_param(param: Any) -> None:
    global _env_enabled
    _env_enabled = bool(param.get())
    _refresh_enabled()


def trace_enabled() -> bool:
    """Is span collection on now (the setting, or a profile)?"""
    return TRACE_ON


def span_alloc_count() -> int:
    """How many Span objects this process has made (the disabled contract
    is none: tests read it around a workload with tracing off)."""
    return _alloc_count


# ---------------------------------------------------------------------- #
# the span stack
# ---------------------------------------------------------------------- #


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def current_span() -> Optional[Span]:
    """Innermost open span on this thread, or None."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def snapshot_stack() -> Optional[list]:
    """Copy of this thread's open-span stack (outermost first), or None."""
    stack = getattr(_tls, "stack", None)
    return list(stack) if stack else None


def seed_thread(stack: Optional[list]) -> None:
    """Adopt a snapshot of another thread's span stack as ambient context
    (a worker's spans and compile attribution then nest under the call
    that spawned it); ``None`` clears it.  The seeded spans stay owned by
    their thread."""
    _tls.stack = list(stack) if stack else []


def attribution_signature() -> str:
    """The signature a build, lowering or launch is billed to: the
    innermost QUERY-COMPILER span open on this thread, else the innermost
    span, else ``<untraced>``."""
    stack = getattr(_tls, "stack", None)
    if not stack:
        return "<untraced>"
    for sp in reversed(stack):
        if sp.layer == "QUERY-COMPILER":
            return sp.name
    return stack[-1].name


# ---------------------------------------------------------------------- #
# span lifecycle
# ---------------------------------------------------------------------- #


def start_span(
    name: str,
    layer: str = "APP",
    attrs: Optional[dict] = None,
    parent_id: Optional[int] = None,
) -> Span:
    """Open a span and push it on this thread's stack (callers on hot
    paths check ``TRACE_ON`` first: this always allocates)."""
    global _alloc_count, _live_spans
    stack = _stack()
    if parent_id is None and stack:
        parent_id = stack[-1].span_id
    sp = Span(name, layer, attrs, parent_id)
    _alloc_count += 1
    if _COUNTERS is not None:
        sp._counted = True
        with _live_lock:
            _live_spans += 1
    if parent_id is None and _root_clock is not None:
        sp._dev = _root_clock[0]()
    stack.append(sp)
    return sp


def finish_span(sp: Span, status: str = "ok") -> None:
    """Close a span, pop it, and deliver it to the collectors and the ring."""
    global _live_spans
    if sp._dev is not None and _root_clock is not None:
        _root_clock[1](sp)
    sp.dur_us = (time.perf_counter() - _EPOCH_PERF) * 1e6 - sp.start_us
    sp.status = status
    if sp._counted and _COUNTERS is not None:
        with _live_lock:
            _live_spans = max(_live_spans - 1, 0)
    stack = getattr(_tls, "stack", None)
    if stack:
        if stack[-1] is sp:
            stack.pop()
        else:  # finished out of order: best effort
            try:
                stack.remove(sp)
            except ValueError:
                pass
    _deliver(sp)


def _deliver(sp: Span) -> None:
    ring = _RING
    if ring is not None:
        ring.append(sp)
    counters = _COUNTERS
    if counters is not None:
        counters.append((sp.start_us + sp.dur_us, _ledger_bytes() + (_live_spans,) + _cost_samples() + _gate_samples()))
    if _collectors:
        with _state_lock:
            for collector in _collectors:
                collector.append(sp)


def _ledger_bytes() -> tuple:
    """(device-resident bytes, host-cache bytes): 0s until ``core.memory``
    is imported (never imported from here)."""
    memory = sys.modules.get("modin_tpu_torch.core.memory")
    if memory is None:
        return (0, 0)
    try:
        return (memory.device_ledger.total_bytes(), memory.ledger.total_bytes())
    except Exception:
        return (0, 0)


def _cost_samples() -> tuple:
    """(padding-waste bytes, last achieved bandwidth) from the cost layer:
    0s until it is imported."""
    costs = sys.modules.get("modin_tpu_torch.observability.costs")
    if costs is None:
        return (0, 0)
    try:
        return costs.counter_sample()
    except Exception:
        return (0, 0)


def _gate_samples() -> tuple:
    """(admission-queue depth, queries in flight) from the serving gate: 0s
    until it is imported, read without its lock."""
    gate = sys.modules.get("modin_tpu_torch.serving.gate")
    if gate is None:
        return (0, 0)
    try:
        return gate.counter_sample()
    except Exception:
        return (0, 0)


def counter_samples(start_us: Optional[float] = None, end_us: Optional[float] = None) -> List[tuple]:
    """Counter samples in the ring, optionally clipped to a time window."""
    counters = _COUNTERS
    if counters is None:
        return []
    out = list(counters)
    if start_us is not None:
        out = [s for s in out if s[0] >= start_us]
    if end_us is not None:
        out = [s for s in out if s[0] <= end_us]
    return out


class _SpanHandle:
    """Context manager over one open span; yields the Span."""

    __slots__ = ("_span",)

    def __init__(self, sp: Span):
        self._span = sp

    def __enter__(self) -> Span:
        return self._span

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        if exc_type is not None:
            self._span.attrs.setdefault("exc", exc_type.__name__)
            finish_span(self._span, status="error")
        else:
            finish_span(self._span)
        return False


class _NullHandle:
    """Shared no-op context manager while tracing is off."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc_info: Any) -> bool:
        return False


_NULL_HANDLE = _NullHandle()


def span(name: str, layer: str = "APP", **attrs: Any) -> Any:
    """Open a named span as a context manager (no-op while tracing is off)."""
    if not TRACE_ON:
        return _NULL_HANDLE
    return _SpanHandle(start_span(name, layer, attrs or None))


def layer_span(name: str, layer: str) -> Any:
    """``span`` for runtime-built names (the logging decorator's)."""
    if not TRACE_ON:
        return _NULL_HANDLE
    return _SpanHandle(start_span(name, layer, None))


def event(name: str, layer: str, **attrs: Any) -> None:
    """A zero-length span (a decision, a fallback); callers check
    ``TRACE_ON`` first."""
    finish_span(start_span(name, layer, attrs or None))


# ---------------------------------------------------------------------- #
# profiles
# ---------------------------------------------------------------------- #

#: the user-facing entry layers (shared with the logging decorator)
API_LAYERS = frozenset({"PANDAS-API", "NUMPY-API", "POLARS-API"})

#: which rollup figures come from which clock
CLOCKS = {
    "wall_s": "host",
    "host_s": "host",
    "engine_s": "host",
    "compile_s": "host",
    "by_layer_self_s": "host",
    "device_s": "events",
    "kernel_device_s": "events",
    "engine_device_s": "events",
}


class Profile:
    """The spans collected by one ``profile()`` block, plus rollups."""

    def __init__(self) -> None:
        self.spans: List[Span] = []

    # -- structure ----------------------------------------------------- #

    def tree(self) -> List[dict]:
        """Nested {span, children} dicts rooted at spans with no collected
        parent, in start order."""
        by_id: Dict[int, dict] = {sp.span_id: {"span": sp, "children": []} for sp in self.spans}
        roots: List[dict] = []
        for sp in sorted(self.spans, key=lambda s: s.start_us):
            node = by_id[sp.span_id]
            parent = by_id.get(sp.parent_id) if sp.parent_id else None
            if parent is not None:
                parent["children"].append(node)
            else:
                roots.append(node)
        return roots

    def find(self, prefix: str) -> List[Span]:
        """Collected spans whose name starts with ``prefix``."""
        return [sp for sp in self.spans if sp.name.startswith(prefix)]

    def ancestors(self, sp: Span) -> List[Span]:
        """Chain of collected ancestors of ``sp``, innermost first."""
        by_id = {s.span_id: s for s in self.spans}
        out: List[Span] = []
        cur = by_id.get(sp.parent_id) if sp.parent_id else None
        while cur is not None:
            out.append(cur)
            cur = by_id.get(cur.parent_id) if cur.parent_id else None
        return out

    # -- rollups -------------------------------------------------------- #

    def rollup(self) -> dict:
        """Where the time went, by clock (``clocks`` says which):

        - ``wall_s``: summed host duration of the root spans;
        - ``engine_s``: host time inside engine-seam attempts (enqueues and
          blocking fetches);
        - ``compile_s``: nvcc builds and fused-program lowerings billed to
          the collected spans;
        - ``host_s``: ``wall_s - engine_s``;
        - ``by_layer_self_s``: each layer's self time (a span's duration
          less its collected children's);
        - ``device_s``: the root spans' event-timed device intervals (first
          event to last, idle gaps included; where a root span recorded no
          pair, 0);
        - ``kernel_device_s``: event time of the ledgered launches of the
          four hand kernels;
        - ``engine_device_s``: event time of the engine-seam attempts;
        - ``kernels``: per kernel, launches, device ms, bytes, operations.
        """
        from modin_tpu_torch.observability import compile_ledger

        compile_ledger.resolve_events()
        spans = self.spans
        by_id = {sp.span_id: sp for sp in spans}
        child_us: Dict[int, float] = {}
        for sp in spans:
            if sp.parent_id in by_id:
                child_us[sp.parent_id] = child_us.get(sp.parent_id, 0.0) + sp.dur_us
        roots = [sp for sp in spans if sp.parent_id not in by_id]
        wall_us = sum(sp.dur_us for sp in roots)
        engine_attempts = [sp for sp in spans if sp.name.startswith("engine.") and sp.name.endswith(".attempt")]
        engine_us = sum(sp.dur_us for sp in engine_attempts)
        compile_s = sum(sp.attrs.get("compile_s", 0.0) for sp in spans)
        by_layer: Dict[str, float] = {}
        kernels: Dict[str, dict] = {}
        for sp in spans:
            self_us = max(sp.dur_us - child_us.get(sp.span_id, 0.0), 0.0)
            by_layer[sp.layer] = by_layer.get(sp.layer, 0.0) + self_us
            for kernel, rec in sp.attrs.get("launches", {}).items():
                agg = kernels.setdefault(kernel, {"launches": 0, "device_ms": 0.0, "bytes": 0, "flops": 0})
                for key in agg:
                    agg[key] += rec.get(key, 0)
        return {
            "wall_s": wall_us / 1e6,
            "engine_s": engine_us / 1e6,
            "device_s": sum(sp.attrs.get("device_interval_ms", 0.0) for sp in roots) / 1e3,
            "kernel_device_s": sum(k["device_ms"] for k in kernels.values()) / 1e3,
            "engine_device_s": sum(sp.attrs.get("engine_device_ms", 0.0) for sp in engine_attempts) / 1e3,
            "compile_s": compile_s,
            "host_s": max((wall_us - engine_us) / 1e6, 0.0),
            "spans": len(spans),
            "by_layer_self_s": {layer: round(us / 1e6, 6) for layer, us in sorted(by_layer.items())},
            "kernels": kernels,
            "clocks": dict(CLOCKS),
        }

    # -- export --------------------------------------------------------- #

    def _counter_window(self) -> List[tuple]:
        if not self.spans:
            return []
        return counter_samples(
            start_us=min(sp.start_us for sp in self.spans),
            end_us=max(sp.start_us + sp.dur_us for sp in self.spans),
        )

    def to_chrome_trace(self) -> dict:
        from modin_tpu_torch.observability.chrome_trace import to_chrome_trace

        return to_chrome_trace(self.spans, other_data={"rollup": self.rollup()}, counters=self._counter_window())

    def export_chrome_trace(self, path: Any) -> str:
        from modin_tpu_torch.observability.chrome_trace import export_chrome_trace

        return export_chrome_trace(
            self.spans, path, other_data={"rollup": self.rollup()}, counters=self._counter_window()
        )


@contextlib.contextmanager
def profile() -> Iterator[Profile]:
    """Collect every span finished while the block runs (tracing is on for
    the block whatever the setting).  On exit the device events recorded
    in the block are resolved, with one synchronize."""
    prof = Profile()
    with _state_lock:
        _collectors.append(prof.spans)
    _refresh_enabled()
    try:
        yield prof
    finally:
        with _state_lock:
            try:
                _collectors.remove(prof.spans)
            except ValueError:
                pass
        _refresh_enabled()
        from modin_tpu_torch.observability import compile_ledger

        compile_ledger.resolve_events()


def set_root_clock(clock: Optional[tuple]) -> None:
    """Install (or remove) the device clock of root spans."""
    global _root_clock
    _root_clock = clock


# wire the settings (each subscription fires at once with the current value)
from modin_tpu_torch.config import (  # noqa: E402
    TraceEnabled as _TraceEnabled,
    TraceFlightRecorderSize as _TraceFlightRecorderSize,
)

_TraceEnabled.subscribe(_on_trace_param)
_TraceFlightRecorderSize.subscribe(lambda _param: _refresh_enabled())

