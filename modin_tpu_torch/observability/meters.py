"""Meters: in-process metric aggregation and per-query resource accounting.

The port's counterpart of ``modin_tpu/observability/meters.py``.
``emit_metric`` (``modin_tpu_torch/logging/metrics.py``) fans values out to
handlers; this module is the measurement layer on that stream:

- **Aggregation registry**: every emitted metric folds into a typed meter
  (counter / gauge / fixed-bucket histogram) keyed by its name, the kind
  from its family in ``METRICS``.  ``snapshot()`` returns the registry as
  plain dicts (p50/p95/p99 for histograms), ``reset()`` clears it;
  ``observability/exposition.py`` renders a snapshot as Prometheus text or
  JSON.

- **Per-query accounting**: a :func:`query_stats` scope rolls up, per
  thread, what a query consumed: wall time, engine dispatches, builds and
  lowerings (``compiles``), bytes parsed by FileDispatcher reads, the card's
  memory high-water (``torch.cuda.memory_allocated`` samples and the
  device ledger's resident bytes, and ``torch.cuda.max_memory_allocated``
  when the process peak rose inside the scope), spills and restores,
  recoveries and cache hits, and a streamed query's windows, replays and
  prefetch overlap and wait (a window's parsed bytes count in
  ``bytes_parsed``, an external sort's spilled runs in ``spill_bytes``).
  Scopes nest and are thread-isolated.  ``collective_bytes`` adds the
  range shuffle's block exchanges (``costs.note_collective``); the field
  set is the JAX package's, so snapshots line up.

Disabled contract (the default, ``MODIN_TPU_TORCH_METERS=0`` and no open
scope): ``emit_metric`` reads ``metrics._aggregate`` (None) and the seams
read :data:`ACCOUNTING_ON`; no meter object is made (``meter_alloc_count()``).
"""

from __future__ import annotations

import contextlib
import fnmatch
import sys
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

from modin_tpu_torch.concurrency import named_lock


#: The seams' fast path: True while the aggregation registry
#: (``MODIN_TPU_TORCH_METERS``) or at least one ``query_stats()`` scope is
#: live.  Instrumented seams (engine dispatch accounting, compile
#: listener, FileDispatcher byte accounting, fused-cache hit accounting)
#: check this ONE attribute before doing anything else.
ACCOUNTING_ON: bool = False

#: True while ``MODIN_TPU_TORCH_METERS`` is enabled (registry aggregation).
METERS_ON: bool = False

#: Fixed bucket upper bounds for every histogram-kind family declared in
#: ``METRICS`` (modin_tpu_torch/logging/metrics.py).  Keys are the exact registry
#: patterns (``tests/test_torch_observability.py`` holds the two to each
#: other).  Values below the first bound land in the first bucket; values
#: above the last in the overflow bucket.
HISTOGRAM_BUCKETS: Dict[str, Tuple[float, ...]] = {
    # wall-clock seconds per public pandas-API call
    "pandas-api.*": (
        0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
        0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
    ),
    # bytes parsed per FileDispatcher read
    "io.read.bytes": (
        1 << 10, 4 << 10, 16 << 10, 64 << 10, 256 << 10,
        1 << 20, 4 << 20, 16 << 20, 64 << 20, 256 << 20, 1 << 30,
    ),
    # rewrite passes to fixpoint per plan materialization
    "plan.optimize.passes": (1, 2, 3, 4, 6, 8, 12, 16),
    # distinct plan nodes lowered per materialization
    "plan.lower.nodes": (1, 2, 4, 8, 16, 32, 64, 128, 256),
    # seconds an admitted query spent in the serving gate's queue
    "serving.queue_wait_s": (
        0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
        0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
    ),
    # wall seconds of one submitted query, admission to result
    "serving.query_wall_s": (
        0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
        1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
    ),
}

VALID_KINDS = ("counter", "gauge", "histogram")

_alloc_count = 0  # meter objects ever constructed (the zero-alloc assertion)

_qs_tls = threading.local()  # .stack: active QueryStats; .dispatches: count

_scope_lock = named_lock("meters.scopes")
_active_scopes = 0

_env_enabled = False


def meter_alloc_count() -> int:
    """How many aggregation objects this process has ever constructed.

    The disabled-mode contract is *zero new allocations*; tests snapshot
    this counter around a workload run with meters off.
    """
    return _alloc_count


# ---------------------------------------------------------------------- #
# meter types
# ---------------------------------------------------------------------- #


class Counter:
    """Monotonic sum of emitted values (plus emission count)."""

    __slots__ = ("total", "count")
    kind = "counter"

    def __init__(self) -> None:
        global _alloc_count
        _alloc_count += 1
        self.total = 0.0
        self.count = 0

    def add(self, value: Union[int, float]) -> None:
        self.total += value
        self.count += 1

    def snapshot(self) -> dict:
        total = self.total
        if isinstance(total, float) and total.is_integer():
            total = int(total)
        return {"kind": "counter", "total": total, "count": self.count}


class Gauge:
    """Last emitted value, with min/max/count over the window."""

    __slots__ = ("value", "min", "max", "count")
    kind = "gauge"

    def __init__(self) -> None:
        global _alloc_count
        _alloc_count += 1
        self.value = 0.0
        self.min = None
        self.max = None
        self.count = 0

    def add(self, value: Union[int, float]) -> None:
        self.value = value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)
        self.count += 1

    def snapshot(self) -> dict:
        return {
            "kind": "gauge",
            "value": self.value,
            "min": self.min,
            "max": self.max,
            "count": self.count,
        }


class Histogram:
    """Fixed-bucket histogram: per-bucket counts + sum/min/max, with
    percentile estimation by linear interpolation inside the bucket."""

    __slots__ = ("bounds", "bucket_counts", "count", "sum", "min", "max")
    kind = "histogram"

    def __init__(self, bounds: Tuple[float, ...]) -> None:
        global _alloc_count
        _alloc_count += 1
        self.bounds = tuple(float(b) for b in bounds)
        self.bucket_counts = [0] * (len(self.bounds) + 1)  # +1: overflow
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def add(self, value: Union[int, float]) -> None:
        value = float(value)
        idx = len(self.bounds)  # overflow unless a bound catches it
        for i, bound in enumerate(self.bounds):
            if value <= bound:
                idx = i
                break
        self.bucket_counts[idx] += 1
        self.count += 1
        self.sum += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)

    def percentile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (0 < q < 1), linear inside the bucket."""
        if self.count == 0:
            return None
        target = q * self.count
        seen = 0.0
        for i, bucket_count in enumerate(self.bucket_counts):
            if bucket_count == 0:
                continue
            if seen + bucket_count >= target:
                lo = self.bounds[i - 1] if i > 0 else (
                    self.min if self.min is not None else 0.0
                )
                hi = self.bounds[i] if i < len(self.bounds) else (
                    self.max if self.max is not None else lo
                )
                lo = max(lo, self.min) if self.min is not None else lo
                hi = min(hi, self.max) if self.max is not None else hi
                if hi <= lo:
                    return lo
                frac = (target - seen) / bucket_count
                return lo + (hi - lo) * frac
            seen += bucket_count
        return self.max

    def snapshot(self) -> dict:
        cumulative = []
        running = 0
        for bound, bucket_count in zip(self.bounds, self.bucket_counts):
            running += bucket_count
            cumulative.append([bound, running])
        return {
            "kind": "histogram",
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
            "buckets": cumulative,  # [upper_bound, cumulative_count] pairs
        }


# ---------------------------------------------------------------------- #
# the registry
# ---------------------------------------------------------------------- #


class MeterRegistry:
    """Thread-safe name -> meter aggregation, kinds resolved against the
    ``METRICS`` declarations."""

    def __init__(self) -> None:
        self._lock = named_lock("meters.registry")
        self._meters: Dict[str, Any] = {}
        self._kinds: Dict[str, Tuple[str, Optional[Tuple[float, ...]]]] = {}
        self._dropped = 0  # observations refused by the cardinality guard
        self._dropped_names: set = set()  # distinct refused names (bounded)

    # -- kind resolution ------------------------------------------------ #

    def _resolve(self, name: str) -> Tuple[str, Optional[Tuple[float, ...]]]:
        cached = self._kinds.get(name)
        if cached is not None:
            return cached
        from modin_tpu_torch.logging.metrics import METRICS

        kind = "counter"  # ad-hoc names (tests) default to the safest kind
        buckets: Optional[Tuple[float, ...]] = None
        for entry in METRICS:
            pattern = entry[0]
            if fnmatch.fnmatchcase(name, pattern):
                declared = entry[1] if len(entry) > 2 else "counter"
                if declared in VALID_KINDS:
                    kind = declared
                if kind == "histogram":
                    buckets = HISTOGRAM_BUCKETS.get(pattern)
                    if buckets is None:
                        kind = "counter"  # undeclared buckets: degrade
                break
        self._kinds[name] = (kind, buckets)
        return kind, buckets

    def _max_series(self) -> int:
        try:
            from modin_tpu_torch.config import MetersMaxSeries

            return int(MetersMaxSeries.get())
        except ImportError:  # config unavailable during teardown
            return 2048

    # -- recording ------------------------------------------------------- #

    def record(self, name: str, value: Union[int, float]) -> None:
        with self._lock:
            meter = self._meters.get(name)
            if meter is None:
                max_series = self._max_series()
                if len(self._meters) >= max_series:
                    self._dropped += 1
                    # distinct-name accounting is itself bounded: a runaway
                    # of rotating names must not leak through the guard's
                    # own bookkeeping
                    if len(self._dropped_names) < 4 * max_series:
                        self._dropped_names.add(name)
                    return
                kind, buckets = self._resolve(name)
                if kind == "histogram":
                    meter = Histogram(buckets)
                elif kind == "gauge":
                    meter = Gauge()
                else:
                    meter = Counter()
                self._meters[name] = meter
            meter.add(value)

    # -- introspection --------------------------------------------------- #

    def snapshot(self) -> dict:
        """Deep-copied ``{"series": {name: meter-dict}, ...}`` snapshot."""
        with self._lock:
            return {
                "enabled": METERS_ON,
                "dropped_series": len(self._dropped_names),
                "dropped_observations": self._dropped,
                "series": {
                    name: meter.snapshot()
                    for name, meter in sorted(self._meters.items())
                },
            }

    def reset(self) -> None:
        with self._lock:
            self._meters.clear()
            # the kind-resolution cache too: reset cycles with rotating
            # interpolated names would otherwise grow it without bound
            self._kinds.clear()
            self._dropped = 0
            self._dropped_names.clear()


_REGISTRY = MeterRegistry()


def get_registry() -> MeterRegistry:
    return _REGISTRY


def snapshot() -> dict:
    """Snapshot of the process-wide aggregation registry."""
    return _REGISTRY.snapshot()


def reset() -> None:
    """Clear the process-wide aggregation registry."""
    _REGISTRY.reset()


# ---------------------------------------------------------------------- #
# enable/disable plumbing
# ---------------------------------------------------------------------- #


def _refresh_enabled() -> None:
    """Recompute the fast-path flags and (un)install the emit hook."""
    global ACCOUNTING_ON, METERS_ON
    METERS_ON = _env_enabled
    on = METERS_ON or _active_scopes > 0
    ACCOUNTING_ON = on
    metrics = sys.modules.get("modin_tpu_torch.logging.metrics")
    if metrics is None and on:
        from modin_tpu_torch.logging import metrics  # noqa: F811
    if metrics is not None:
        metrics._aggregate = _dispatch_metric if on else None
    # cost capture's Auto mode piggybacks on ACCOUNTING_ON; only poke the module
    # if something already imported it (same no-import rule as the ledger
    # sampling seam) — costs recomputes on ITS import/config path otherwise
    costs_refresh = getattr(sys.modules.get("modin_tpu_torch.observability.costs"), "_refresh", None)
    if costs_refresh is not None:
        costs_refresh()
    for name in ("modin_tpu_torch.observability.compile_ledger", "modin_tpu_torch.logging.logger_decorator"):
        refresh = getattr(sys.modules.get(name), "refresh", None)
        if refresh is not None:  # None while it is still being imported
            refresh()


def _on_meters_param(param: Any) -> None:
    global _env_enabled
    # same lock as query_stats enter/exit: an unsynchronized refresh could
    # read a stale _active_scopes and strand ACCOUNTING_ON=False under an
    # open scope (or leave the emit hook uninstalled)
    with _scope_lock:
        _env_enabled = bool(param.get())
        _refresh_enabled()


def meters_enabled() -> bool:
    """Is registry aggregation active right now (``MODIN_TPU_TORCH_METERS``)?"""
    return METERS_ON


def _dispatch_metric(name: str, value: Union[int, float]) -> None:
    """The ``metrics._aggregate`` hook: registry + active QueryStats."""
    try:
        if METERS_ON:
            _REGISTRY.record(name, value)
        stack = getattr(_qs_tls, "stack", None)
        if stack:
            for qs in stack:
                qs._on_metric(name, value)
    except Exception:
        pass


# ---------------------------------------------------------------------- #
# seam hooks (callers check ACCOUNTING_ON first)
# ---------------------------------------------------------------------- #


def thread_dispatches() -> int:
    """Monotonic per-thread dispatch counter (EXPLAIN ANALYZE takes deltas)."""
    return getattr(_qs_tls, "dispatches", 0)


def note_dispatch() -> None:
    """One successful engine-seam deploy on this thread.

    Called by the resilience wrapper's success path while accounting is on;
    feeds the per-thread counter (plan-node attribution) and the metric
    stream (registry + QueryStats).  Compile attribution is separate: the
    launch ledger bills builds and lowerings via :func:`note_compile`.
    """
    _qs_tls.dispatches = getattr(_qs_tls, "dispatches", 0) + 1
    from modin_tpu_torch.logging.metrics import emit_metric

    emit_metric("engine.dispatch", 1)


def note_compile(duration_s: float) -> None:
    """One nvcc build or fused-program lowering billed by the launch ledger."""
    from modin_tpu_torch.logging.metrics import emit_metric

    emit_metric("engine.compile", 1)
    emit_metric("engine.compile_s", duration_s)


def _device_resident_bytes() -> int:
    """What the card holds now: the device ledger's resident bytes (via
    ``spans._ledger_bytes``, which never imports ``core.memory``) or, where
    a CUDA context exists, torch's allocated bytes, whichever is larger."""
    from modin_tpu_torch.observability import spans as _spans

    resident = _spans._ledger_bytes()[0]
    torch = sys.modules.get("torch")
    try:
        if torch is not None and torch.cuda.is_initialized():
            resident = max(resident, int(torch.cuda.memory_allocated()))
    except Exception:
        pass
    return resident


def _process_peak_bytes() -> int:
    """torch's process peak of allocated bytes (0 without a context)."""
    torch = sys.modules.get("torch")
    try:
        if torch is not None and torch.cuda.is_initialized():
            return int(torch.cuda.max_memory_allocated())
    except Exception:
        pass
    return 0


# ---------------------------------------------------------------------- #
# per-query accounting
# ---------------------------------------------------------------------- #


class QueryStats:
    """Everything one query scope consumed, rolled up from the metric
    stream on the owning thread (plus HBM residency samples)."""

    __slots__ = (
        "label",
        "signature",
        "wall_s",
        "dispatches",
        "compiles",
        "compile_s",
        "bytes_parsed",
        "io_reads",
        "spills",
        "spill_bytes",
        "restores",
        "recoveries",
        "cache_hits",
        "hbm_high_water",
        "api_calls",
        "est_flops",
        "est_bytes",
        "padded_bytes",
        "padding_waste_bytes",
        "collective_bytes",
        "breaker_trips",
        "stream_windows",
        "stream_replays",
        "stream_overlap_s",
        "stream_wait_s",
        "fused_dispatches",
        "donated_bytes",
        "view_hits",
        "view_folds",
        "view_invalidations",
        "_t0",
        "_peak0",
        "_lock",
        "_closed",
    )

    def __init__(self, label: str = "query") -> None:
        global _alloc_count
        _alloc_count += 1
        self.label = label
        # routing can cross threads (the resilience watchdog seeds its
        # worker with the owner's scopes, and a timed-out worker is
        # abandoned mid-thunk): accumulation takes this lock, and a closed
        # scope stops accepting so late emissions from an abandoned worker
        # can never mutate a rollup the owner already read
        self._lock = named_lock("meters.query_stats")
        self._closed = False
        self.signature = None  # innermost QUERY-COMPILER span, if tracing
        self.wall_s = 0.0
        self.dispatches = 0
        self.compiles = 0
        self.compile_s = 0.0
        self.bytes_parsed = 0
        self.io_reads = 0
        self.spills = 0
        self.spill_bytes = 0
        self.restores = 0
        self.recoveries = 0
        self.cache_hits = {"fused": 0, "sorted_rep": 0, "plan_scan": 0}
        self.hbm_high_water = 0
        self.api_calls = 0
        # estimated hardware cost + padding waste (0 until the
        # cost-capture seams observe work under this scope)
        self.est_flops = 0.0
        self.est_bytes = 0.0
        self.padded_bytes = 0
        self.padding_waste_bytes = 0
        # bytes of the range shuffle's block exchanges under this scope
        self.collective_bytes = 0
        # device-path breaker strikes observed
        # while this scope's query ran (its own fallbacks included — a
        # query can complete correct via fallback yet be striking paths)
        self.breaker_trips = 0
        # streamed windows, their replays and the prefetch overlap/wait
        # split
        self.stream_windows = 0
        self.stream_replays = 0
        self.stream_overlap_s = 0.0
        self.stream_wait_s = 0.0
        # masked fused legs (one launch per query segment) and the device
        # bytes released by donation under this scope
        self.fused_dispatches = 0
        self.donated_bytes = 0
        # derived-artifact registry traffic under this scope —
        # whole results served from cache, appends absorbed by folds, and
        # artifacts honestly invalidated
        self.view_hits = 0
        self.view_folds = 0
        self.view_invalidations = 0
        self._peak0 = _process_peak_bytes()
        self._t0 = time.perf_counter()

    # -- stream routing -------------------------------------------------- #

    def _on_metric(self, name: str, value: Union[int, float]) -> None:
        with self._lock:
            if self._closed:
                return
            self._route(name, value)

    def _route(self, name: str, value: Union[int, float]) -> None:
        if name == "engine.dispatch":
            self.dispatches += int(value)
            self._sample_hbm()
        elif name == "engine.compile":
            self.compiles += int(value)
        elif name == "engine.compile_s":
            self.compile_s += value
        elif name == "io.read.bytes":
            self.bytes_parsed += int(value)
            self.io_reads += 1
        elif name == "memory.device.spill":
            self.spills += int(value)
            self._sample_hbm()
        elif name in ("memory.device.spill_bytes", "stream.spill.run_bytes"):
            self.spill_bytes += int(value)
        elif name == "stream.window.bytes":
            self.bytes_parsed += int(value)
        elif name == "stream.window.count":
            self.stream_windows += int(value)
            self._sample_hbm()
        elif name == "stream.window.replay":
            self.stream_replays += int(value)
        elif name == "stream.prefetch.overlap_s":
            self.stream_overlap_s += value
        elif name == "stream.prefetch.wait_s":
            self.stream_wait_s += value
        elif name == "memory.device.restore":
            self.restores += int(value)
            self._sample_hbm()
        elif name == "engine.cost.flops":
            self.est_flops += value
        elif name == "engine.cost.bytes":
            self.est_bytes += value
        elif name == "engine.cost.padded_bytes":
            self.padded_bytes += int(value)
        elif name == "engine.cost.padding_waste_bytes":
            self.padding_waste_bytes += int(value)
        elif name == "engine.cost.collective_bytes":
            self.collective_bytes += int(value)
        elif name == "sortcache.hit":
            self.cache_hits["sorted_rep"] += int(value)
        elif name == "fusion.cache.hit":
            self.cache_hits["fused"] += int(value)
        elif name == "plan.scan.cache_hit":
            self.cache_hits["plan_scan"] += int(value)
        elif name == "fuse.dispatch":
            self.fused_dispatches += int(value)
            self._sample_hbm()
        elif name == "fuse.donated":
            # fired BEFORE the donated buffers leave the ledger: the last
            # honest pre-donation residency peak
            self._sample_hbm()
        elif name == "fuse.donated_bytes":
            self.donated_bytes += int(value)
            self._sample_hbm()
        elif name == "view.hit":
            self.view_hits += int(value)
        elif name == "view.fold":
            self.view_folds += int(value)
        elif name.startswith("view.invalidate."):
            self.view_invalidations += int(value)
        elif name.startswith("recovery."):
            self.recoveries += int(value)
        elif (
            name.startswith("resilience.breaker.")
            and name.endswith(".strike")
            and not name.startswith("resilience.breaker.tenant_")
        ):
            # device-path strikes only: a nested submit's tenant-health
            # strike (the gate records it on this thread while the outer
            # scope is open) is a serving verdict, and counting it would
            # cascade one tenant's failures into the outer tenant's
            # quarantine
            self.breaker_trips += int(value)
        elif name.startswith("pandas-api."):
            self.api_calls += 1

    def _sample_hbm(self) -> None:
        resident = _device_resident_bytes()
        if resident > self.hbm_high_water:
            self.hbm_high_water = resident

    def elapsed_s(self) -> float:
        """Wall seconds so far (final wall once the scope has closed)."""
        if self._closed:
            return self.wall_s
        return time.perf_counter() - self._t0

    # -- export ---------------------------------------------------------- #

    def as_dict(self) -> dict:
        return {
            "label": self.label,
            "signature": self.signature,
            "wall_s": self.wall_s,
            "dispatches": self.dispatches,
            "compiles": self.compiles,
            "compile_s": self.compile_s,
            "bytes_parsed": self.bytes_parsed,
            "io_reads": self.io_reads,
            "spills": self.spills,
            "spill_bytes": self.spill_bytes,
            "restores": self.restores,
            "recoveries": self.recoveries,
            "cache_hits": dict(self.cache_hits),
            "hbm_high_water": self.hbm_high_water,
            "api_calls": self.api_calls,
            "est_flops": self.est_flops,
            "est_bytes": self.est_bytes,
            "padded_bytes": self.padded_bytes,
            "padding_waste_bytes": self.padding_waste_bytes,
            "collective_bytes": self.collective_bytes,
            "breaker_trips": self.breaker_trips,
            "stream_windows": self.stream_windows,
            "stream_replays": self.stream_replays,
            "stream_overlap_s": self.stream_overlap_s,
            "stream_wait_s": self.stream_wait_s,
            "fused_dispatches": self.fused_dispatches,
            "donated_bytes": self.donated_bytes,
            "view_hits": self.view_hits,
            "view_folds": self.view_folds,
            "view_invalidations": self.view_invalidations,
        }

    def summary(self) -> str:
        """Human-readable rollup block for EXPLAIN ANALYZE output."""
        hits = ", ".join(f"{k}={v}" for k, v in sorted(self.cache_hits.items()))
        lines = [
            f"wall: {self.wall_s * 1e3:.3f} ms",
            f"engine dispatches: {self.dispatches}, builds and lowerings: "
            f"{self.compiles} ({self.compile_s:.3f}s)",
            f"bytes parsed: {self.bytes_parsed} ({self.io_reads} read(s))",
            f"device high-water: {self.hbm_high_water} bytes, spills: "
            f"{self.spills} ({self.spill_bytes} bytes), restores: "
            f"{self.restores}, recoveries: {self.recoveries}",
            f"cache hits: {hits}",
            self._cost_line(),
        ]
        if self.collective_bytes:
            lines.append(f"collective: {self.collective_bytes} bytes exchanged between row shards")
        if self.fused_dispatches:
            lines.append(
                f"fuse: {self.fused_dispatches} whole-plan dispatch(es), "
                f"{self.donated_bytes} bytes donated"
            )
        if self.view_hits or self.view_folds or self.view_invalidations:
            lines.append(
                f"views: {self.view_hits} artifact hit(s), "
                f"{self.view_folds} incremental fold(s), "
                f"{self.view_invalidations} invalidation(s)"
            )
        if self.stream_windows:
            busy = self.stream_overlap_s + self.stream_wait_s
            eff = f"{self.stream_overlap_s / busy:.0%}" if busy > 0 else "?"
            lines.append(
                f"stream: {self.stream_windows} window(s), "
                f"{self.stream_replays} replay(s), overlap efficiency {eff} "
                f"({self.stream_overlap_s:.3f}s hidden, "
                f"{self.stream_wait_s:.3f}s waited)"
            )
        return "\n".join(lines)

    def _cost_line(self) -> str:
        """The cost rollup line: estimated work, padding share, and
        the achieved roofline fraction joined to this scope's wall."""
        from modin_tpu_torch.observability import costs as _costs

        pad_pct = (
            f"{self.padding_waste_bytes / self.padded_bytes:.0%}"
            if self.padded_bytes > 0
            else "?"
        )
        roofline = "?"
        try:
            fraction = _costs.roofline_fraction(
                self.est_flops or None, self.est_bytes or None, self.wall_s
            )
            if fraction is not None:
                roofline = f"{fraction:.1%}"
        except Exception:
            pass
        return (
            f"est cost: {self.est_flops:.3g} flops, "
            f"{self.est_bytes:.3g} bytes moved; padding waste: "
            f"{self.padding_waste_bytes} of {self.padded_bytes} padded "
            f"bytes ({pad_pct}); roofline: {roofline}"
        )


def snapshot_scopes() -> Optional[List["QueryStats"]]:
    """Copy of this thread's open QueryStats stack (outermost first), or None.

    Mirrors ``spans.snapshot_stack()``: worker threads that run a query's
    work on the caller's behalf (the resilience watchdog) seed themselves
    with this so metrics they emit still roll into the owning query's
    scopes.
    """
    stack = getattr(_qs_tls, "stack", None)
    return list(stack) if stack else None


def seed_thread_scopes(scopes: Optional[List["QueryStats"]]) -> None:
    """Adopt a snapshot of another thread's QueryStats stack.

    The seeded scopes are owned, entered, and exited by their original
    thread — this thread only routes its emissions into them.  Accumulation
    is lock-guarded and a closed scope stops accepting, so a worker the
    owner abandoned (watchdog timeout) can race the owner's retry or
    outlive the scope without corrupting its rollup.

    Always REPLACES the thread's stack — seeding with ``None``/empty
    clears it.  The previous keep-if-falsy behavior was a single-owner
    assumption: a pooled worker seeded for query A and later reused for
    unscoped work (or query B) kept routing emissions into A's closed
    scopes — closed-scope rejection hid the corruption, but a *still-open*
    outer scope on the original thread would have silently absorbed
    another query's metrics.
    """
    _qs_tls.stack = list(scopes) if scopes else []


@contextlib.contextmanager
def query_stats(label: str = "query") -> Iterator[QueryStats]:
    """Collect per-query resource accounting for the block on this thread.

    Activates accounting for its duration even when ``MODIN_TPU_TORCH_METERS`` is
    off (that is the point: ad-hoc EXPLAIN ANALYZE without a process
    restart).  Scopes nest (inner metrics roll into every open scope on the
    stack) and are thread-isolated.  The scope is seeded from the innermost
    QUERY-COMPILER span open on this thread when tracing is active.
    """
    global _active_scopes
    qs = QueryStats(label)
    from modin_tpu_torch.observability import spans as _spans

    if _spans.TRACE_ON:
        sig = _spans.attribution_signature()
        if sig != "<untraced>":
            qs.signature = sig
    with _scope_lock:
        _active_scopes += 1
        _refresh_enabled()
    stack = getattr(_qs_tls, "stack", None)
    if stack is None:
        stack = _qs_tls.stack = []
    stack.append(qs)
    try:
        yield qs
    finally:
        with qs._lock:
            qs.wall_s = time.perf_counter() - qs._t0
            qs._sample_hbm()
            peak = _process_peak_bytes()
            if peak > qs._peak0:
                # the process peak rose inside the scope: it is the scope's
                qs.hbm_high_water = max(qs.hbm_high_water, peak)
            qs._closed = True
        try:
            stack.remove(qs)
        except ValueError:
            pass
        with _scope_lock:
            _active_scopes -= 1
            _refresh_enabled()


# wire the config switch (fires immediately with its current value)
from modin_tpu_torch.config import MetersEnabled as _MetersEnabled  # noqa: E402

_MetersEnabled.subscribe(_on_meters_param)
