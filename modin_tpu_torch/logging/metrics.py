"""Metrics: named-handler fan-out, isolated from handler failures.

The port's counterpart of ``modin_tpu/logging/metrics.py``.  ``emit_metric``
sends ``modin_tpu_torch.<name> = value`` to every registered handler, and
the meter layer (``observability/meters.py``) taps the same stream: while
aggregation is on it installs ``_aggregate`` and every emitted value also
folds into the in-process registry and the open ``query_stats()`` scopes.
With no handler registered (or ``MetricsMode`` Disable) and aggregation
off, an emission reads two module attributes and returns.

Events the port also counts while nothing listens (the fault, memory,
router and views layers') go through :func:`emit_counted`: one always-on
tally, then the same emission.  ``resilience.COUNTS``, ``memory.COUNTS``/
``SECONDS``, ``router.COUNTS`` and ``views/registry.COUNTS`` are
:class:`CountView` reads of that tally, where the tests and
``chip_smoke.py`` read them.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Callable, Dict, Iterable, Iterator, Optional, Union

from modin_tpu_torch.concurrency import named_lock

_metric_handlers: list = []
_metric_name_pattern = re.compile(r"^[a-zA-Z0-9\-_\.]+$")

#: the meter layer's aggregation hook: None while aggregation is off, else
#: ``meters._dispatch_metric`` (meters on, or a ``query_stats()`` scope open)
_aggregate: Optional[Callable[[str, Union[int, float]], None]] = None

#: a handler is registered and ``MetricsMode`` is Enable: kept by
#: :func:`_refresh_handlers`, so an emission never reads the setting
_handlers_on: bool = False

#: every metric family the port emits: (name pattern, meter kind, what it
#: counts).  ``*`` stands for a runtime segment (an engine op, a breaker
#: family, a failure kind, a kernel).  The kind tells the meter layer how
#: to fold the family: ``counter`` (sum), ``gauge`` (last value, min/max)
#: or ``histogram`` (the buckets of ``meters.HISTOGRAM_BUCKETS``).  The
#: JAX package's names are kept where the port emits the same event; the
#: families of layers the port has not ported (ingest, durability, fleet,
#: watch) are left out until their layers come.
METRICS = (
    (
        "resilience.engine.*.*",
        "counter",
        "engine-seam outcomes per op: oom / device_lost / transient / "
        "watchdog_timeout classifications and retry attempts",
    ),
    (
        "resilience.watchdog.*.timeout",
        "counter",
        "materialize/wait attempts killed by the wall-clock watchdog",
    ),
    (
        "resilience.breaker.*.*",
        "counter",
        "circuit-breaker lifecycle per device-path family: state "
        "transitions (open/half_open/closed), strikes, latency-budget "
        "violations (slow), and open-breaker short_circuits",
    ),
    (
        "resilience.fallback.*.*",
        "counter",
        "device failures converted to pandas fallbacks, per family and "
        "failure kind (only where the port runs on the CPU)",
    ),
    (
        "resilience.raised.*.*",
        "counter",
        "device failures the legs did not absorb, raised on the card per "
        "family and failure kind (pandas never answers for the card)",
    ),
    (
        "resilience.shuffle.slack_retry",
        "counter",
        "range_shuffle capacity overflows retried with doubled slack",
    ),
    (
        "resilience.shuffle.skew_fallback",
        "counter",
        "range_shuffle giving up on pathologically skewed keys "
        "(ShuffleSkewError: the caller's local path answers)",
    ),
    (
        "resilience.device_path.*.retry",
        "counter",
        "retries of a direct launch's transient error inside a device path",
    ),
    (
        "engine.dispatch",
        "counter",
        "successful engine-seam deploys; emitted while meter accounting is "
        "active (meters on or a QueryStats scope)",
    ),
    (
        "engine.compile",
        "counter",
        "the port's compiles: nvcc builds of a kernel source and host "
        "lowerings of a fused program (a program-cache miss)",
    ),
    (
        "engine.compile_s",
        "counter",
        "wall seconds of the builds and lowerings of engine.compile",
    ),
    (
        "engine.cost.flops",
        "counter",
        "operations of the ledgered kernel launches, counted from each "
        "wrapper's shapes (one a row per combine or instruction)",
    ),
    (
        "engine.cost.bytes",
        "counter",
        "bytes the ledgered kernel launches must move, from each wrapper's "
        "shapes: every input read once, every output written once",
    ),
    (
        "engine.cost.padded_bytes",
        "counter",
        "physical bytes of padded device allocations observed at the "
        "padding sites (group slots, rounded histogram widths)",
    ),
    (
        "engine.cost.padding_waste_bytes",
        "counter",
        "the pad share of engine.cost.padded_bytes: physical minus "
        "logical bytes",
    ),
    (
        "engine.cost.collective_bytes",
        "counter",
        "payload bytes of the range shuffle's block exchange between the "
        "row shards (every routed column's [S, S, capacity] blocks): the "
        "traffic term of the layout router's sharded-vs-local model",
    ),
    (
        "engine.cost.peaks_unreadable",
        "counter",
        "reads of the cached peak table that failed: every roofline "
        "fraction then reads unknown",
    ),
    (
        "kernel.launch.*",
        "counter",
        "launches of one hand-written CUDA kernel (bincount / scan / fused "
        "/ groupagg), counted at its wrapper while the launch ledger is on",
    ),
    (
        "kernel.rows.*",
        "counter",
        "rows the launches of one kernel read",
    ),
    (
        "kernel.build.*",
        "counter",
        "nvcc builds of one kernel source (csrc/<name>.cu) by this process",
    ),
    (
        "io.read.bytes",
        "histogram",
        "bytes per FileDispatcher read (source file size, best-effort; "
        "emitted while meter accounting is active)",
    ),
    (
        "concurrency.lockdep.violation",
        "counter",
        "lock-order violations the runtime lockdep validator detected "
        "(MODIN_TPU_TORCH_LOCKDEP=1): self-deadlock, same-name instance pair, "
        "declared-order contradiction, or observed ABBA inversion",
    ),
    (
        "recovery.device_lost",
        "counter",
        "device-lost events entering the lineage-recovery manager",
    ),
    (
        "recovery.reseat.*",
        "counter",
        "device columns re-seated from lineage, per provenance kind "
        "(host / io / op)",
    ),
    (
        "recovery.unrecoverable",
        "counter",
        "live device columns whose lineage could not reproduce their "
        "tensor during a recovery pass",
    ),
    (
        "recovery.checkpoint_cut",
        "counter",
        "op-replay lineage chains cut by a host checkpoint at "
        "MODIN_TPU_TORCH_LINEAGE_MAX_DEPTH",
    ),
    (
        "recovery.retry.*",
        "counter",
        "engine-seam attempts retried after a recovery action: device_lost "
        "(lineage re-seat) or oom (evict-then-retry)",
    ),
    (
        "memory.device.spill",
        "counter",
        "device columns spilled to host by admission control or the OOM "
        "evict-then-retry leg",
    ),
    (
        "memory.device.spill_bytes",
        "counter",
        "device bytes freed by spills",
    ),
    (
        "memory.device.spill_copy",
        "counter",
        "spilled columns fetched to the host (the rest had a host copy)",
    ),
    (
        "memory.device.spill_copy_bytes",
        "counter",
        "bytes of the device-to-host copies of spills",
    ),
    (
        "memory.device.spill_failed",
        "counter",
        "columns whose host copy did not fit in host memory, kept resident",
    ),
    (
        "memory.device.restore",
        "counter",
        "spilled columns re-seated on the device on access",
    ),
    (
        "memory.device.restore_bytes",
        "counter",
        "bytes of the host-to-device copies of restores",
    ),
    (
        "memory.device.*_s",
        "counter",
        "wall seconds of the spill copies and the restores",
    ),
    (
        "memory.device.resident_bytes",
        "gauge",
        "device-ledger resident bytes after each spill pass",
    ),
    (
        "memory.host.cache_bytes",
        "gauge",
        "bytes of exact host copies held by the spill ledger after each "
        "spill pass",
    ),
    (
        "router.*.*",
        "counter",
        "kernel-router verdicts per op family and chosen side "
        "(device / host / view / local / fused / staged)",
    ),
    (
        "router.calibrate",
        "counter",
        "one-shot kernel-router calibration passes",
    ),
    (
        "sortcache.*",
        "counter",
        "sorted-representation cache traffic: hit / build / spill",
    ),
    (
        "view.hit",
        "counter",
        "whole results answered from the artifact cache",
    ),
    (
        "view.miss",
        "counter",
        "artifact-cache lookups that found nothing current",
    ),
    (
        "view.build",
        "counter",
        "artifacts cached after a from-scratch computation",
    ),
    (
        "view.fold",
        "counter",
        "appends absorbed by an incremental fold instead of a recompute",
    ),
    (
        "view.invalidate.*",
        "counter",
        "artifacts dropped, per reason (write, spill, restore, donation, "
        "materialization, recovery epoch)",
    ),
    (
        "view.evict",
        "counter",
        "artifacts evicted by the entry or host-byte bounds",
    ),
    (
        "view.spill",
        "counter",
        "derived artifacts dropped by the device ledger under pressure",
    ),
    (
        "view.chain_compact",
        "counter",
        "fold chains compacted at MODIN_TPU_TORCH_VIEWS_MAX_CHAIN",
    ),
    (
        "plan.defer.scan",
        "counter",
        "reads deferred into a Scan-rooted plan instead of parsing at the "
        "call site",
    ),
    (
        "plan.optimize.passes",
        "histogram",
        "rewrite passes to fixpoint per plan materialization",
    ),
    (
        "plan.rule.*",
        "counter",
        "plan rewrite rules applied, per rule",
    ),
    (
        "plan.lower.nodes",
        "histogram",
        "distinct plan nodes lowered per materialization",
    ),
    (
        "plan.scan.pruned_columns",
        "counter",
        "columns a pushed-down projection kept a scan from parsing",
    ),
    (
        "plan.scan.cache_hit",
        "counter",
        "Scan leaves served from the parsed-columns cache",
    ),
    (
        "plan.scan.cache_evict",
        "counter",
        "parsed-column entries evicted by MODIN_TPU_TORCH_PLAN_SCAN_CACHE_BYTES",
    ),
    (
        "stream.window.count",
        "counter",
        "resident windows completed by the out-of-core executor (scan "
        "window loops and external-sort windows)",
    ),
    (
        "stream.window.rows",
        "counter",
        "rows processed per streaming window (parse or sort slice)",
    ),
    (
        "stream.window.bytes",
        "counter",
        "source bytes parsed per streaming scan window (record-aligned "
        "byte range)",
    ),
    (
        "stream.window.replay",
        "counter",
        "windows replayed after a device failure the seams did not absorb: "
        "one window's byte range parsed and run again, never the dataset",
    ),
    (
        "stream.prefetch.wait_s",
        "counter",
        "seconds the consuming thread waited on the prefetch worker per "
        "window (0 when the parse hid behind the previous window's work)",
    ),
    (
        "stream.prefetch.overlap_s",
        "counter",
        "seconds of a window's parse and upload hidden behind the previous "
        "window's consume (parse wall less the consumer's wait, at least 0)",
    ),
    (
        "stream.degrade",
        "counter",
        "streamed groupbys degraded to the resident path because the "
        "partial table passed MODIN_TPU_TORCH_STREAM_MAX_GROUPS groups",
    ),
    (
        "stream.spill.run_bytes",
        "counter",
        "host bytes of the sorted runs the external sort wrote (merge keys "
        "and row ids per window)",
    ),
    (
        "opt.choose",
        "counter",
        "joint strategy passes over an optimized plan (MODIN_TPU_TORCH_OPT=Auto)",
    ),
    (
        "opt.replan.*",
        "counter",
        "mid-query re-plans, per trigger",
    ),
    (
        "fusion.cache.hit",
        "counter",
        "fused programs served from the program cache instead of lowered "
        "again (emitted while meter accounting is active)",
    ),
    (
        "fusion.cache.evict",
        "counter",
        "fused programs evicted by MODIN_TPU_TORCH_FUSED_CACHE_SIZE",
    ),
    (
        "fuse.dispatch",
        "counter",
        "masked fused legs run as one launch (a filter/map chain with its "
        "reduction or groupby tail)",
    ),
    (
        "fuse.decline",
        "counter",
        "plan segments the fused leg declined (the staged path ran)",
    ),
    (
        "fuse.donated",
        "counter",
        "scan columns donated to a fused launch (sole holder, under a budget)",
    ),
    (
        "fuse.donated_bytes",
        "counter",
        "device bytes freed by donations",
    ),
    (
        "fuse.donated_restore",
        "counter",
        "donated columns read again (re-seated from lineage)",
    ),
    (
        "pandas-api.*",
        "histogram",
        "wall-clock seconds per public pandas-API call (logging layer)",
    ),
    (
        "trace.flight_dump",
        "counter",
        "flight-recorder dumps written on a breaker opening or a terminal "
        "device failure",
    ),
    (
        "serving.admit",
        "counter",
        "queries admitted by the serving gate (serving/)",
    ),
    (
        "serving.queued",
        "counter",
        "admissions that waited in the bounded queue before a slot opened",
    ),
    (
        "serving.queue_wait_s",
        "histogram",
        "seconds an admitted query spent in the admission queue",
    ),
    (
        "serving.shed",
        "counter",
        "queries rejected with a typed QueryRejected (queue_full, throttled, "
        "unhealthy, and on the card degraded) before any work ran",
    ),
    (
        "serving.deadline_exceeded",
        "counter",
        "queries aborted by their latency budget (typed DeadlineExceeded "
        "at a seam or while queued)",
    ),
    (
        "serving.degraded",
        "counter",
        "admissions while a device-path breaker was open or the device "
        "ledger was past the degraded high-water fraction: routed to pandas "
        "on the CPU, shed on the card",
    ),
    (
        "serving.degraded.fallback",
        "counter",
        "device-path families short-circuited to pandas because the running "
        "query was admitted in degraded mode (CPU only)",
    ),
    (
        "serving.query_wall_s",
        "histogram",
        "wall seconds per submitted query (admission to result)",
    ),
    (
        "serving.tenant.*.*",
        "counter",
        "per-tenant serving outcomes: admit, complete, degraded, deadline, "
        "device_failure, and the shed reasons (queue_full, throttled, "
        "unhealthy)",
    ),
)


def _refresh_handlers() -> None:
    global _handlers_on
    from modin_tpu_torch.config import MetricsMode

    _handlers_on = bool(_metric_handlers) and MetricsMode.get() != "Disable"
    from modin_tpu_torch.logging import logger_decorator

    logger_decorator.refresh()


def emit_metric(name: str, value: Union[int, float]) -> None:
    """Send ``modin_tpu_torch.<name> = value`` to every registered handler
    and to the meter layer while it aggregates.  ``MetricsMode=Disable``
    silences the handlers only: an open ``query_stats()`` scope still
    accounts."""
    aggregate = _aggregate
    if aggregate is None and not _handlers_on:
        return
    if not _metric_name_pattern.fullmatch(name):
        raise KeyError(f"Metrics name is not in metric-name dot format, e.g. a.b.c : {name}")
    if aggregate is not None:
        aggregate(name, value)
    if not _handlers_on:
        return
    for fn in list(_metric_handlers):
        try:
            fn(f"modin_tpu_torch.{name}", value)
        except Exception:
            # a broken handler must never break the call it instruments
            _metric_handlers.remove(fn)


def add_metric_handler(handler: Callable[[str, Union[int, float]], None]) -> None:
    _metric_handlers.append(handler)
    _refresh_handlers()


def clear_metric_handler(handler: Callable[[str, Union[int, float]], None]) -> None:
    if handler in _metric_handlers:
        _metric_handlers.remove(handler)
    _refresh_handlers()


#: the always-on tally of :func:`emit_counted`, by metric name (only names
#: that occurred are present)
_counted: Dict[str, Union[int, float]] = {}
_counted_lock = named_lock("metrics.counted")


def emit_counted(name: str, value: Union[int, float] = 1) -> None:
    """Add ``value`` to the tally of ``name``, then :func:`emit_metric` it."""
    with _counted_lock:
        _counted[name] = _counted.get(name, 0) + value
    emit_metric(name, value)


class CountView(Mapping):
    """A read of the tally: the names under ``prefixes`` that occurred, and
    every name of ``names`` (0 until it occurs).  ``suffix`` is appended to a
    key to find its tally (seconds are counted as ``<name>_s``)."""

    def __init__(self, prefixes: tuple = (), names: Iterable[str] = (), suffix: str = "") -> None:
        self._prefixes = tuple(prefixes)
        self._names = tuple(names)
        self._suffix = suffix

    def _keys(self) -> list:
        with _counted_lock:
            seen = [k for k in _counted if self._prefixes and k.startswith(self._prefixes)]
        return list(self._names) + [k for k in seen if k not in self._names]

    def __getitem__(self, key: str) -> Union[int, float]:
        with _counted_lock:
            value = _counted.get(key + self._suffix)
        if value is not None and (key in self._names or (self._prefixes and key.startswith(self._prefixes))):
            return value
        if key in self._names:
            return 0
        raise KeyError(key)

    def __iter__(self) -> Iterator[str]:
        return iter(self._keys())

    def __len__(self) -> int:
        return len(self._keys())

    def clear(self) -> None:
        """Drop the tallies this view reads."""
        with _counted_lock:
            for key in [k for k in _counted if (self._prefixes and k.startswith(self._prefixes))
                        or (k.endswith(self._suffix) and k[: len(k) - len(self._suffix)] in self._names)]:
                del _counted[key]
