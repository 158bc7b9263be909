"""Configuration of the torch port, read from ``MODIN_TPU_TORCH_*`` variables.

The port's counterpart of ``modin_tpu/config/envvars.py``, cut to what the
port runs: the device that holds the columns, the widest key range that
groupby codes directly instead of sorting, the widest value range that
``nunique``/``mode`` count with a histogram instead of sorting, the
threads that parse a file in parallel, the bound on the cache of fused
programs, the whole-query planner's knobs (``PlanMode``,
``PlanMaxPasses``, ``PlanScanCacheBytes``, ``FuseMode``, ``FuseMinRows``),
the kernel router's (``KernelRouterMode``, ``KernelRouterMinRows``,
``KernelRouterCalibrationRows``, ``CacheDir``), the memory budgets
(``Memory``, ``DeviceMemoryBudget``), the out-of-core streaming
executor's (``StreamMode``, ``StreamWindowBytes``, ``StreamPrefetch``,
``StreamMaxGroups``), the plan optimizer's
(``OptMode``, ``OptReplanFactor``) and the derived-artifact cache's
(``ViewsMode``, ``ViewsMaxEntries``, ``ViewsHostBudget``,
``ViewsMaxGroups``, ``ViewsMaxChain``) and the row-shard mesh's
(``DeviceCount``, ``MeshShape``, ``RangePartitioning``, ``SpmdMode``,
``SpmdMinRows``), multi-tenant serving's (``ServingEnabled``,
``ServingMaxConcurrent``, ``ServingQueueDepth``,
``ServingDefaultDeadlineMs``, ``ServingTenantWeights``,
``ServingDegradedHighWater``) and the lock-order validator's
(``LockdepEnabled``); the port's own variable names, so
one process can pin the two packages apart.  A module that keeps a
setting in a variable of its own subscribes to it
(:meth:`Parameter.subscribe`) and sees every change.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any


#: a setting not read from its variable yet (None is a value: no budget)
_UNREAD = object()


class Parameter:
    """One setting: the environment variable when first read, until
    :meth:`put` replaces it."""

    varname: str = ""
    default: Any = None
    _value: Any = _UNREAD

    @classmethod
    def _parse(cls, raw: str) -> Any:
        return raw

    @classmethod
    def subscribe(cls, callback: Any) -> None:
        """Call ``callback(cls)`` now and after every change of the value."""
        if "_subs" not in cls.__dict__:
            cls._subs = []
        cls._subs.append(callback)
        callback(cls)

    @classmethod
    def _set(cls, value: Any) -> None:
        cls._value = value
        for callback in cls.__dict__.get("_subs", ()):
            callback(cls)

    @classmethod
    def get(cls) -> Any:
        if cls._value is _UNREAD:
            raw = os.environ.get(cls.varname)
            cls._value = cls.default if raw is None else cls._parse(raw)
        return cls._value

    @classmethod
    def put(cls, value: Any) -> None:
        cls._set(cls._parse(value) if isinstance(value, str) else value)

    @classmethod
    @contextlib.contextmanager
    def context(cls, value: Any):
        """The setting is ``value`` inside the ``with`` block."""
        old = cls.get()
        cls.put(value)
        try:
            yield
        finally:
            cls._set(old)


class _Choice(Parameter):
    """A setting that takes one of ``choices`` (any case; the canonical
    spelling is kept)."""

    choices: tuple = ()

    @classmethod
    def _parse(cls, raw: str) -> str:
        for choice in cls.choices:
            if raw.strip().lower() == choice.lower():
                return choice
        raise ValueError(f"{cls.varname} must be one of {cls.choices}, got {raw!r}")

    @classmethod
    def put(cls, value: Any) -> None:
        cls._set(cls._parse(str(value)))


class _Count(Parameter):
    """A non-negative int setting (``minimum`` its least value)."""

    minimum = 0

    @classmethod
    def _parse(cls, raw: str) -> int:
        value = int(raw)
        if value < cls.minimum:
            raise ValueError(f"{cls.varname} must be >= {cls.minimum}, got {raw!r}")
        return value

    @classmethod
    def put(cls, value: Any) -> None:
        cls._set(cls._parse(str(value)))


class _Bytes(_Count):
    """A byte count that may be unset (``None``: no budget)."""

    @classmethod
    def put(cls, value: Any) -> None:
        cls._set(None if value is None else cls._parse(str(value)))


class Device(_Choice):
    """Where device columns live: ``"cuda"`` (the default) or ``"cpu"``.

    With ``"cuda"`` and no usable card the entry points raise; nothing
    moves to the CPU unless asked for."""

    varname = "MODIN_TPU_TORCH_DEVICE"
    default = "cuda"
    choices = ("cuda", "cpu")


class GroupbyRangeLimit(_Count):
    """Widest int key range (max - min + 1) that factorizes by direct
    offset codes and one histogram; wider keys take the sort-based unique
    path.  Multi-key composite codes may span four times this."""

    varname = "MODIN_TPU_TORCH_GROUPBY_RANGE_LIMIT"
    default = 1 << 22
    minimum = 1


class KernelRouterHistBound(_Count):
    """Largest value range (max - min + 1) for which an integer column takes
    the O(n) histogram (the bincount kernel) for ``nunique``/``mode``
    instead of the O(n log n) sort."""

    varname = "MODIN_TPU_KERNEL_ROUTER_HIST_BOUND"
    default = 1 << 20
    minimum = 1


class CpuCount(_Count):
    """How many host threads parse the byte ranges of a file (the IO
    dispatchers' thread pool); the machine's CPU count by default."""

    varname = "MODIN_TPU_TORCH_CPUS"
    default = None
    minimum = 1

    @classmethod
    def get(cls) -> int:
        value = super().get()
        return value if value is not None else (os.cpu_count() or 1)


class FusedCacheSize(_Count):
    """Bound on the cache of compiled fused programs in ``ops/lazy.py``
    (entries, least recently used first out); 0 leaves it unbounded."""

    varname = "MODIN_TPU_TORCH_FUSED_CACHE_SIZE"
    default = 256


class PlanMode(_Choice):
    """Whole-query deferred planning (``plan/``).  Auto: a local plain-file
    ``read_csv``/``read_table`` defers into a plan, and plan-capable calls
    (project, filter, elementwise maps, reductions, groupby aggregations,
    sort) extend it until a materialization point optimizes and lowers it.
    Off: nothing defers (the eager port exactly).  Force: Auto, and
    plan-capable calls on eager compilers start plans too."""

    varname = "MODIN_TPU_TORCH_PLAN"
    choices = ("Auto", "Off", "Force")
    default = "Auto"


class PlanMaxPasses(_Count):
    """Pass budget of the planner's fixpoint rule engine."""

    varname = "MODIN_TPU_TORCH_PLAN_MAX_PASSES"
    default = 8
    minimum = 1


class PlanScanCacheBytes(_Count):
    """Byte bound on each deferred read's cache of materialized parses (one
    entry per projection, coldest first out); 0 disables it."""

    varname = "MODIN_TPU_TORCH_PLAN_SCAN_CACHE_BYTES"
    default = 1 << 28


class FuseMode(_Choice):
    """Whole-plan fusion (``plan/fuse.py``): a filter/map/project chain and
    its reduction or groupby run as masked fused launches with no
    compaction.  Auto: below ``FuseMinRows`` rows the query stays staged,
    and a groupby whose ``groupagg`` tables would not fit in shared memory
    too.  Staged: never.  Fused: wherever the plan's shape allows."""

    varname = "MODIN_TPU_TORCH_FUSE"
    choices = ("Auto", "Staged", "Fused")
    default = "Auto"


class FuseMinRows(_Count):
    """Row floor of the Auto whole-plan fusion decision: the fewest rows the
    fused leg was measured at.  The reference sets its floor (32 768) by
    XLA's trace and compile cost; the port compiles nothing per query.  On
    an H100 (``chip_smoke.py`` phase 13's route sweep, two runs, medians
    of 3) the fused leg of a filtered sum and of a groupby took 2.5-4.1 ms
    at 4096 and 32 768 rows, 0.14-0.49 ms less than the staged leg in all
    8 pairs; smaller frames were not measured."""

    varname = "MODIN_TPU_TORCH_FUSE_MIN_ROWS"
    default = 4096


class KernelRouterMode(_Choice):
    """Routing of the sort-shaped reductions (median, quantile, nunique,
    mode, describe's quantiles) between the device and pandas
    (``ops/router.py``).  Auto: a cost model calibrated once per card
    picks the side predicted faster; frames under ``KernelRouterMinRows``
    stay on the device.  Device: always the device.  Host: always pandas."""

    varname = "MODIN_TPU_TORCH_KERNEL_ROUTER"
    choices = ("Auto", "Device", "Host")
    default = "Auto"


class KernelRouterMinRows(_Count):
    """Rows under which Auto routing takes the device without consulting
    (or running) the calibration."""

    varname = "MODIN_TPU_TORCH_KERNEL_ROUTER_MIN_ROWS"
    default = 1 << 20


class KernelRouterCalibrationRows(_Count):
    """Rows the one-shot router calibration times its kernels at; the table
    is cached under ``CacheDir`` per card and torch version."""

    varname = "MODIN_TPU_TORCH_KERNEL_ROUTER_CALIBRATION_ROWS"
    default = 1 << 18
    minimum = 1


class CacheDir(Parameter):
    """Directory of the router's calibration table ("" keeps no table on
    disk); by default ``modin_tpu_torch/_build/cache`` in the checkout."""

    varname = "MODIN_TPU_TORCH_CACHE_DIR"

    @classmethod
    def get(cls) -> str:
        value = super().get()
        if value is None:
            here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            value = os.path.join(here, "_build", "cache")
        return value


class Memory(_Bytes):
    """Host bytes the columns' exact host copies (``DeviceColumn.host_cache``)
    may hold (unset: no budget); past it the coldest copies whose device
    tensor is authoritative are dropped (``core/memory.py``)."""

    varname = "MODIN_TPU_TORCH_MEMORY"


class DeviceMemoryBudget(_Bytes):
    """Device bytes the column tensors and sorted representations may hold
    (unset: no budget).  Before an upload or a fused launch that would pass
    it, the coldest entries spill to the host (derived ones first, dropped;
    then columns, kept as exact host copies) and restore on their next
    read (``core/memory.py``)."""

    varname = "MODIN_TPU_TORCH_DEVICE_MEMORY_BUDGET"


class StreamMode(_Choice):
    """Out-of-core residency (``streaming/``): Auto (the default) lets the
    kernel router's ``decide_residency`` stream an op whose estimated bytes
    pass the device ledger's headroom under ``DeviceMemoryBudget`` (no
    budget: always resident); Resident never streams; Windowed streams
    every op the streaming executor supports."""

    varname = "MODIN_TPU_TORCH_STREAM"
    choices = ("Auto", "Resident", "Windowed")
    default = "Auto"


class StreamWindowBytes(_Count):
    """Source bytes of one streamed window; 0 (the default) derives it from
    the budget so that ``1 + StreamPrefetch`` windows and a 2x kernel
    working set fit under it."""

    varname = "MODIN_TPU_TORCH_STREAM_WINDOW_BYTES"
    default = 0


class StreamPrefetch(_Count):
    """Windows parsed and uploaded ahead of the one being consumed: 1 (the
    default) overlaps window i+1's parse and upload with window i's
    kernels; 0 runs parse, upload, consume and drop serially."""

    varname = "MODIN_TPU_TORCH_STREAM_PREFETCH"
    default = 1


class StreamMaxGroups(_Count):
    """Distinct groups a streamed groupby's partial table may hold across
    windows; past it the query degrades to the resident path."""

    varname = "MODIN_TPU_TORCH_STREAM_MAX_GROUPS"
    default = 1 << 20
    minimum = 1


class OptMode(_Choice):
    """The plan optimizer (``plan/optimizer.py``).  Auto: each plan
    materialization annotates its nodes with strategy legs and estimates
    from the router's calibration (EXPLAIN shows them) and re-estimates
    the rest of a query whose node overshoots its estimate; no leg
    overrides a live router verdict yet (``plan/optimizer.py`` says why).
    Off: no optimizer state is built."""

    varname = "MODIN_TPU_TORCH_OPT"
    choices = ("Auto", "Off")
    default = "Auto"


class OptReplanFactor(Parameter):
    """How far a lowered node's wall may pass its plan-time estimate
    before the optimizer re-plans the rest of the query (> 1)."""

    varname = "MODIN_TPU_TORCH_OPT_REPLAN_FACTOR"
    default = 4.0

    @classmethod
    def _parse(cls, raw: Any) -> float:
        value = float(raw)
        if value <= 1.0:
            raise ValueError(f"{cls.varname} must be > 1, got {raw!r}")
        return value

    @classmethod
    def put(cls, value: Any) -> None:
        cls._set(cls._parse(value))


class _Positive(_Count):
    minimum = 1


class ViewsMode(_Choice):
    """The derived-artifact cache (``views/``): whole reduction results,
    nunique/mode/median answers and small groupby tables, kept per column
    token and shared by every query on the same tensors; a column grown by
    a row ``concat`` folds only its appended rows into the foldable ones.
    Auto: the query compiler consults and maintains them.  Off: no token is
    allocated and no hook runs (``views.VIEWS_ON``).  The sorted
    representations (``ops/sorted_cache.py``) are kept in both modes."""

    varname = "MODIN_TPU_TORCH_VIEWS"
    choices = ("Auto", "Off")
    default = "Auto"


class ViewsMaxEntries(_Positive):
    """Live artifacts the registry keeps; past it the coldest go."""

    varname = "MODIN_TPU_TORCH_VIEWS_MAX_ENTRIES"
    default = 4096


class ViewsHostBudget(_Positive):
    """Host bytes of artifact state (scalar results, groupby tables) the
    registry keeps; past it the coldest artifacts go.  Device payloads are
    the device ledger's (``DeviceMemoryBudget``), which drops them before
    any column."""

    varname = "MODIN_TPU_TORCH_VIEWS_HOST_BUDGET"
    default = 128 * 1024 * 1024


class ViewsMaxGroups(_Positive):
    """Groups a cached groupby table may have: a result with more is
    neither cached nor folded."""

    varname = "MODIN_TPU_TORCH_VIEWS_MAX_GROUPS"
    default = 65536


class ViewsMaxChain(_Positive):
    """Append links a fold lookup walks at most; a column whose chain is
    deeper has its link re-anchored past ancestors that hold no artifact."""

    varname = "MODIN_TPU_TORCH_VIEWS_MAX_CHAIN"
    default = 64


class _Seconds(Parameter):
    """A non-negative float of seconds."""

    @classmethod
    def _parse(cls, raw: Any) -> float:
        value = float(raw)
        if value < 0:
            raise ValueError(f"{cls.varname} must be >= 0, got {raw!r}")
        return value

    @classmethod
    def put(cls, value: Any) -> None:
        cls._set(cls._parse(value))


class ResilienceMode(_Choice):
    """Fault-tolerant device execution (``core/execution/resilience.py``).
    Enable: device failures at the engine seam and in the ``_try_*`` device
    paths are classified (DeviceOOM, DeviceLost, TransientDeviceError),
    transient ones retried with backoff, and each device path family is
    guarded by a circuit breaker that degrades it to pandas while it is
    unhealthy.  Disable: torch's own errors propagate as they are."""

    varname = "MODIN_TPU_TORCH_RESILIENCE_MODE"
    choices = ("Enable", "Disable")
    default = "Enable"


class ResilienceRetries(_Count):
    """Retries of a TransientDeviceError at the engine seam."""

    varname = "MODIN_TPU_TORCH_RESILIENCE_RETRIES"
    default = 2


class ResilienceBackoffS(_Seconds):
    """Base of the exponential retry backoff, seconds (doubles per retry)."""

    varname = "MODIN_TPU_TORCH_RESILIENCE_BACKOFF_S"
    default = 0.05


class ResilienceWatchdogS(_Seconds):
    """Wall-clock watchdog on ``materialize``/``wait``, seconds (0: off).
    A fetch that outlives it raises WatchdogTimeout (a DeviceLost).  Off by
    default: every watched call costs one thread handoff."""

    varname = "MODIN_TPU_TORCH_RESILIENCE_WATCHDOG_S"
    default = 0.0


class ResilienceBreakerThreshold(_Positive):
    """Consecutive strikes (failures or latency violations) that open a
    device path family's circuit breaker."""

    varname = "MODIN_TPU_TORCH_RESILIENCE_BREAKER_THRESHOLD"
    default = 5


class ResilienceBreakerCooldownS(_Seconds):
    """Seconds an open breaker waits before it admits one probe."""

    varname = "MODIN_TPU_TORCH_RESILIENCE_BREAKER_COOLDOWN_S"
    default = 30.0


class ResilienceLatencyBudgetS(_Seconds):
    """Latency budget of one guarded device path call, seconds (0: none).
    A call that succeeds past it strikes its breaker."""

    varname = "MODIN_TPU_TORCH_RESILIENCE_LATENCY_BUDGET_S"
    default = 0.0


class RecoveryMode(_Choice):
    """Lineage recovery of device columns (``core/execution/recovery.py``).
    Enable: every DeviceColumn carries a lineage record (host, io, op or
    opaque); a DeviceLost re-seats the live columns from it and the failed
    call is retried once, and a DeviceOOM spills cold columns and retries
    (``SpillRetries`` rounds) before the family falls back.  Disable: both
    failures go straight to the breaker."""

    varname = "MODIN_TPU_TORCH_RECOVERY_MODE"
    choices = ("Enable", "Disable")
    default = "Enable"


class LineageMaxDepth(_Positive):
    """Longest op-replay chain a lineage record may carry; a column whose
    chain would be longer keeps an exact host copy instead (one fetch),
    which cuts the chain to depth 0."""

    varname = "MODIN_TPU_TORCH_LINEAGE_MAX_DEPTH"
    default = 8


class SpillRetries(_Count):
    """Evict-then-retry rounds a DeviceOOM gets before it is terminal
    (0: none)."""

    varname = "MODIN_TPU_TORCH_SPILL_RETRIES"
    default = 1


class SpillTargetFraction(Parameter):
    """Fraction of the resident device bytes one OOM eviction round tries
    to spill, coldest first (1.0: everything spillable)."""

    varname = "MODIN_TPU_TORCH_SPILL_TARGET_FRACTION"
    default = 0.5

    @classmethod
    def _parse(cls, raw: Any) -> float:
        value = float(raw)
        if not 0.0 < value <= 1.0:
            raise ValueError(f"{cls.varname} must be in (0, 1], got {raw!r}")
        return value

    @classmethod
    def put(cls, value: Any) -> None:
        cls._set(cls._parse(value))


# ---------------------------------------------------------------------- #
# Observability: logging, metrics, tracing, meters, cost capture
# ---------------------------------------------------------------------- #


class _Flag(Parameter):
    """An on/off setting (``1``/``true``/``yes``/``on`` or ``0``/...)."""

    default = False

    @classmethod
    def _parse(cls, raw: Any) -> bool:
        if isinstance(raw, bool):
            return raw
        text = str(raw).strip().lower()
        if text in ("1", "true", "yes", "on"):
            return True
        if text in ("0", "false", "no", "off", ""):
            return False
        raise ValueError(f"{cls.varname} must be a boolean, got {raw!r}")

    @classmethod
    def put(cls, value: Any) -> None:
        cls._set(cls._parse(value))

    @classmethod
    def enable(cls) -> None:
        cls.put(True)

    @classmethod
    def disable(cls) -> None:
        cls.put(False)


class _BuildPath(Parameter):
    """A directory, by default ``modin_tpu_torch/_build/<subdir>`` in the
    checkout (git-ignored)."""

    subdir = ""

    @classmethod
    def get(cls) -> str:
        value = super().get()
        if value is None:
            here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            value = os.path.join(here, "_build", cls.subdir)
        return value


class LogMode(_Choice):
    """START/STOP trace log of every logged call (``logging/``): Disable
    (the default), Enable (every layer) or Enable_Api_Only."""

    varname = "MODIN_TPU_TORCH_LOG_MODE"
    choices = ("Enable", "Disable", "Enable_Api_Only")
    default = "Disable"

    @classmethod
    def enable(cls) -> None:
        cls.put("Enable")

    @classmethod
    def disable(cls) -> None:
        cls.put("Disable")

    @classmethod
    def enable_api_only(cls) -> None:
        cls.put("Enable_Api_Only")


class LogDir(_BuildPath):
    """Directory of the trace and memory logs."""

    varname = "MODIN_TPU_TORCH_LOG_DIR"
    subdir = "logs"


class MetricsMode(_Choice):
    """API timing metrics to the registered handlers: Enable | Disable."""

    varname = "MODIN_TPU_TORCH_METRICS_MODE"
    choices = ("Enable", "Disable")
    default = "Enable"

    @classmethod
    def enable(cls) -> None:
        cls.put("Enable")

    @classmethod
    def disable(cls) -> None:
        cls.put("Disable")


class ProgressBar(_Flag):
    """A progress line for API calls that outlive half a second."""

    varname = "MODIN_TPU_TORCH_PROGRESS_BAR"


class MetersEnabled(_Flag):
    """In-process aggregation of the ``emit_metric`` stream into counters,
    gauges and histograms (``observability/meters.py``).  Off: one module
    attribute read per emission, no meter object made.  ``query_stats()``
    and ``explain(analyze=True)`` account for their scope regardless."""

    varname = "MODIN_TPU_TORCH_METERS"


class MetersMaxSeries(_Positive):
    """Most distinct metric names the meter registry holds; names past it
    are dropped and counted."""

    varname = "MODIN_TPU_TORCH_METERS_MAX_SERIES"
    default = 2048


class CostCapture(_Choice):
    """Cost capture of the kernel launches (``observability/costs.py``):
    bytes and operations from each launch's shapes, the padding sites and
    the roofline join.  Auto (the default): while meter accounting is on;
    On: always; Off: never.  (The JAX package's Full, a memory analysis of
    the compiled program, has no counterpart for a hand kernel.)"""

    varname = "MODIN_TPU_TORCH_COST_CAPTURE"
    choices = ("Auto", "On", "Off")
    default = "Auto"


class TraceEnabled(_Flag):
    """Spans at the API, query-compiler, engine and IO layers, the launch
    ledger's device times and the flight recorder's ring.  Off: one module
    attribute read per instrumented call, no span made.  ``profile()``
    collects for its block regardless."""

    varname = "MODIN_TPU_TORCH_TRACE"


class TraceFlightRecorderSize(_Count):
    """Recent spans the flight recorder keeps while tracing is on (0: no
    ring and no dumps)."""

    varname = "MODIN_TPU_TORCH_TRACE_FLIGHT_RECORDER_SIZE"
    default = 1024


class TraceDir(_BuildPath):
    """Directory of the flight recorder's dumps."""

    varname = "MODIN_TPU_TORCH_TRACE_DIR"
    subdir = "traces"


# ---------------------------------------------------------------------- #
# The row-shard mesh and the range shuffle
# ---------------------------------------------------------------------- #


class DeviceCount(_Count):
    """How many devices of the port's kind the mesh spans:
    ``torch.cuda.device_count()`` on ``"cuda"`` and 1 on ``"cpu"`` by
    default (the JAX package's ``MODIN_TPU_DEVICES``)."""

    varname = "MODIN_TPU_TORCH_DEVICES"
    default = None
    minimum = 1

    @classmethod
    def get(cls) -> int:
        value = super().get()
        if value is not None:
            return value
        if Device.get() == "cuda":
            import torch

            return max(torch.cuda.device_count(), 1)
        return 1


class MeshShape(Parameter):
    """The mesh as ``(rows, cols)`` shards, e.g. ``4,1``; ``(DeviceCount,
    1)`` by default, so one card is one shard.  Row shard s runs on device
    ``s % DeviceCount``: more shards than devices wrap onto them (the JAX
    package's tests put 8 virtual devices on one host the same way).  The
    column axis is kept for the shape's key and shards nothing."""

    varname = "MODIN_TPU_TORCH_MESH_SHAPE"
    default = None

    @classmethod
    def _parse(cls, raw: Any) -> tuple:
        parts = [p for p in str(raw).replace("x", ",").split(",") if p.strip()] if isinstance(raw, str) else raw
        shape = tuple(int(p) for p in parts)
        if len(shape) != 2 or min(shape) < 1:
            raise ValueError(f"{cls.varname} must be two positive ints 'rows,cols', got {raw!r}")
        return shape

    @classmethod
    def get(cls) -> tuple:
        value = super().get()
        return value if value is not None else (DeviceCount.get(), 1)

    @classmethod
    def put(cls, value: Any) -> None:
        cls._set(None if value is None else cls._parse(value))

    @classmethod
    @contextlib.contextmanager
    def context(cls, value: Any):
        """As :meth:`Parameter.context`, but an unset shape comes back
        unset, so its default goes on following the devices."""
        old = cls._value
        cls.put(value)
        try:
            yield
        finally:
            cls._set(old)


class RangePartitioning(_Flag):
    """Sort through the range shuffle (sample, pivots, all-to-all, a local
    sort per shard) on a mesh of two or more row shards: read as
    ``SpmdMode`` Sharded for the sort family (``sort_values`` and the
    sorted-representation build) while ``SpmdMode`` is Auto."""

    varname = "MODIN_TPU_TORCH_RANGE_PARTITIONING"


class SpmdMode(_Choice):
    """The layout router (``ops/router.decide_layout``) of the sort,
    sorted-representation build and merge: Auto, the calibrated cost model
    on a mesh of two or more row shards (frames under ``SpmdMinRows`` and a
    single shard stay local); Local, never the shuffle; Sharded, the
    shuffle whenever the mesh has two or more row shards."""

    varname = "MODIN_TPU_TORCH_SPMD"
    choices = ("Auto", "Local", "Sharded")
    default = "Auto"


class SpmdMinRows(_Count):
    """Rows under which Auto layout routing stays local without reading
    (or running) the calibration."""

    varname = "MODIN_TPU_TORCH_SPMD_MIN_ROWS"
    default = 1 << 18


# ---------------------------------------------------------------------- #
# Multi-tenant serving and the lock-order validator
# ---------------------------------------------------------------------- #


class ServingEnabled(_Flag):
    """Multi-tenant serving (``serving/``): admission control, latency
    budgets, per-tenant fairness and health.  Off (the default):
    ``serving.submit`` is a direct call of the query, and the seams read
    ``context.CONTEXT_ON`` and nothing else (``serving.context_alloc_count()``
    stays put)."""

    varname = "MODIN_TPU_TORCH_SERVING"


class ServingMaxConcurrent(_Positive):
    """Queries the admission gate lets run at once.  Each admitted query
    also reserves its estimated device bytes (the tenant's cost EWMA, or
    ``DeviceMemoryBudget / ServingMaxConcurrent`` for an unknown tenant)
    against the budget's headroom."""

    varname = "MODIN_TPU_TORCH_SERVING_MAX_CONCURRENT"
    default = 4


class ServingQueueDepth(_Count):
    """Queries that may wait for a slot (weighted-fair wake order); past
    this depth they are shed with a typed ``QueryRejected`` and a retry
    hint.  0: never queue."""

    varname = "MODIN_TPU_TORCH_SERVING_QUEUE_DEPTH"
    default = 16


class ServingDefaultDeadlineMs(_Seconds):
    """Latency budget, milliseconds, of a query submitted without
    ``deadline_ms`` (0: unbounded).  Expiry raises ``DeadlineExceeded`` at
    the next seam check or while the query waits for the dispatch lock, so
    the overshoot is bounded by the work in flight when it expires: one
    attempt, or one held device path that cannot be stopped midway."""

    varname = "MODIN_TPU_TORCH_SERVING_DEFAULT_DEADLINE_MS"
    default = 0.0


class ServingTenantWeights(Parameter):
    """Per-tenant fairness weights, ``"name=weight,name=weight"`` (unlisted
    tenants weigh 1.0): a tenant's token bucket refills at ``weight *
    ServingMaxConcurrent`` a second, and the saturated gate wakes the queued
    tenant with the fewest queries in flight per weight first."""

    varname = "MODIN_TPU_TORCH_SERVING_TENANT_WEIGHTS"
    default = ""


class ServingDegradedHighWater(Parameter):
    """Fraction of ``DeviceMemoryBudget`` past which the device ledger
    counts as pressured where the port runs on the CPU: there, as in the
    JAX package, an admission while the ledger is past it (or while a
    device-path breaker is open) goes to pandas.  The card ignores it: the
    ledger's budgeted spill answers pressure there, and only an open
    device-path breaker sheds with reason ``degraded``."""

    varname = "MODIN_TPU_TORCH_SERVING_DEGRADED_HIGH_WATER"
    default = 0.9

    @classmethod
    def _parse(cls, raw: Any) -> float:
        value = float(raw)
        if not 0.0 < value <= 1.0:
            raise ValueError(f"{cls.varname} must be in (0, 1], got {raw!r}")
        return value

    @classmethod
    def put(cls, value: Any) -> None:
        cls._set(cls._parse(value))


class LockdepEnabled(_Flag):
    """Runtime lock-order validation (``concurrency/lockdep.py``): every
    ``named_lock``/``named_rlock`` acquisition is checked against the
    declared order, and an inversion raises ``LockdepViolation``.  A debug
    mode for the concurrency tests and the smoke; off, an acquisition costs
    one attribute read and allocates nothing.  Read once, when the
    validator's module imports; ``lockdep.enable()`` turns it on later."""

    varname = "MODIN_TPU_TORCH_LOCKDEP"
