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
(``Memory``, ``DeviceMemoryBudget``), the plan optimizer's
(``OptMode``, ``OptReplanFactor``) and the derived-artifact cache's
(``ViewsMode``, ``ViewsMaxEntries``, ``ViewsHostBudget``,
``ViewsMaxGroups``, ``ViewsMaxChain``); the port's own variable names, so
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
