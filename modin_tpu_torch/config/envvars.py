"""Configuration of the torch port, read from ``MODIN_TPU_TORCH_*`` variables.

The port's counterpart of ``modin_tpu/config/envvars.py``, cut to what the
port runs: the device that holds the columns, the widest key range that
groupby codes directly instead of sorting, the widest value range that
``nunique``/``mode`` count with a histogram instead of sorting, the
threads that parse a file in parallel, the bound on the cache of fused
programs, and the whole-query planner's knobs (``PlanMode``,
``PlanMaxPasses``, ``PlanScanCacheBytes``, ``FuseMode``, ``FuseMinRows``;
the port's own variable names, so one process can pin the two packages
apart).
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Optional


class Parameter:
    """One setting: the environment variable when first read, until
    :meth:`put` replaces it."""

    varname: str = ""
    default: Any = None
    _value: Optional[Any] = None

    @classmethod
    def _parse(cls, raw: str) -> Any:
        return raw

    @classmethod
    def get(cls) -> Any:
        if cls._value is None:
            raw = os.environ.get(cls.varname)
            cls._value = cls.default if raw is None else cls._parse(raw)
        return cls._value

    @classmethod
    def put(cls, value: Any) -> None:
        cls._value = cls._parse(value) if isinstance(value, str) else value

    @classmethod
    @contextlib.contextmanager
    def context(cls, value: Any):
        """The setting is ``value`` inside the ``with`` block."""
        old = cls.get()
        cls.put(value)
        try:
            yield
        finally:
            cls._value = old


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
        cls._value = cls._parse(str(value))


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
        cls._value = cls._parse(str(value))


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
