"""Configuration of the torch port, read from ``MODIN_TPU_TORCH_*`` variables.

The port's counterpart of ``modin_tpu/config/envvars.py``, cut to what the
port runs: the device that holds the columns, the widest key range that
groupby codes directly instead of sorting, the widest value range that
``nunique``/``mode`` count with a histogram instead of sorting, the
threads that parse a file in parallel, and the bound on the cache of fused
programs.
"""

from __future__ import annotations

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


class Device(Parameter):
    """Where device columns live: ``"cuda"`` (the default) or ``"cpu"``.

    With ``"cuda"`` and no usable card the entry points raise; nothing
    moves to the CPU unless asked for."""

    varname = "MODIN_TPU_TORCH_DEVICE"
    default = "cuda"
    choices = ("cuda", "cpu")

    @classmethod
    def _parse(cls, raw: str) -> str:
        value = raw.strip().lower()
        if value not in cls.choices:
            raise ValueError(
                f"{cls.varname} must be one of {cls.choices}, got {raw!r}"
            )
        return value


class GroupbyRangeLimit(Parameter):
    """Widest int key range (max - min + 1) that factorizes by direct
    offset codes and one histogram; wider keys take the sort-based unique
    path.  Multi-key composite codes may span four times this."""

    varname = "MODIN_TPU_TORCH_GROUPBY_RANGE_LIMIT"
    default = 1 << 22

    @classmethod
    def _parse(cls, raw: str) -> int:
        value = int(raw)
        if value < 1:
            raise ValueError(f"{cls.varname} must be >= 1, got {raw!r}")
        return value


class KernelRouterHistBound(Parameter):
    """Largest value range (max - min + 1) for which an integer column takes
    the O(n) histogram (the bincount kernel) for ``nunique``/``mode``
    instead of the O(n log n) sort."""

    varname = "MODIN_TPU_KERNEL_ROUTER_HIST_BOUND"
    default = 1 << 20

    @classmethod
    def _parse(cls, raw: str) -> int:
        value = int(raw)
        if value <= 0:
            raise ValueError(f"{cls.varname} must be > 0, got {raw!r}")
        return value


class CpuCount(Parameter):
    """How many host threads parse the byte ranges of a file (the IO
    dispatchers' thread pool); the machine's CPU count by default."""

    varname = "MODIN_TPU_TORCH_CPUS"
    default = None

    @classmethod
    def _parse(cls, raw: str) -> int:
        value = int(raw)
        if value < 1:
            raise ValueError(f"{cls.varname} must be >= 1, got {raw!r}")
        return value

    @classmethod
    def get(cls) -> int:
        value = super().get()
        return value if value is not None else (os.cpu_count() or 1)


class FusedCacheSize(Parameter):
    """Bound on the cache of compiled fused programs in ``ops/lazy.py``
    (entries, least recently used first out); 0 leaves it unbounded."""

    varname = "MODIN_TPU_TORCH_FUSED_CACHE_SIZE"
    default = 256

    @classmethod
    def _parse(cls, raw: str) -> int:
        value = int(raw)
        if value < 0:
            raise ValueError(f"{cls.varname} must be >= 0, got {raw!r}")
        return value

    @classmethod
    def put(cls, value: Any) -> None:
        if not isinstance(value, str) and int(value) < 0:
            raise ValueError(f"{cls.varname} must be >= 0, got {value!r}")
        super().put(value)
