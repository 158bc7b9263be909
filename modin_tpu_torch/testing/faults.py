"""Deterministic fault injection at the ``TorchWrapper`` engine seam.

The port's counterpart of ``modin_tpu/testing/faults.py``.  An injector
installs a hook at the seam (``core/execution/resilience._fault_hook``); it
fires inside every ``deploy``/``put``/``materialize``/``wait`` attempt,
under the resilience wrapper, and raises a real torch error or stalls, on a
deterministic schedule:

    from modin_tpu_torch.testing import inject_faults

    with inject_faults("oom", ops=("materialize",), times=3) as inj:
        df.nlargest(5, "a")          # the device path strikes, pandas answers
    assert inj.injected == 3

The errors are the types torch raises: ``torch.cuda.OutOfMemoryError`` for
an OOM, and ``torch.AcceleratorError`` (``RuntimeError`` on a torch without
it) with torch's ``CUDA error: <runtime text>`` message for a loss (700, an
illegal address) and a transient fault (46, a busy or unavailable device).  An
injected fault leaves every tensor intact, which a real sticky error does
not.  Faults fire on the first ``times`` matching calls after ``skip``
clean ones: no randomness, so a failing sequence replays exactly.

The JAX package's replica and disk injectors wait for ``fleet/`` and
``durability/``.
"""

from __future__ import annotations

import time
from typing import Any, Iterable, Optional

import torch

from modin_tpu_torch.concurrency import named_lock
from modin_tpu_torch.core.execution import resilience

_INJECTED = "[injected by modin_tpu_torch.testing.faults]"
_FAULT_KINDS = ("oom", "device_lost", "transient")
_ENGINE_OPS = ("deploy", "put", "materialize", "wait")


def make_device_error(kind: str) -> BaseException:
    """A real torch error that classifies as ``kind`` (one of 'oom',
    'device_lost', 'transient')."""
    if kind not in _FAULT_KINDS:
        raise ValueError(f"unknown fault kind {kind!r}; expected one of {sorted(_FAULT_KINDS)} or 'slow_kernel'")
    if kind == "oom":
        return torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 8.80 GiB. GPU 0 has a total "
            f"capacity of 79.19 GiB of which 1.02 GiB is free. {_INJECTED}"
        )
    error_type = getattr(torch, "AcceleratorError", RuntimeError)
    text = (
        "an illegal memory access was encountered" if kind == "device_lost"
        else "CUDA-capable device(s) is/are busy or unavailable"
    )
    return error_type(
        f"CUDA error: {text}\nCUDA kernel errors might be asynchronously reported at some "
        f"other API call, so the stacktrace below might be incorrect. {_INJECTED}"
    )


class FaultInjector:
    """Context manager: fault ``TorchWrapper`` attempts deterministically.

    ``kind``: 'oom' | 'device_lost' | 'transient' | 'slow_kernel' (sleeps
    ``slow_s`` inside the attempt, then completes: visible to the watchdog
    and the latency budget).  ``ops``: the engine methods watched.
    ``times``: faults to fire (None: every matching attempt).  ``skip``:
    clean matching attempts before the first fault.  ``injected`` counts
    faults fired, ``calls`` matching attempts seen.  One injector is active
    at a time: schedules do not compose.
    """

    def __init__(
        self,
        kind: str = "transient",
        ops: Iterable[str] = _ENGINE_OPS,
        times: Optional[int] = 1,
        skip: int = 0,
        slow_s: float = 0.05,
    ):
        if kind != "slow_kernel" and kind not in _FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        unknown = set(ops) - set(_ENGINE_OPS)
        if unknown:
            raise ValueError(f"unknown engine ops {sorted(unknown)}")
        self.kind = kind
        self.ops = frozenset(ops)
        self.times = times
        self.skip = skip
        self.slow_s = slow_s
        self.injected = 0
        self.calls = 0
        self._lock = named_lock("testing.faults")

    def _fire(self, kind: str) -> None:
        if kind == "slow_kernel":
            time.sleep(self.slow_s)
            return
        raise make_device_error(kind)

    def _hook(self, op: str) -> None:
        if op not in self.ops:
            return
        with self._lock:
            self.calls += 1
            if self.calls <= self.skip:
                return
            if self.times is not None and self.injected >= self.times:
                return
            self.injected += 1
        self._fire(self.kind)

    def __enter__(self) -> "FaultInjector":
        if resilience._fault_hook is not None:
            raise RuntimeError("another FaultInjector is already active")
        resilience._fault_hook = self._hook
        return self

    def __exit__(self, *exc_info: Any) -> None:
        resilience._fault_hook = None


def inject_faults(
    kind: str = "transient",
    ops: Iterable[str] = _ENGINE_OPS,
    times: Optional[int] = 1,
    skip: int = 0,
    slow_s: float = 0.05,
) -> FaultInjector:
    """Sugar for ``FaultInjector(...)``."""
    return FaultInjector(kind=kind, ops=ops, times=times, skip=skip, slow_s=slow_s)


class SequencedFaultInjector(FaultInjector):
    """A scripted schedule: ``steps`` is a list of ``(kind, count)``, where
    ``kind`` is 'clean' or a FaultInjector kind and each step takes
    ``count`` matching attempts; after the last step everything runs
    clean (healthy, a failure window, healed).

        with SequencedFaultInjector([("clean", 4), ("device_lost", 2)], ops=("deploy",)):
            ...
    """

    def __init__(self, steps: Iterable[tuple], ops: Iterable[str] = _ENGINE_OPS, slow_s: float = 0.05):
        super().__init__(kind="transient", ops=ops, times=0, slow_s=slow_s)
        self.steps = [(str(kind), int(n)) for kind, n in steps]
        for kind, n in self.steps:
            if kind not in ("clean", "slow_kernel") and kind not in _FAULT_KINDS:
                raise ValueError(f"unknown fault kind {kind!r} in steps")
            if n < 0:
                raise ValueError(f"negative step count {n} for {kind!r}")
        self._step = 0
        self._step_used = 0

    def _hook(self, op: str) -> None:
        if op not in self.ops:
            return
        with self._lock:
            self.calls += 1
            while self._step < len(self.steps) and self._step_used >= self.steps[self._step][1]:
                self._step += 1
                self._step_used = 0
            if self._step >= len(self.steps):
                return  # the schedule is spent: healed
            kind = self.steps[self._step][0]
            self._step_used += 1
            if kind == "clean":
                return
            self.injected += 1
        self._fire(kind)


def midquery_device_loss(after_deploys: int, times: int = 1, ops: Iterable[str] = ("deploy",)) -> SequencedFaultInjector:
    """A loss mid-query: after ``after_deploys`` clean attempts the next
    ``times`` raise an illegal-address error, then the device answers."""
    return SequencedFaultInjector([("clean", after_deploys), ("device_lost", times)], ops=ops)


class OomBurstInjector(FaultInjector):
    """OOMs until eviction frees memory: matching attempts raise while the
    device ledger has counted fewer than ``spills`` spill events since
    ``__enter__``; ``max_faults`` bounds the burst."""

    def __init__(self, ops: Iterable[str] = ("deploy",), spills: int = 1, max_faults: Optional[int] = 25):
        super().__init__(kind="oom", ops=ops, times=max_faults)
        if spills <= 0:
            raise ValueError(f"spills must be > 0, got {spills}")
        self.spills = spills
        self._baseline = 0

    def __enter__(self) -> "OomBurstInjector":
        from modin_tpu_torch.core.memory import device_ledger

        self._baseline = device_ledger.spill_count()
        return super().__enter__()

    def _hook(self, op: str) -> None:
        if op not in self.ops:
            return
        from modin_tpu_torch.core.memory import device_ledger

        with self._lock:
            self.calls += 1
            if device_ledger.spill_count() - self._baseline >= self.spills:
                return  # eviction freed the memory: the pressure is gone
            if self.times is not None and self.injected >= self.times:
                return
            self.injected += 1
        self._fire("oom")


def oom_burst_until_eviction(
    ops: Iterable[str] = ("deploy",), spills: int = 1, max_faults: Optional[int] = 25
) -> OomBurstInjector:
    """Sugar for ``OomBurstInjector(...)``."""
    return OomBurstInjector(ops=ops, spills=spills, max_faults=max_faults)


class MixedFaultInjector(FaultInjector):
    """Interleaved fault kinds, deterministic in the aggregate: every
    ``period``-th matching attempt (process-wide) faults, cycling through
    ``kinds``, until ``times`` faults have fired."""

    def __init__(
        self,
        kinds: Iterable[str] = ("oom", "device_lost"),
        ops: Iterable[str] = ("deploy",),
        period: int = 5,
        times: Optional[int] = 8,
        slow_s: float = 0.05,
    ):
        super().__init__(kind="transient", ops=ops, times=times, slow_s=slow_s)
        self.kinds = tuple(str(k) for k in kinds)
        if not self.kinds:
            raise ValueError("kinds must name at least one fault kind")
        for kind in self.kinds:
            if kind != "slow_kernel" and kind not in _FAULT_KINDS:
                raise ValueError(f"unknown fault kind {kind!r} in kinds")
        if period <= 0:
            raise ValueError(f"period must be > 0, got {period}")
        self.period = period

    def _hook(self, op: str) -> None:
        if op not in self.ops:
            return
        with self._lock:
            self.calls += 1
            if self.calls <= self.skip or self.calls % self.period != 0:
                return
            if self.times is not None and self.injected >= self.times:
                return
            kind = self.kinds[self.injected % len(self.kinds)]
            self.injected += 1
        self._fire(kind)
