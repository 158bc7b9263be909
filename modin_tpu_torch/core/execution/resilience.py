"""Fault-tolerant device execution: taxonomy, retry, and circuit breakers.

The port's counterpart of ``modin_tpu/core/execution/resilience.py``.  The
engine contract (``TorchWrapper.deploy/put/materialize/wait``,
``parallel/engine.py``) and the ``_try_*`` device paths of the query
compiler are where a device failure surfaces; this module turns it into a
runtime decision that can be observed:

1. **Taxonomy** -- :func:`classify_device_error` maps torch's errors onto
   :class:`DeviceOOM`, :class:`DeviceLost` and :class:`TransientDeviceError`
   by torch's own types and the CUDA error code, never by the text of a
   message alone:

   - ``torch.cuda.OutOfMemoryError`` and CUDA error 2
     (``cudaErrorMemoryAllocation``) are a DeviceOOM;
   - the sticky context errors (700 illegal address, 710 device-side
     assert, 719 launch failure, 214 uncorrectable ECC, and the other
     kernel faults that poison the context, 714-718), a watchdog expiry and
     a read of a donated tensor are a DeviceLost;
   - the launch timeout (702), which poisons the context as they do, is a
     DeviceLost too;
   - launch bugs (9 invalid configuration, 98 invalid device function, 209
     no kernel image, 701 out of resources) and the errors of a launch's
     set-up (1 invalid value, which an oversized shared-memory request to
     ``cudaFuncSetAttribute`` returns, 13 invalid symbol, 200 invalid
     kernel image, 218 invalid PTX, 222 unsupported PTX version, 400
     invalid resource handle, 500 symbol not found, 720 cooperative launch
     too large), a failed ``nvcc`` build and any exception that is not a
     CUDA error propagate unclassified: a bug must fail loudly, never turn
     into a retry or a breaker's strike;
   - any other CUDA error is a TransientDeviceError, retried in bounds.

   The code comes from ``torch.AcceleratorError.error_code`` where the
   installed torch has it, from the ``CUDA error <code>`` of the port's
   kernel wrappers (``ops/cuda/*_kernels.py``), or from the CUDA runtime's
   own error string after torch's ``CUDA error:``.

2. **Bounded retry** -- :func:`engine_call` runs every engine-seam call;
   transient errors retry up to ``ResilienceRetries`` times with exponential
   backoff, ``materialize``/``wait`` run under a wall-clock watchdog
   (``ResilienceWatchdogS``, off by default), a DeviceOOM gets
   ``SpillRetries`` evict-then-retry rounds and a DeviceLost one lineage
   re-seat (``core/execution/recovery.py``).

3. **Per-family circuit breakers** -- every ``_try_*`` method of the query
   compiler is wrapped by :func:`device_path`.  ``ResilienceBreakerThreshold``
   consecutive strikes open a family's breaker and the family's calls fail
   at once without touching the device; after ``ResilienceBreakerCooldownS``
   one probe is let through, and a clean probe closes it.  On the card a
   failure the legs did not absorb, and a call an open breaker stops, raise
   (:class:`BreakerOpen`): pandas on the host never answers for a device
   that failed.  Where the port runs on the CPU (the tests), the family
   goes to pandas instead, as the JAX package's does, and the tests hold
   the two to the same counters and states.

Events are emitted under the JAX package's metric names
(``resilience.engine.<op>.<kind>``, ``resilience.breaker.<family>.
<state>``, ``resilience.fallback.<family>.<kind>``, ``recovery.*``) through
``logging/metrics.py``'s always-on tally, where the meters also fold them;
:data:`COUNTS` reads that tally.  While tracing is on,
each engine-seam attempt is an ``engine.<op>.attempt`` span (with a CUDA
event pair for its device interval), a fallback or a raise a
``fallback.<family>``/``raised.<family>`` span, and a breaker opening or a
failure about to raise on the card dumps the flight recorder's ring first.

While a serving context is active (``serving/context.py``; one attribute
read, ``CONTEXT_ON``, otherwise) the seams enforce the query's deadline:
``engine_call`` checks it before any work and at each attempt, backoff
sleeps never outlive it, and the watchdog's worker adopts the owner's
context and waits no longer than the budget left.  ``deploy``/``put``
attempts and every ``device_path`` call run under the dispatch lock, and
a query admitted while the device was sick goes to pandas (on the CPU:
on the card the gate sheds it instead).
"""

from __future__ import annotations

import functools
import gc
import queue
import re
import threading
import time
from typing import Any, Callable, Dict, Optional

import torch

from modin_tpu_torch.concurrency import named_lock
from modin_tpu_torch.logging.metrics import CountView, emit_counted, emit_metric
from modin_tpu_torch.observability import compile_ledger as _ledger
from modin_tpu_torch.observability import meters as _meters
from modin_tpu_torch.observability import spans as _spans
from modin_tpu_torch.observability.flight_recorder import dump_flight_record
from modin_tpu_torch.serving import context as serving_context
from modin_tpu_torch.serving.errors import ServingError
from modin_tpu_torch.config import (
    Device,
    ResilienceBackoffS,
    ResilienceBreakerCooldownS,
    ResilienceBreakerThreshold,
    ResilienceLatencyBudgetS,
    ResilienceMode,
    ResilienceRetries,
    ResilienceWatchdogS,
    SpillRetries,
)

# test seams: tests patch these to run breaker cooldowns and backoffs
# without wall-clock sleeps
_now = time.monotonic
_sleep = time.sleep

# fault-injection seam: ``modin_tpu_torch.testing.faults`` installs a
# callable here; it runs inside every engine-seam attempt (under the
# watchdog, before the real work), so an injected fault goes through the
# same classification, retry and breaker as a real one
_fault_hook: Optional[Callable[[str], None]] = None

#: event counts by metric name (only names that occurred are present): a
#: read of the metric layer's tally
COUNTS = CountView(prefixes=("resilience.", "recovery.", "trace."))
_COUNT_LOCK = named_lock("resilience.counts")
#: device-path calls that pandas answered (only where the port runs on the CPU)
_fallbacks = 0

count = emit_counted


def _flight_dump(reason: str, failure: Optional[BaseException] = None, detail: str = "") -> None:
    """Dump the flight recorder's ring (a no-op unless tracing is on) before
    a failure raises on the card or a breaker opens.  A lost context skips
    the synchronize that would resolve the ring's device events."""
    if _spans.TRACE_ON and dump_flight_record(
        reason, detail=detail, resolve_device=not isinstance(failure, DeviceLost)
    ):
        count("trace.flight_dump")


def reset_counts() -> None:
    global _fallbacks
    with _COUNT_LOCK:
        COUNTS.clear()
        _fallbacks = 0


def _count_fallback() -> None:
    global _fallbacks
    with _COUNT_LOCK:
        _fallbacks += 1


def fallback_count() -> int:
    """Calls of the ``_try_*`` device paths that a classified failure or an
    open breaker sent to pandas (never on the card, where they raise)."""
    with _COUNT_LOCK:
        return _fallbacks


# ---------------------------------------------------------------------- #
# 1. Failure taxonomy
# ---------------------------------------------------------------------- #


class DeviceFailure(RuntimeError):
    """Base of the classified infrastructure failures.  Disjoint from the
    semantic signals (``_TooManyGroups``, ``ModinAssumptionError``): the
    device misbehaved, the inputs were not declined."""

    kind = "device_failure"
    #: set on a failure that already spent its transient retries (at the
    #: engine seam, or in an inner device path), so no outer leg retries it
    retried = False


class DeviceOOM(DeviceFailure):
    """Device memory exhausted.  Not retried as it is: the same work over
    the same tensors needs the same memory; the evict-then-retry leg frees
    some first."""

    kind = "oom"


class DeviceLost(DeviceFailure):
    """The CUDA context is unusable (a sticky error) or a fetch never came
    back.  Not retried in a tight loop: it needs a re-seat of the columns
    or the breaker's cooldown."""

    kind = "device_lost"
    shard_index: Optional[int] = None


class WatchdogTimeout(DeviceLost):
    """A ``materialize``/``wait`` outlived the watchdog: treated as lost."""

    kind = "watchdog_timeout"


class TransientDeviceError(DeviceFailure):
    """Any other CUDA error: retried within the bounds."""

    kind = "transient"


class BreakerOpen(DeviceFailure):
    """A device-path call on the card that its family's open breaker
    stopped before it touched the device."""

    kind = "breaker_open"


#: CUDA runtime error codes by class (``cudaError_t``)
CUDA_OOM_CODES = frozenset({2})
CUDA_LOST_CODES = frozenset({214, 700, 702, 710, 714, 715, 716, 717, 718, 719})
CUDA_BUG_CODES = frozenset({1, 9, 13, 98, 200, 209, 218, 222, 400, 500, 701, 720})

#: the CUDA runtime's error strings (``cudaGetErrorString``), which torch
#: prints after ``CUDA error:``, and the enum names, by code
_CUDA_ERROR_TEXT = {
    "out of memory": 2,
    "uncorrectable ECC error encountered": 214,
    "an illegal memory access was encountered": 700,
    "the launch timed out and was terminated": 702,
    "device-side assert triggered": 710,
    "unspecified launch failure": 719,
    "hardware stack error": 714,
    "an illegal instruction was encountered": 715,
    "misaligned address": 716,
    "operation not supported on global/shared address space": 717,
    "invalid program counter": 718,
    "invalid configuration argument": 9,
    "invalid device function": 98,
    "no kernel image is available for execution on the device": 209,
    "too many resources requested for launch": 701,
    "invalid argument": 1,
    "invalid device symbol": 13,
    "device kernel image is invalid": 200,
    "a PTX JIT compilation failed": 218,
    "the provided PTX was compiled with an unsupported toolchain": 222,
    "invalid resource handle": 400,
    "named symbol not found": 500,
    "too many blocks in cooperative launch": 720,
}
_CUDA_ERROR_NAMES = {
    "cudaErrorMemoryAllocation": 2,
    "cudaErrorECCUncorrectable": 214,
    "cudaErrorIllegalAddress": 700,
    "cudaErrorLaunchTimeout": 702,
    "cudaErrorAssert": 710,
    "cudaErrorLaunchFailure": 719,
    "cudaErrorHardwareStackError": 714,
    "cudaErrorIllegalInstruction": 715,
    "cudaErrorMisalignedAddress": 716,
    "cudaErrorInvalidAddressSpace": 717,
    "cudaErrorInvalidPc": 718,
    "cudaErrorInvalidConfiguration": 9,
    "cudaErrorInvalidDeviceFunction": 98,
    "cudaErrorNoKernelImageForDevice": 209,
    "cudaErrorLaunchOutOfResources": 701,
    "cudaErrorInvalidValue": 1,
    "cudaErrorInvalidSymbol": 13,
    "cudaErrorInvalidKernelImage": 200,
    "cudaErrorInvalidPtx": 218,
    "cudaErrorUnsupportedPtxVersion": 222,
    "cudaErrorInvalidResourceHandle": 400,
    "cudaErrorSymbolNotFound": 500,
    "cudaErrorCooperativeLaunchTooLarge": 720,
}
# the port's kernel wrappers: "... failed with CUDA error <code>: <text>"
_WRAPPER_CODE_RE = re.compile(r"CUDA error (\d+)")
# torch's runtime checks: "CUDA error: <text>"
_TORCH_CUDA_RE = re.compile(r"CUDA error: ([^\n]*)")
#: a build of the port's kernels failed (``ops/cuda/build.py``)
_BUILD_MARKERS = ("nvcc failed to build", "nvcc not found")
#: a read of a tensor a fused launch consumed (``DeviceColumn._restore``)
DONATED_MARKER = "was donated to a fused launch"


def cuda_error_code(exc: BaseException) -> Optional[int]:
    """The CUDA error code ``exc`` carries, -1 for a CUDA error of no known
    code, or None when ``exc`` is not a CUDA error."""
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        code = getattr(exc, "error_code", None)
        if isinstance(code, int):
            return code
    if not isinstance(exc, RuntimeError):
        return None
    msg = str(exc)
    m = _WRAPPER_CODE_RE.search(msg)
    if m is not None:
        return int(m.group(1))
    m = _TORCH_CUDA_RE.search(msg)
    if m is None:
        return -1 if accel is not None and isinstance(exc, accel) else None
    text = m.group(1).strip()
    for name, code in _CUDA_ERROR_NAMES.items():
        if name in text:
            return code
    for known, code in _CUDA_ERROR_TEXT.items():
        if text.startswith(known):
            return code
    return -1


def classify_device_error(exc: BaseException) -> Optional[DeviceFailure]:
    """Map ``exc`` onto the taxonomy, or None when it is not a device
    failure (a semantic signal, a launch or build bug, any other error):
    None means it must propagate, untouched (a serving decision among them)."""
    if isinstance(exc, DeviceFailure):
        return exc
    if isinstance(exc, ServingError):
        return None
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return DeviceOOM(str(exc))
    if isinstance(exc, (ValueError, RuntimeError)) and DONATED_MARKER in str(exc):
        return DeviceLost(str(exc))
    if not isinstance(exc, RuntimeError) or any(m in str(exc) for m in _BUILD_MARKERS):
        return None
    code = cuda_error_code(exc)
    if code is None or code in CUDA_BUG_CODES:
        return None
    if code in CUDA_OOM_CODES:
        return DeviceOOM(str(exc))
    if code in CUDA_LOST_CODES:
        return DeviceLost(str(exc))
    return TransientDeviceError(str(exc))


def _detached(failure: DeviceFailure) -> DeviceFailure:
    """A copy of ``failure`` with no traceback, cause or context: holding
    it must not keep the failed attempt's frames, and their tensors, alive
    while a retry allocates again."""
    fresh = type(failure)(*failure.args)
    fresh.shard_index = getattr(failure, "shard_index", None)
    fresh.retried = failure.retried
    return fresh


def _release_failed_attempt() -> None:
    """Free what a failed CUDA attempt left: its frames may sit in
    reference cycles, and their tensors with them."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        gc.collect()


def _oom_round(op: str, rounds: int, exclude: Optional[Callable[[], set]]) -> bool:
    """One evict-then-retry round after a DeviceOOM, run out of the
    ``except`` block: the failed attempt's leftovers are released and the
    coldest device entries spill (never the storages ``exclude()`` names,
    the call's own inputs, worked out only now).  False when the leg is
    closed (``rounds`` has reached ``SpillRetries``, ``RecoveryMode`` is
    Disable, a recovery pass is on the stack) or nothing spilled."""
    if rounds >= int(SpillRetries.get()) or not recovery.RECOVERY_ON or recovery.in_recovery():
        return False
    _release_failed_attempt()
    if recovery.evict_for_oom(op, exclude_ids=exclude() if exclude is not None else None) <= 0:
        return False
    count("recovery.retry.oom")
    return True


# ---------------------------------------------------------------------- #
# 2. Engine-seam wrapper: retry with backoff, watchdog
# ---------------------------------------------------------------------- #


def _run_with_watchdog(op: str, thunk: Callable[[], Any], timeout_s: float) -> Any:
    """Run ``thunk`` bounded by ``timeout_s`` wall-clock seconds.

    A daemon thread does the blocking call (a thread pool's exit hook would
    join a wedged worker); expiry raises WatchdogTimeout and abandons it.
    The worker enters the caller's current CUDA device and stream, so its
    fetch is ordered after the caller's queued work.
    """
    result_q: "queue.Queue" = queue.Queue()
    device = stream = None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        device = torch.cuda.current_device()
        stream = torch.cuda.current_stream(device)
    # the worker's spans and metrics bill the caller's call chain and scopes
    parent_stack = _spans.snapshot_stack() if _spans.TRACE_ON else None
    parent_scopes = _meters.snapshot_scopes() if _meters.ACCOUNTING_ON else None
    # and the query's serving context: its deadline bounds what the worker
    # does on the owner's behalf
    parent_ctx = serving_context.snapshot_context() if serving_context.CONTEXT_ON else None

    def runner() -> None:
        _spans.seed_thread(parent_stack)
        _meters.seed_thread_scopes(parent_scopes)
        if parent_ctx is not None:
            serving_context.seed_thread_context(parent_ctx)
        try:
            if stream is not None:
                with torch.cuda.device(device), torch.cuda.stream(stream):
                    out = thunk()
            else:
                out = thunk()
            result_q.put((True, out))
        except BaseException as err:  # noqa: BLE001 - relayed to the caller
            result_q.put((False, err))

    thread = threading.Thread(target=runner, daemon=True, name=f"modin-tpu-torch-watchdog-{op}")
    thread.start()
    # a query deadline tighter than the watchdog bounds the wait instead:
    # the fetch is abandoned once the budget is gone and the expiry raises
    # the typed serving error, not a WatchdogTimeout (which would read a
    # slow but healthy device as lost and re-seat for nothing).  The wait
    # loops, so a deadline-clamped wait that wakes before the watchdog's
    # window closes keeps waiting.
    started = time.monotonic()  # the real clock: tests patch _now for breakers
    while True:
        wait_s = timeout_s - (time.monotonic() - started)
        if wait_s <= 0:
            count(f"resilience.watchdog.{op}.timeout")
            raise WatchdogTimeout(
                f"{op} exceeded the {timeout_s:g}s resilience watchdog "
                "(MODIN_TPU_TORCH_RESILIENCE_WATCHDOG_S); treating the device as lost"
            ) from None
        if serving_context.CONTEXT_ON:
            serving_context.check_deadline(f"engine.{op}.watchdog")
            remaining = serving_context.remaining_s()
            if remaining is not None:
                wait_s = min(wait_s, max(remaining, 1e-3))
        try:
            ok, payload = result_q.get(timeout=wait_s)
            break
        except queue.Empty:
            continue
    if ok:
        return payload
    raise payload


def _run_attempt(op: str, attempt_once: Callable[[], Any], timeout_s: float) -> Any:
    """One attempt: under the watchdog when asked for, else, while a
    serving context is active, ``deploy``/``put`` under the dispatch lock.

    The watchdog branch is never serialized: a fetch only drains results,
    and the lock must never span a handoff to a worker (an owner holding it
    while an abandoned worker still enqueues would let another thread's
    launches interleave, and a nested deploy on the worker would wait on
    its own owner)."""
    if timeout_s > 0:
        return _run_with_watchdog(op, attempt_once, timeout_s)
    if serving_context.CONTEXT_ON and op in ("deploy", "put"):
        serving_context.acquire_dispatch(f"engine.{op}.dispatch")
        try:
            return attempt_once()
        finally:
            serving_context.dispatch_lock.release()
    return attempt_once()


def engine_call(
    op: str,
    thunk: Callable[[], Any],
    watchdog: bool = False,
    protect_ids: Optional[Callable[[], set]] = None,
) -> Any:
    """Run one engine-seam call under the resilience policy.

    Transient failures retry up to ``ResilienceRetries`` times with
    exponential backoff; ``watchdog=True`` (``materialize``/``wait``) bounds
    each attempt by ``ResilienceWatchdogS``.  A DeviceOOM gets up to
    ``SpillRetries`` evict-then-retry rounds: the coldest device entries
    spill to the host (never the storages ``protect_ids()`` returns, the
    call's own inputs, worked out only then), then the call runs again.  A DeviceLost gets one lineage
    re-seat of every live column and one more attempt.  Both legs are
    skipped while a recovery pass is on the stack and under
    ``RecoveryMode=Disable``.

    A retry runs only after the failed attempt's exception has been let go:
    its traceback holds the attempt's frames, and their tensors would hold
    the memory the retry asks for.  A failure raised from here is marked
    ``retried``: its transient retries are spent.

    While a serving context is active, the query's deadline is checked
    before any work (``ResilienceMode=Disable`` too) and at the start of
    every attempt, so the overshoot is bounded by one attempt.
    """
    if serving_context.CONTEXT_ON:
        serving_context.check_deadline(f"engine.{op}")

    def attempt_once() -> Any:
        hook = _fault_hook
        if hook is not None:
            hook(op)
        return thunk()

    if ResilienceMode.get() == "Disable":
        result = _run_attempt(op, attempt_once, 0.0)
        if op == "deploy" and _meters.ACCOUNTING_ON:
            _meters.note_dispatch()
        return result

    timeout_s = float(ResilienceWatchdogS.get()) if watchdog else 0.0
    retries = int(ResilienceRetries.get())
    attempt = oom_rounds = 0
    reseat_spent = False
    while True:
        if serving_context.CONTEXT_ON:
            # a retry, evict-then-retry or re-seat comes back here
            serving_context.check_deadline(f"engine.{op}.attempt")
        # the epoch this attempt launches in: a DeviceLost hands it to
        # reseat_all, so observers of one loss share one recovery pass
        attempt_epoch = recovery.current_epoch()
        sp = ev = None
        if _spans.TRACE_ON:
            sp = _spans.start_span(f"engine.{op}.attempt", "TORCH-ENGINE", {"op": op, "attempt": attempt})
            ev = _ledger.launch_begin()
        try:
            result = _run_attempt(op, attempt_once, timeout_s)
        except Exception as err:  # the classification point: re-raises what is not a device failure
            failure = classify_device_error(err)
            if sp is not None:
                sp.attrs["failure_kind"] = failure.kind if failure is not None else type(err).__name__
                _spans.finish_span(sp, status="error")
            if failure is None:
                raise
            count(f"resilience.engine.{op}.{failure.kind}")
            failure.retried = True
            lost_leg = (
                isinstance(failure, DeviceLost)
                and not reseat_spent
                and recovery.RECOVERY_ON
                and not recovery.in_recovery()
            )
            retry_leg = isinstance(failure, TransientDeviceError) and attempt < retries
            if not (isinstance(failure, DeviceOOM) or lost_leg or retry_leg):
                # terminal for this call: keep the trace that led here
                _flight_dump(f"terminal_{failure.kind}", failure, detail=op)
                raise failure from err
            failure = _detached(failure)
        except BaseException:
            # an unwind that is no Exception (Ctrl-C) still pops the span
            if sp is not None:
                _spans.finish_span(sp, status="error")
            raise
        else:
            if op == "deploy" and _meters.ACCOUNTING_ON:
                _meters.note_dispatch()
            if sp is not None:
                _ledger.note_interval(sp, ev)
                _spans.finish_span(sp)
            return result
        # out of the except block: the failed attempt's traceback is gone
        if isinstance(failure, DeviceOOM):
            if _oom_round(op, oom_rounds, protect_ids):
                oom_rounds += 1
                continue
            _flight_dump("terminal_oom", failure, detail=op)
            raise failure
        if isinstance(failure, DeviceLost):
            if recovery.reseat_all(f"engine_{op}", observed_epoch=attempt_epoch) > 0:
                reseat_spent = True
                count("recovery.retry.device_lost")
                continue
            _flight_dump(f"terminal_{failure.kind}", failure, detail=op)
            raise failure
        attempt += 1
        count(f"resilience.engine.{op}.retry")
        _sleep(_backoff_s(attempt))


def _backoff_s(attempt: int) -> float:
    """The retry's exponential backoff; while a serving context is active
    it never outlives the query's budget (the next attempt's check then
    raises the typed abort)."""
    delay_s = float(ResilienceBackoffS.get()) * (2 ** (attempt - 1))
    if serving_context.CONTEXT_ON:
        delay_s = serving_context.clamp_sleep(delay_s)
    return delay_s


# ---------------------------------------------------------------------- #
# 3. Per-family circuit breakers
# ---------------------------------------------------------------------- #

#: every breaker family a ``@device_path`` decorator of the query compiler
#: may use, the JAX package's catalog; tests may create ad-hoc families
DEVICE_PATH_FAMILIES = frozenset(
    {
        "binary",
        "reduce",
        "dt_component",
        "str_lut",
        "top_k",
        "corr_cov",
        "shift",
        "merge",
        "rolling",
        "ewm",
        "resample",
        "expanding",
        "groupby",
        "shuffle_apply",
        "sort_shuffle",
        "sort_reduce",
    }
)

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """Consecutive-strike breaker guarding one device path family.

    CLOSED: calls flow; a device failure or a latency-budget overrun is a
    strike, a clean call resets the count.  ``threshold`` strikes open it:
    calls are stopped for ``cooldown_s``.  Then one HALF_OPEN probe is let
    through: success closes it, failure opens it again with a fresh
    cooldown.  The settings are read when they are needed, so a live
    process can be retuned.
    """

    def __init__(self, name: str):
        self.name = name
        self.state = CLOSED
        self.strikes = 0
        self.opened_at = 0.0
        self._lock = named_lock("resilience.breaker")

    @staticmethod
    def _threshold() -> int:
        return int(ResilienceBreakerThreshold.get())

    @staticmethod
    def _cooldown_s() -> float:
        return float(ResilienceBreakerCooldownS.get())

    def _transition(self, state: str) -> bool:
        """Record the change; True when it opened (the caller dumps the
        flight record after releasing the breaker's lock)."""
        self.state = state
        count(f"resilience.breaker.{self.name}.{state}")
        return state == OPEN

    def allow(self) -> bool:
        """May the guarded path run now?"""
        with self._lock:
            if self.state == CLOSED:
                return True
            if self.state == OPEN:
                if _now() - self.opened_at >= self._cooldown_s():
                    self._transition(HALF_OPEN)
                    return True
                return False
            # HALF_OPEN: one probe is in flight; stop the rest
            return False

    def record_success(self, latency_s: float = 0.0) -> None:
        budget = float(ResilienceLatencyBudgetS.get())
        if budget > 0 and latency_s > budget:
            count(f"resilience.breaker.{self.name}.slow")
            self._strike()
            return
        with self._lock:
            self.strikes = 0
            if self.state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self) -> None:
        self._strike()

    def abort_probe(self) -> None:
        """The HALF_OPEN probe ended with an unclassified exception: back to
        OPEN with a fresh cooldown (only a probe can leave HALF_OPEN)."""
        opened = False
        with self._lock:
            if self.state == HALF_OPEN:
                self.opened_at = _now()
                opened = self._transition(OPEN)
        if opened:
            _flight_dump(f"breaker_open_{self.name}")

    def _strike(self) -> None:
        opened = False
        with self._lock:
            self.strikes += 1
            count(f"resilience.breaker.{self.name}.strike")
            if self.state == HALF_OPEN or (self.state == CLOSED and self.strikes >= self._threshold()):
                self.opened_at = _now()
                opened = self._transition(OPEN)
        if opened:
            _flight_dump(f"breaker_open_{self.name}")


_BREAKERS: Dict[str, CircuitBreaker] = {}
_breakers_lock = named_lock("resilience.breakers")


def get_breaker(name: str) -> CircuitBreaker:
    with _breakers_lock:
        breaker = _BREAKERS.get(name)
        if breaker is None:
            breaker = _BREAKERS[name] = CircuitBreaker(name)
        return breaker


def breaker_snapshot() -> Dict[str, str]:
    """``{family: state}``."""
    with _breakers_lock:
        return {name: b.state for name, b in _BREAKERS.items()}


def reset_breakers() -> None:
    """Forget every breaker's state."""
    with _breakers_lock:
        _BREAKERS.clear()


def drop_breaker(name: str) -> None:
    """Forget one breaker (the serving tenant registry drops an evicted
    idle tenant's health breaker, so per-user tenants cannot grow this
    table without bound; device-path families are never dropped)."""
    with _breakers_lock:
        _BREAKERS.pop(name, None)


def _input_tensors(qc: Any, args: tuple, kwargs: dict):
    """The concrete device tensors a ``_try_*`` call reads: its compiler's
    columns and those of compilers among its arguments.  A deferred plan is
    not forced."""
    for obj in (qc, *args, *kwargs.values()):
        for item in obj if isinstance(obj, (list, tuple)) else (obj,):
            frame = getattr(item, "_frame", None)
            for col in getattr(frame, "_columns", ()):
                t = getattr(col, "_data", None)
                if isinstance(t, torch.Tensor):
                    yield t


def _input_storages(qc: Any, args: tuple, kwargs: dict) -> set:
    """Storage keys of the call's input tensors: spilling them frees
    nothing while the call pins them."""
    from modin_tpu_torch.core.memory import storage_key

    return {storage_key(t) for t in _input_tensors(qc, args, kwargs)}


def _on_card(qc: Any, args: tuple, kwargs: dict) -> bool:
    """Does this call run on the card: the port's device is CUDA, or an
    input lies there?  There a failure raises instead of going to pandas."""
    return Device.get() == "cuda" or any(t.is_cuda for t in _input_tensors(qc, args, kwargs))


def device_path(family: str) -> Callable:
    """Decorator of the ``TorchQueryCompiler._try_*`` methods: the family's
    breaker.

    The method keeps its contract (a result, or None: the inputs are not
    the device path's, pandas answers).  The wrapper adds:

    - a DeviceOOM raised inside the call: up to ``SpillRetries``
      evict-then-retry rounds (:func:`_oom_round`, the call's own input
      storages excluded), and the call runs again.  The port's ops launch
      their torch calls and kernels directly, not through one dispatch
      seam, so this is where a sort's or a kernel's OOM meets the evictor;
    - a TransientDeviceError that did not spend its retries at the engine
      seam (a direct launch's): up to ``ResilienceRetries`` runs again with
      backoff.  No ``_try_*`` method writes before it returns (the writing
      paths, ``setitem``, ``setitem_bool``, ``insert``, are not ``_try_*``
      methods), so running one again is exact;
    - any other classified failure, or one the legs did not absorb: a
      strike (a DeviceLost that opens the breaker re-seats the live
      columns first).  On the card the failure then raises, marked
      ``retried``, counted as ``resilience.raised.<family>.<kind>``; where
      the port runs on the CPU the call returns None and pandas answers,
      counted as ``resilience.fallback.<family>.<kind>``, as in the JAX
      package;
    - breaker OPEN: the call is stopped without touching the device and
      counted; on the card it raises :class:`BreakerOpen`, on the CPU it
      returns None;
    - an unclassified exception, or a BreakerOpen of an inner device path,
      propagates untouched (a probe's breaker goes back to OPEN);
    - a clean call reports its latency, so budget overruns strike too.
    """

    def decorator(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(self: Any, *args: Any, **kwargs: Any) -> Any:
            if ResilienceMode.get() == "Disable":
                return fn(self, *args, **kwargs)
            if serving_context.CONTEXT_ON and serving_context.degraded_active():
                # the query was admitted while the device was sick (only on
                # the CPU: on the card the gate sheds instead): pandas
                # answers, as for an open breaker, without touching the device
                emit_metric("serving.degraded.fallback", 1)
                if _spans.TRACE_ON:
                    _spans.event(f"fallback.{family}", "QUERY-COMPILER", family=family, reason="degraded")
                _count_fallback()
                return None
            breaker = get_breaker(family)
            if not breaker.allow():
                count(f"resilience.breaker.{family}.short_circuit")
                if _on_card(self, args, kwargs):
                    if _spans.TRACE_ON:
                        _spans.event(f"raised.{family}", "QUERY-COMPILER", family=family, reason="breaker_open")
                    _flight_dump(f"breaker_open_{family}", detail="short_circuit")
                    raise BreakerOpen(f"the {family} device path's breaker is open after repeated device failures")
                if _spans.TRACE_ON:
                    _spans.event(f"fallback.{family}", "QUERY-COMPILER", family=family, reason="short_circuit")
                _count_fallback()
                return None
            oom_rounds = attempt = 0
            while True:
                start = _now()
                try:
                    if serving_context.CONTEXT_ON:
                        # one thread at a time launches a device path's work
                        # (serving/context.py); pandas fallbacks stay
                        # concurrent, and a query whose deadline passes while
                        # it waits for the lock raises instead of waiting on
                        serving_context.acquire_dispatch(f"device_path.{family}")
                        try:
                            result = fn(self, *args, **kwargs)
                        finally:
                            serving_context.dispatch_lock.release()
                    else:
                        result = fn(self, *args, **kwargs)
                except Exception as err:  # the classification point: re-raises what is not a device failure
                    failure = classify_device_error(err)
                    if failure is None or isinstance(failure, BreakerOpen):
                        breaker.abort_probe()
                        raise
                    failure = _detached(failure)
                else:
                    breaker.record_success(_now() - start)
                    return result
                # out of the except block: the failed call's frames are gone
                if isinstance(failure, DeviceOOM) and _oom_round(
                    family, oom_rounds, lambda: _input_storages(self, args, kwargs)
                ):
                    oom_rounds += 1
                    continue
                if (
                    isinstance(failure, TransientDeviceError)
                    and not failure.retried
                    and attempt < int(ResilienceRetries.get())
                ):
                    attempt += 1
                    count(f"resilience.device_path.{family}.retry")
                    _sleep(_backoff_s(attempt))
                    continue
                breaker.record_failure()
                if isinstance(failure, DeviceLost) and breaker.state == OPEN and not recovery.in_recovery():
                    # the family's breaker is open: re-seat the columns now,
                    # so the other families' next calls read healthy tensors
                    recovery.reseat_all(f"breaker_open_{family}")
                if _on_card(self, args, kwargs):
                    count(f"resilience.raised.{family}.{failure.kind}")
                    if _spans.TRACE_ON:
                        _spans.event(f"raised.{family}", "QUERY-COMPILER", family=family, reason=failure.kind)
                    _flight_dump(f"raised_{family}_{failure.kind}", failure)
                    failure.retried = True
                    raise failure
                count(f"resilience.fallback.{family}.{failure.kind}")
                if _spans.TRACE_ON:
                    _spans.event(f"fallback.{family}", "QUERY-COMPILER", family=family, reason=failure.kind)
                _count_fallback()
                return None

        wrapper._resilience_family = family
        return wrapper

    return decorator


# recovery imports this module's ``count``: bound last, once both exist
from modin_tpu_torch.core.execution import recovery  # noqa: E402
