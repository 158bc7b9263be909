"""The bounded admission gate and the ``submit`` query front end.

The port's counterpart of ``modin_tpu/serving/gate.py``.  Every layer below
this one (resilience retries and breakers, lineage recovery, the device
ledger's admission) assumes one query at a time; the gate makes many
concurrent sessions a defined workload:

- **Admission and backpressure.**  At most ``ServingMaxConcurrent`` queries
  run; each admitted query reserves its estimated device bytes (the
  tenant's cost EWMA, or ``DeviceMemoryBudget / ServingMaxConcurrent`` for
  an unknown tenant) against the device ledger's budget, so admission is
  decided before work lands on the card rather than after an OOM.  Excess
  load waits in a queue bounded by ``ServingQueueDepth``; past that,
  queries are shed with a typed :class:`~.errors.QueryRejected` carrying a
  retry-after hint.  A queued query with a deadline spends its budget
  waiting and aborts typed.

- **Deadlines.**  ``deadline_ms`` (default ``ServingDefaultDeadlineMs``)
  becomes a :class:`~.context.CancellationToken` checked at the seams (see
  ``serving/context.py``).

- **Fairness and health.**  Weighted token buckets and per-tenant breakers
  (``serving/tenants.py``): a tenant past its weighted rate is throttled,
  a tenant whose queries keep striking device-path breakers is quarantined
  for the breaker's cooldown.  The saturated gate wakes the queued tenant
  with the fewest queries in flight per weight unit first.

- **Degraded mode.**  Where the port runs on the CPU, the device is sick
  while a device-path breaker is OPEN or the ledger is past
  ``ServingDegradedHighWater`` of its budget, and an admission then goes to
  pandas (``device_path`` short-circuits, counted
  ``serving.degraded.fallback``), as in the JAX package.  On the card only
  an OPEN device-path breaker makes the device sick, and the gate does not
  admit into it: it sheds with reason ``degraded`` and the breaker's
  cooldown as the retry hint (counted as ``serving.degraded`` and as a
  shed), since pandas on the host answering for the card would hide the
  device.  Ledger pressure on the card is not sickness: a deployment whose
  data outgrows its budget keeps the ledger near it after every query, and
  the ledger's budgeted spill, not a shed, makes the room.

Off (``MODIN_TPU_TORCH_SERVING=0``, the default) ``submit`` calls the
query directly: no token, no scope, no allocation
(``context.context_alloc_count``), and the seams see ``CONTEXT_ON`` False.

With the watch service on, every finished query feeds its tenant's SLO
series (``watch.observe_query``) and :func:`serving_snapshot` carries the
burn verdicts under ``slo``; with a fleet coordinator live in the process,
the snapshot carries its replica table under ``fleet``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Optional

from modin_tpu_torch.concurrency import named_lock
from modin_tpu_torch.logging.metrics import emit_metric
from modin_tpu_torch.observability import meters as _meters
from modin_tpu_torch.observability import spans as _spans
from modin_tpu_torch.observability import watch as _watch
from modin_tpu_torch.serving import context as _context
from modin_tpu_torch.serving import tenants as _tenants
from modin_tpu_torch.serving.errors import DeadlineExceeded, QueryRejected, ServingError

#: the MODIN_TPU_TORCH_SERVING switch, kept current by its subscription
SERVING_ON: bool = False

#: fallback retry-after hint (seconds) for a tenant with no wall history
_DEFAULT_RETRY_AFTER_S = 0.05

#: the reservation without a device budget: admission then bounds only
#: concurrency, the queue and fairness, not bytes
_NO_BUDGET_COST = 0.0


def _device_budget() -> Optional[int]:
    from modin_tpu_torch.core import memory as _memory

    return _memory.device_ledger.budget()


def _device_resident() -> int:
    from modin_tpu_torch.core import memory as _memory

    return _memory.device_ledger.total_bytes()


def _device_breaker_open() -> bool:
    """Is any *device-path* breaker OPEN?  (A tenant's breaker does not
    count: a sick tenant must not degrade everyone else's queries.)"""
    from modin_tpu_torch.core.execution.resilience import DEVICE_PATH_FAMILIES, breaker_snapshot

    return any(state == "open" for name, state in breaker_snapshot().items() if name in DEVICE_PATH_FAMILIES)


def _on_card() -> bool:
    """Does the port run on the card?  (``resilience._on_card`` with no
    inputs: the port's device is CUDA; tests patch it to run the card's
    legs on the CPU.)"""
    from modin_tpu_torch.core.execution import resilience

    return resilience._on_card(None, (), {})


class _Waiter:
    """One queued admission request (its own event: targeted wakeups)."""

    __slots__ = ("tenant", "weight", "cost", "seq", "event")

    def __init__(self, tenant: str, weight: float, cost: float, seq: int):
        self.tenant = tenant
        self.weight = weight
        self.cost = cost
        self.seq = seq
        self.event = threading.Event()


class Permit:
    """Proof of admission; carries the per-query serving decisions."""

    __slots__ = ("tenant", "cost_bytes", "degraded", "queue_wait_s")

    def __init__(self, tenant: str, cost_bytes: float, degraded: bool, queue_wait_s: float):
        self.tenant = tenant
        self.cost_bytes = cost_bytes
        self.degraded = degraded
        self.queue_wait_s = queue_wait_s


class AdmissionGate:
    """The process-wide bounded admission gate (one instance, module-level)."""

    def __init__(self) -> None:
        self._lock = named_lock("serving.gate")
        self._running = 0
        self._reserved_bytes = 0.0
        self._inflight: dict = {}  # tenant -> running count
        self._waiters: list = []
        self._seq = 0
        # lifetime counters for snapshots
        self.admitted = 0
        self.queued = 0
        self.shed = 0
        self.degraded_count = 0
        self.completed = 0
        # recent shed timestamps (monotonic): the windowed typed-shed rate
        self._shed_times: deque = deque(maxlen=256)

    # -- config ---------------------------------------------------------- #

    @staticmethod
    def _max_concurrent() -> int:
        from modin_tpu_torch.config import ServingMaxConcurrent

        return max(int(ServingMaxConcurrent.get()), 1)

    @staticmethod
    def _queue_depth() -> int:
        from modin_tpu_torch.config import ServingQueueDepth

        return max(int(ServingQueueDepth.get()), 0)

    @staticmethod
    def _high_water() -> float:
        from modin_tpu_torch.config import ServingDegradedHighWater

        return float(ServingDegradedHighWater.get())

    # -- admission ------------------------------------------------------- #

    def _cost_estimate(self, tenant: str) -> float:
        budget = _device_budget()
        if budget is None:
            return _NO_BUDGET_COST
        default = budget / self._max_concurrent()
        return _tenants.registry.cost_estimate(tenant, default)

    def _fits(self, cost: float) -> bool:
        """Slot and byte headroom check (caller holds the lock)."""
        if self._running >= self._max_concurrent():
            return False
        budget = _device_budget()
        if budget is None or self._running == 0:
            # admit-one: a query estimated past the whole budget still runs
            # alone (the ledger's spill handles the rest); otherwise it
            # would queue forever behind nothing
            return True
        return self._reserved_bytes + cost <= budget

    def _next_waiter(self) -> Optional["_Waiter"]:
        """Weighted-fair head of the queue: fewest in flight per weight
        unit, FIFO within a tie (caller holds the lock)."""
        if not self._waiters:
            return None
        return min(
            self._waiters,
            key=lambda w: (self._inflight.get(w.tenant, 0) / max(w.weight, 1e-9), w.seq),
        )

    def _wake(self) -> None:
        """Signal the waiter whose turn it is (caller holds the lock)."""
        head = self._next_waiter()
        if head is not None:
            head.event.set()

    def _shed(self, tenant: str, reason: str, retry_after_s: float) -> None:
        # called WITHOUT the gate lock (metric fan-out never runs under
        # it); only the counter bump takes it
        with self._lock:
            self.shed += 1
            self._shed_times.append(time.monotonic())
        emit_metric("serving.shed", 1)
        emit_metric(f"serving.tenant.{_tenants.sanitize(tenant)}.{reason}", 1)
        _tenants.registry.note_shed(tenant)
        raise QueryRejected(
            f"query for tenant {tenant!r} rejected ({reason}); retry after ~{retry_after_s * 1e3:.0f}ms",
            reason=reason,
            retry_after_s=retry_after_s,
        )

    def _shed_degraded(self, tenant: str) -> None:
        """On the card: shed instead of admitting into a device whose
        device-path breaker is open; the retry hint is the breaker's
        cooldown."""
        from modin_tpu_torch.config import ResilienceBreakerCooldownS

        with self._lock:
            self.degraded_count += 1
        emit_metric("serving.degraded", 1)
        self._shed(tenant, "degraded", float(ResilienceBreakerCooldownS.get()))

    def acquire(self, tenant: str, token: Optional[_context.CancellationToken]) -> Permit:
        """Admit, queue, or shed: the serving decision tree.

        Order: tenant health (breaker) -> tenant rate (token bucket) ->
        capacity (slots + byte headroom) -> bounded queue -> shed; then, on
        the card, device health (:meth:`_finalize_admit`).
        """
        breaker = _tenants.breaker_for(tenant)
        if not breaker.allow():
            from modin_tpu_torch.config import ResilienceBreakerCooldownS

            self._shed(tenant, "unhealthy", float(ResilienceBreakerCooldownS.get()))
        spent, retry_after = _tenants.registry.try_spend(tenant)
        if not spent:
            self._shed(tenant, "throttled", retry_after)

        cost = self._cost_estimate(tenant)
        weight = _tenants.registry.get(tenant).weight
        wait_t0 = time.perf_counter()
        waiter: Optional[_Waiter] = None
        queue_len = None
        with self._lock:
            if self._fits(cost) and not self._waiters:
                self._reserve_locked(tenant, cost)
            elif len(self._waiters) >= self._queue_depth():
                queue_len = len(self._waiters)
            else:
                self._seq += 1
                waiter = _Waiter(tenant, weight, cost, self._seq)
                self._waiters.append(waiter)
                self.queued += 1
        if waiter is None and queue_len is None:
            return self._finalize_admit(tenant, cost, 0.0)
        if queue_len is not None:
            # the queue is full: the soonest realistic retry is one queue
            # drain away, and the rate token comes back (a capacity
            # verdict, not a rate one: a polite retrying client must not
            # drain its bucket into a "throttled" quarantine)
            wall = _tenants.registry.wall_hint(tenant, _DEFAULT_RETRY_AFTER_S)
            hint = wall * (1 + queue_len / self._max_concurrent())
            _tenants.registry.refund(tenant)
            self._shed(tenant, "queue_full", hint)
        emit_metric("serving.queued", 1)
        try:
            while True:
                remaining = token.remaining_s() if token is not None else None
                if remaining is not None and remaining <= 0:
                    # budget spent in the queue: typed abort, never a hang
                    # (the rate token comes back: nothing ran)
                    _tenants.registry.refund(tenant)
                    emit_metric(f"serving.tenant.{_tenants.sanitize(tenant)}.deadline", 1)
                    token.check("serving.queue")  # raises DeadlineExceeded
                    raise DeadlineExceeded("deadline expired while queued", where="serving.queue")
                waiter.event.wait(timeout=min(remaining, 0.5) if remaining is not None else 0.5)
                with self._lock:
                    waiter.event.clear()
                    head = self._next_waiter()
                    if head is waiter and self._fits(waiter.cost):
                        self._waiters.remove(waiter)
                        waiter = None
                        wait_s = time.perf_counter() - wait_t0
                        self._reserve_locked(tenant, cost)
                        # capacity may admit more than one queued query
                        self._wake()
                    elif head is not None and head is not waiter:
                        # the wakeup landed on the wrong waiter (the fair
                        # head changed after release() signalled): pass it
                        # on, or freed capacity idles until the next poll
                        head.event.set()
                if waiter is None:
                    emit_metric("serving.queue_wait_s", wait_s)
                    return self._finalize_admit(tenant, cost, wait_s)
        finally:
            if waiter is not None:  # deadline abort: leave the queue clean
                with self._lock:
                    if waiter in self._waiters:
                        self._waiters.remove(waiter)
                    self._wake()

    def _reserve_locked(self, tenant: str, cost: float) -> None:
        """Counter and reservation mutations only: the caller holds the
        gate lock, so nothing here fans out to handlers or other locks."""
        self._running += 1
        self._reserved_bytes += cost
        self._inflight[tenant] = self._inflight.get(tenant, 0) + 1
        self.admitted += 1

    def _unreserve_locked(self, tenant: str, cost: float) -> None:
        """Give back a slot and its bytes, and wake the next waiter (caller
        holds the gate lock)."""
        self._running = max(self._running - 1, 0)
        self._reserved_bytes = max(self._reserved_bytes - cost, 0.0)
        count = self._inflight.get(tenant, 0) - 1
        if count <= 0:
            self._inflight.pop(tenant, None)
        else:
            self._inflight[tenant] = count
        self._wake()

    def _finalize_admit(self, tenant: str, cost: float, queue_wait_s: float) -> Permit:
        """The admission's observable side: the degraded-route evaluation
        (breaker snapshot, ledger read) and the metric fan-out, run without
        the gate lock so one slow handler does not stall every other
        thread's admission."""
        on_card = _on_card()
        sick = self._degraded_cause(on_card)
        if sick is not None and on_card:
            # on the card nothing is admitted into a sick device: give the
            # slot, its bytes and the rate token back, and shed
            with self._lock:
                self._unreserve_locked(tenant, cost)
                self.admitted -= 1
            _tenants.registry.refund(tenant)
            self._shed_degraded(tenant)
        _tenants.registry.note_admitted(tenant)
        degraded = sick is not None
        if degraded:
            with self._lock:
                self.degraded_count += 1
            emit_metric("serving.degraded", 1)
            emit_metric(f"serving.tenant.{_tenants.sanitize(tenant)}.degraded", 1)
        emit_metric("serving.admit", 1)
        emit_metric(f"serving.tenant.{_tenants.sanitize(tenant)}.admit", 1)
        return Permit(tenant, cost, degraded, queue_wait_s)

    def _degraded_cause(self, on_card: bool) -> Optional[str]:
        """Is the device sick: ``"breaker"`` (a device-path breaker is
        open), ``"ledger"`` (off the card only: the ledger is past the
        high-water fraction of its budget), or None."""
        if _device_breaker_open():
            return "breaker"
        if on_card:
            # the ledger's admission spills down to the budget; past the
            # high water is the steady state of data larger than its budget
            return None
        budget = _device_budget()
        if budget is not None and _device_resident() >= self._high_water() * budget:
            return "ledger"
        return None

    def release(self, permit: Permit) -> None:
        with self._lock:
            self._unreserve_locked(permit.tenant, permit.cost_bytes)
            self.completed += 1
        _tenants.registry.note_release(permit.tenant)

    # -- introspection --------------------------------------------------- #

    def _shed_rate_locked(self, window_s: float = 5.0) -> float:
        """Typed sheds a second over the trailing window (caller holds the
        lock)."""
        cutoff = time.monotonic() - window_s
        return sum(1 for t in self._shed_times if t >= cutoff) / window_s

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": SERVING_ON,
                "running": self._running,
                "queued": len(self._waiters),
                "reserved_bytes": self._reserved_bytes,
                "admitted": self.admitted,
                "ever_queued": self.queued,
                "shed": self.shed,
                "shed_rate": self._shed_rate_locked(),
                "degraded": self.degraded_count,
                "completed": self.completed,
                "max_concurrent": self._max_concurrent(),
                "queue_depth": self._queue_depth(),
            }

    def reset_for_tests(self) -> None:
        with self._lock:
            self._waiters.clear()
            self._running = 0
            self._reserved_bytes = 0.0
            self._inflight.clear()
            self._seq = 0
            self.admitted = self.queued = self.shed = 0
            self.degraded_count = self.completed = 0
            self._shed_times.clear()


gate = AdmissionGate()


def counter_sample() -> tuple:
    """``(queued, running)`` read without the lock: racy by design
    (the trace's counter tracks sample it at every span finish, and taking
    the gate lock there would serialize traced threads against admission)."""
    return (len(gate._waiters), gate._running)


#: depth of submit() frames on this thread.  An admitted query that
#: submits another must not go back through the gate: at saturation it
#: would queue behind the slot its own caller holds (MaxConcurrent 1 and a
#: nested submit hang forever).  The inner call runs under the outer
#: permit; its own deadline still nests through the context stack.
_tls = threading.local()


def serving_snapshot() -> dict:
    """Gate and tenant state for dashboards and debugging.  With the watch
    service on, the tenants' SLO burn verdicts ride along under ``slo``: an
    advisory signal beside the breakers (the gate never sheds for it)."""
    snap = gate.snapshot()
    snap["tenants"] = _tenants.registry.snapshot()
    if _watch.WATCH_ON:
        snap["slo"] = _watch.slo_health()
    # a fleet coordinator live in this process adds its replica table (read
    # through sys.modules: a snapshot never imports the fleet)
    import sys as _sys

    fleet = _sys.modules.get("modin_tpu_torch.fleet")
    if fleet is not None and fleet.FLEET_ON:
        coordinator = fleet.get_coordinator()
        if coordinator is not None:
            snap["fleet"] = coordinator.snapshot()
    return snap


# ---------------------------------------------------------------------- #
# the query front end
# ---------------------------------------------------------------------- #


def submit(
    fn: Callable[..., Any],
    *args: Any,
    tenant: str = "default",
    deadline_ms: Optional[float] = None,
    label: Optional[str] = None,
    **kwargs: Any,
) -> Any:
    """Run one query under admission control, returning its result.

    With serving off (the default) this is a direct call of ``fn``.  With
    serving on, the call is admitted (or typed-rejected) by the gate, runs
    under a :class:`~.context.QueryContext` carrying its deadline and
    degraded-route flag, and is accounted in a ``query_stats`` scope whose
    rollup feeds the tenant's cost EWMA and health breaker.

    ``deadline_ms=None`` takes ``ServingDefaultDeadlineMs`` (0: unbounded);
    ``deadline_ms=0`` forces unbounded for this query.
    """
    if not SERVING_ON:
        return fn(*args, **kwargs)
    if deadline_ms is None:
        from modin_tpu_torch.config import ServingDefaultDeadlineMs

        deadline_ms = float(ServingDefaultDeadlineMs.get())
    qlabel = label or getattr(fn, "__name__", "query")
    token = _context.CancellationToken(deadline_ms / 1e3, qlabel) if deadline_ms and deadline_ms > 0 else None
    if getattr(_tls, "depth", 0) > 0:
        # nested submit on an admitted thread: run under the outer permit;
        # the inner deadline/degraded context still nests and unwinds
        outer = _context.current_context()
        ctx = _context.QueryContext(
            token if token is not None else (outer.token if outer else None),
            outer.degraded if outer is not None else False,
            tenant,
            qlabel,
        )
        previous = _context.enter_context(ctx)
        try:
            return fn(*args, **kwargs)
        finally:
            _context.exit_context(previous)
    sp = None
    if _spans.TRACE_ON:
        sp = _spans.start_span("serving.admit", "PANDAS-API", {"tenant": tenant, "label": qlabel})
    try:
        permit = gate.acquire(tenant, token)
    except ServingError:
        if sp is not None:
            _spans.finish_span(sp, status="error")
        raise
    if sp is not None:
        sp.attrs["queue_wait_s"] = round(permit.queue_wait_s, 6)
        sp.attrs["degraded"] = permit.degraded
        _spans.finish_span(sp)
    ctx = _context.QueryContext(token, permit.degraded, tenant, qlabel)
    previous = _context.enter_context(ctx)
    _tls.depth = getattr(_tls, "depth", 0) + 1
    t0 = time.perf_counter()
    stats = None
    failure_kind = None
    try:
        with _spans.span("serving.query", "PANDAS-API", tenant=tenant, label=qlabel, degraded=permit.degraded):
            with _meters.query_stats(qlabel) as stats:
                return fn(*args, **kwargs)
    except ServingError:
        failure_kind = "serving"
        raise
    except Exception as err:
        from modin_tpu_torch.core.execution.resilience import classify_device_error

        if classify_device_error(err) is not None:
            failure_kind = "device"
        raise
    finally:
        _tls.depth -= 1
        _context.exit_context(previous)
        gate.release(permit)
        wall_s = time.perf_counter() - t0
        emit_metric("serving.query_wall_s", wall_s)
        if _watch.WATCH_ON:
            # the tenant's latency series for SLO burn (one attribute read
            # while watch is off)
            _watch.observe_query(tenant, wall_s, failure_kind)
        _finish_accounting(tenant, stats, wall_s, failure_kind)


def _finish_accounting(tenant: str, stats: Any, wall_s: float, failure_kind: Optional[str]) -> None:
    """Fold the query's rollup into the tenant's cost and health state
    (never raises into the caller's result path)."""
    try:
        cost_bytes = 0.0
        trips = 0
        if stats is not None:
            if getattr(stats, "stream_windows", 0):
                # a windowed query's est_bytes adds up the whole source's
                # traffic across windows, but its device footprint is the
                # window double-buffer: bill the measured high-water, so
                # out-of-core queries do not inflate the tenant's EWMA
                cost_bytes = float(stats.hbm_high_water or 0.0)
            else:
                cost_bytes = float(stats.est_bytes or 0.0) or float(stats.hbm_high_water or 0.0)
            trips = int(getattr(stats, "breaker_trips", 0))
        _tenants.registry.observe(tenant, cost_bytes, wall_s)
        breaker = _tenants.breaker_for(tenant)
        if failure_kind == "device" or trips > 0:
            # the query kept striking device paths (or died on a terminal
            # device failure): one strike for the tenant's health breaker
            breaker.record_failure()
        elif failure_kind is None:
            breaker.record_success()
        outcome = {None: "complete", "serving": "deadline", "device": "device_failure"}.get(failure_kind, "complete")
        emit_metric(f"serving.tenant.{_tenants.sanitize(tenant)}.{outcome}", 1)
    except Exception:
        pass


# ---------------------------------------------------------------------- #
# config wiring
# ---------------------------------------------------------------------- #


def _on_serving_param(param: Any) -> None:
    global SERVING_ON
    SERVING_ON = bool(param.get())


from modin_tpu_torch.config import ServingEnabled as _ServingEnabled  # noqa: E402

_ServingEnabled.subscribe(_on_serving_param)
