"""Per-query serving context: deadline/cancellation tokens and degraded routing.

The port's counterpart of ``modin_tpu/serving/context.py``.  One thread runs
one admitted query at a time; this module carries that query's serving
state, its :class:`CancellationToken` (deadline) and its degraded-route
flag, on a thread-local, as spans and ``query_stats`` scopes ride their own.
The seam checks (``engine_call``'s start, attempts and backoff sleeps, the
device ledger's spill pass, ``lazy.run_fused``, plan lowering) all read ONE
module attribute first, :data:`CONTEXT_ON`, so the default-off mode costs
one attribute read per seam crossing and allocates nothing
(:func:`context_alloc_count`).

The resilience watchdog's worker adopts the owner's context
(:func:`snapshot_context` / :func:`seed_thread_context`), so a deadline
that expires inside a watched call aborts with the same typed error it
would on the owner's thread.  Seeding always replaces the thread's context.

A leaf on purpose (the metric stream and the lock registry only), so
``core/execution/resilience.py`` imports it at module scope.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from modin_tpu_torch.concurrency import named_lock, named_rlock
from modin_tpu_torch.logging.metrics import emit_metric
from modin_tpu_torch.serving.errors import DeadlineExceeded

#: True while at least one serving query context is active anywhere in the
#: process.  Seam checks read this ONE attribute before anything else.
CONTEXT_ON: bool = False

_active = 0
_active_lock = named_lock("serving.context_active")

_tls = threading.local()  # .ctx: the innermost QueryContext on this thread

_alloc_count = 0  # QueryContext objects ever constructed (zero-alloc assert)

#: Launch serialization while a serving context is active: the engine seam
#: takes it around every ``deploy``/``put`` attempt and ``device_path``
#: around every guarded call, so one thread at a time enqueues a device
#: path's kernels and copies.  The reference takes it because sharded XLA
#: programs that reach per-device queues in different orders deadlock at
#: their collectives; the port's range shuffle copies blocks between cards
#: in one order per call, and keeping one enqueuer at a time keeps that
#: order whole across threads.  Reentrant: a recovery pass re-uploads from
#: inside a failed attempt's handling on the same thread.  On one card the
#: threads' launches share the default stream, which orders them anyway.
dispatch_lock = named_rlock("resilience.dispatch")

# test seam: patched to simulate the clock advancing
_now = time.monotonic


def context_alloc_count() -> int:
    """How many query contexts this process has ever constructed (the
    serving-off contract is that this does not move)."""
    return _alloc_count


class CancellationToken:
    """One query's latency budget: a monotonic deadline plus a manual
    cancel flag.  Checked at seam boundaries; expiry and cancellation both
    surface as :class:`DeadlineExceeded`."""

    __slots__ = ("deadline_at", "deadline_s", "label", "_cancelled", "_raised")

    def __init__(self, deadline_s: Optional[float], label: str = "query"):
        self.deadline_s = deadline_s
        self.deadline_at = _now() + deadline_s if deadline_s is not None else None
        self.label = label
        self._cancelled = False
        self._raised = False

    def cancel(self) -> None:
        """Abort the query at its next seam crossing (client disconnect)."""
        self._cancelled = True

    def cancelled(self) -> bool:
        return self._cancelled

    def remaining_s(self) -> Optional[float]:
        """Seconds of budget left (None: unbounded; <= 0: expired)."""
        if self._cancelled:
            return 0.0
        if self.deadline_at is None:
            return None
        return self.deadline_at - _now()

    def expired(self) -> bool:
        remaining = self.remaining_s()
        return remaining is not None and remaining <= 0

    def check(self, where: str = "") -> None:
        """Raise :class:`DeadlineExceeded` if the budget is gone."""
        if not self.expired():
            return
        if not self._raised:
            # once per token: the owner and a seeded watchdog worker can
            # both see the expiry, but the query died once
            self._raised = True
            emit_metric("serving.deadline_exceeded", 1)
        budget = self.deadline_s if self.deadline_s is not None else 0.0
        verb = "cancelled" if self._cancelled else f"exceeded its {budget * 1e3:.0f}ms deadline"
        raise DeadlineExceeded(
            f"query {self.label!r} {verb} (observed at {where or 'seam'}; "
            "MODIN_TPU_TORCH_SERVING_DEFAULT_DEADLINE_MS)",
            deadline_s=budget,
            where=where,
        )


class QueryContext:
    """The serving state one admitted query carries across the seams."""

    __slots__ = ("token", "degraded", "tenant", "label")

    def __init__(self, token: Optional[CancellationToken], degraded: bool = False, tenant: str = "default",
                 label: str = "query"):
        global _alloc_count
        _alloc_count += 1
        self.token = token
        self.degraded = degraded
        self.tenant = tenant
        self.label = label


# ---------------------------------------------------------------------- #
# thread-local plumbing (callers check CONTEXT_ON first)
# ---------------------------------------------------------------------- #


def current_context() -> Optional[QueryContext]:
    return getattr(_tls, "ctx", None)


def current_token() -> Optional[CancellationToken]:
    ctx = getattr(_tls, "ctx", None)
    return ctx.token if ctx is not None else None


def degraded_active() -> bool:
    """Is this thread's query routed to the pandas path?"""
    ctx = getattr(_tls, "ctx", None)
    return ctx is not None and ctx.degraded


def check_deadline(where: str = "") -> None:
    """Seam check: raise DeadlineExceeded when this thread's budget is gone
    (a no-op without an active token)."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is not None and ctx.token is not None:
        ctx.token.check(where)


def remaining_s() -> Optional[float]:
    """This thread's remaining budget (None: no active deadline)."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None or ctx.token is None:
        return None
    return ctx.token.remaining_s()


#: the longest one wait for a contended dispatch lock blocks before the
#: waiter looks at its token again (a cancel lands within it)
_DISPATCH_POLL_S = 0.05


def acquire_dispatch(where: str) -> None:
    """Take :data:`dispatch_lock` within this thread's budget: a query whose
    deadline passes (or which is cancelled) while other queries' device
    paths hold the lock raises :class:`DeadlineExceeded` instead of waiting
    on.  Uncontended, it is one non-blocking acquire; the caller releases
    with ``dispatch_lock.release()``."""
    if dispatch_lock.acquire(False):
        return
    ctx = getattr(_tls, "ctx", None)
    token = ctx.token if ctx is not None else None
    if token is None:
        dispatch_lock.acquire()
        return
    while True:
        token.check(where)
        remaining = token.remaining_s()
        wait = _DISPATCH_POLL_S if remaining is None else min(remaining, _DISPATCH_POLL_S)
        if dispatch_lock.acquire(True, max(wait, 0.0)):
            return


def clamp_sleep(delay_s: float) -> float:
    """A sleep that never outlives this thread's budget: a backoff between
    engine retries sleeps at most the time left, and the next attempt's
    check turns the expiry into the typed abort."""
    remaining = remaining_s()
    if remaining is None:
        return delay_s
    return max(min(delay_s, remaining), 0.0)


def enter_context(ctx: QueryContext) -> Optional[QueryContext]:
    """Install ``ctx`` on this thread; returns the displaced context (the
    gate restores it on exit, so nested submits compose)."""
    global CONTEXT_ON, _active
    previous = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    with _active_lock:
        _active += 1
        CONTEXT_ON = True
    return previous


def exit_context(previous: Optional[QueryContext]) -> None:
    global CONTEXT_ON, _active
    _tls.ctx = previous
    with _active_lock:
        _active -= 1
        if _active <= 0:
            _active = 0
            CONTEXT_ON = False


def snapshot_context() -> Optional[QueryContext]:
    """This thread's context, for seeding a worker thread (the watchdog)."""
    return getattr(_tls, "ctx", None)


def seed_thread_context(ctx: Optional[QueryContext]) -> None:
    """Adopt (or clear) a context on a worker thread.  Always replaces: a
    worker reused for another query, or for work with no query, must not
    keep a previous query's deadline.  The active count is the owner's
    enter/exit pair's; a worker only routes checks."""
    _tls.ctx = ctx
