"""Typed serving errors: the defined failure modes under concurrent load.

The port's counterpart of ``modin_tpu/serving/errors.py``.  A query
submitted through the admission gate has three outcomes: it completes, it
is **rejected** before it uses the device (:class:`QueryRejected`, with a
retry-after hint so a well-behaved client backs off), or it is **aborted**
when its latency budget expires (:class:`DeadlineExceeded`).  An untyped
exception out of the gate is a fault of the query or of the port.

These are serving decisions, disjoint from the device taxonomy of
``core/execution/resilience.py``: a ``DeviceFailure`` means the card
misbehaved; a ``ServingError`` means the system protects itself (or the
caller's budget) on purpose.  ``classify_device_error`` never captures
them, so they pass through the engine seam untouched.
"""

from __future__ import annotations

from typing import Optional


class ServingError(RuntimeError):
    """Base of the typed serving outcomes (admission control, deadlines)."""

    kind = "serving"


class QueryRejected(ServingError):
    """The admission gate refused the query before any work ran.

    ``reason`` is the shed cause (``queue_full``, ``throttled``,
    ``unhealthy``, and on the card ``degraded``: the device was sick when
    the query was admitted); ``retry_after_s`` is the gate's estimate of
    when capacity returns (a load balancer maps it onto HTTP 429 +
    Retry-After).
    """

    kind = "rejected"

    def __init__(self, message: str, reason: str = "queue_full", retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.reason = reason
        self.retry_after_s = retry_after_s


class DeadlineExceeded(ServingError):
    """The query's latency budget expired and it was aborted.

    Raised at the seams where the cancellation token is checked (engine
    attempt start, retry backoff, the spill pass, a fused run, plan
    lowering, the admission queue), so the overshoot past the deadline is
    bounded by one engine attempt; on the card a launched kernel runs to
    the next synchronize.  ``where`` names the seam that saw the expiry.
    """

    kind = "deadline"

    def __init__(self, message: str, deadline_s: float = 0.0, where: str = ""):
        super().__init__(message)
        self.deadline_s = deadline_s
        self.where = where
