"""Per-tenant fairness state: weighted token buckets, cost EWMA, health.

The port's counterpart of ``modin_tpu/serving/tenants.py``.  Production
traffic is many sessions sharing one device, and "fair" means
three different things the gate needs per tenant:

1. **Rate fairness** — a weighted token bucket
   (``MODIN_TPU_TORCH_SERVING_TENANT_WEIGHTS``, e.g. ``"alice=3,bob=1"``;
   unlisted tenants weigh 1.0).  A tenant's bucket holds up to
   ``weight * max_concurrent`` tokens and refills at that many tokens per
   second; each admitted query spends one.  A tenant hammering past its
   weighted rate is *throttled* (typed :class:`~.errors.QueryRejected`
   with the token-refill time as the retry-after hint) while every other
   tenant's traffic flows untouched.

2. **Cost memory** — an EWMA of the device bytes each tenant's queries
   actually moved (``QueryStats.est_bytes`` from the cost capture,
   falling back to the device high-water sample for uncaptured runs).  The
   admission gate sizes its headroom reservation from this, so a tenant
   with a history of heavy queries reserves honestly and an unknown
   tenant gets the conservative default (budget / max_concurrent).

3. **Health** — one circuit breaker per tenant, the device paths'
   breakers reused as they are (``resilience.get_breaker``): a query whose run
   tripped device-path breakers (``QueryStats.breaker_trips``) strikes
   its tenant's breaker; ``ResilienceBreakerThreshold`` consecutive
   strikes trip it OPEN and that tenant's queries are rejected for the
   cooldown — the sick *workload* is quarantined, never the system.

All state lives behind one lock and is test-resettable.  The clock is the
module seam ``_now`` (resilience-style) so fairness scenarios run without
wall-clock sleeps.
"""

from __future__ import annotations

import re
import time
from collections import OrderedDict
from typing import Dict, Optional, Tuple

from modin_tpu_torch.concurrency import named_lock

# test seam: patched to simulate refill time passing
_now = time.monotonic

#: EWMA smoothing for observed per-query cost (bytes); ~5 queries of memory
_EWMA_ALPHA = 0.3

#: Token-bucket burst factor: a tenant may burst this many times its
#: steady-state weighted rate (weight * max_concurrent per second) before
#: throttling engages — normal request trains never hit the limiter, a
#: sustained hammer drains the burst and then pays the rate.
_BURST = 4.0

#: Cardinality cap on retained tenant states (the meter registry has
#: MODIN_TPU_TORCH_METERS_MAX_SERIES; per-user tenant ids need the same
#: protection here).  Past the cap, the LRU *idle* tenants — nothing in
#: flight, health breaker closed — are evicted together with their
#: breakers; active or quarantined tenants are never dropped, so the cap
#: may be transiently exceeded rather than ever losing live state.
_MAX_TENANTS = 1024

#: metric-name-safe tenant segment (emit_metric enforces [A-Za-z0-9._-])
_SANITIZE = re.compile(r"[^A-Za-z0-9_.-]+")


def sanitize(tenant: str) -> str:
    """Tenant id as a metric-name segment (never empty)."""
    return _SANITIZE.sub("_", str(tenant)) or "default"


def parse_weights(spec: str) -> Dict[str, float]:
    """``"alice=3,bob=1.5"`` -> {"alice": 3.0, "bob": 1.5}.

    Malformed entries are skipped (config must not crash admission);
    non-positive weights clamp to a minimal positive share.
    """
    weights: Dict[str, float] = {}
    for part in str(spec or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, value = part.partition("=")
        try:
            weight = float(value)
        except ValueError:
            continue
        weights[name.strip()] = max(weight, 0.01)
    return weights


class TenantState:
    """One tenant's bucket / cost memory / health handle (lock in registry)."""

    __slots__ = (
        "name", "weight", "tokens", "capacity", "refill_per_s",
        "last_refill", "cost_ewma_bytes", "wall_ewma_s", "in_flight",
        "admitted", "shed", "gen",
    )

    def __init__(self, name: str, weight: float, max_concurrent: int):
        self.name = name
        self.cost_ewma_bytes: Optional[float] = None
        self.wall_ewma_s: Optional[float] = None
        self.in_flight = 0
        self.admitted = 0
        self.shed = 0
        self.gen = 0
        self.tokens = 0.0
        self.last_refill = _now()
        self.retune(weight, max_concurrent, 0)
        self.tokens = self.capacity  # new tenants start with a full burst

    def retune(self, weight: float, max_concurrent: int, gen: int) -> None:
        """Apply the CURRENT weight/concurrency config (the registry calls
        this when a knob changed since the tenant's last admission: runtime
        re-weighting must apply to already-seen tenants, not only new
        ones).  Tokens are clamped, never topped up, by a retune."""
        self.weight = weight
        self.refill_per_s = max(weight * max_concurrent, 1.0)
        self.capacity = self.refill_per_s * _BURST
        self.tokens = min(self.tokens, self.capacity)
        self.gen = gen

    # -- token bucket (caller holds the registry lock) ------------------ #

    def _refill(self) -> None:
        now = _now()
        elapsed = now - self.last_refill
        if elapsed > 0:
            self.tokens = min(
                self.capacity, self.tokens + elapsed * self.refill_per_s
            )
            self.last_refill = now

    def try_spend(self) -> Tuple[bool, float]:
        """(spent, retry_after_s): take one token, or how long until one."""
        self._refill()
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True, 0.0
        return False, (1.0 - self.tokens) / self.refill_per_s

    # -- cost / latency memory ------------------------------------------ #

    def observe(self, cost_bytes: float, wall_s: float) -> None:
        if cost_bytes > 0:
            self.cost_ewma_bytes = (
                cost_bytes
                if self.cost_ewma_bytes is None
                else (1 - _EWMA_ALPHA) * self.cost_ewma_bytes
                + _EWMA_ALPHA * cost_bytes
            )
        if wall_s > 0:
            self.wall_ewma_s = (
                wall_s
                if self.wall_ewma_s is None
                else (1 - _EWMA_ALPHA) * self.wall_ewma_s
                + _EWMA_ALPHA * wall_s
            )


class TenantRegistry:
    """Thread-safe name -> :class:`TenantState`: weights resolved lazily
    and RE-resolved when the knobs change (config generation), LRU-bounded
    at :data:`_MAX_TENANTS` idle tenants."""

    def __init__(self) -> None:
        self._lock = named_lock("serving.tenants")
        self._tenants: "OrderedDict[str, TenantState]" = OrderedDict()
        self._gen = 1  # any state created before wiring retunes on touch

    def _bump_gen(self, _param=None) -> None:
        """Config subscription: a weight/concurrency knob changed — every
        tenant re-applies it on its next touch."""
        with self._lock:
            self._gen += 1

    def _weights(self) -> Dict[str, float]:
        from modin_tpu_torch.config import ServingTenantWeights

        return parse_weights(ServingTenantWeights.get())

    def _max_concurrent(self) -> int:
        from modin_tpu_torch.config import ServingMaxConcurrent

        return max(int(ServingMaxConcurrent.get()), 1)

    def _get_locked(self, tenant: str) -> TenantState:
        state = self._tenants.get(tenant)
        if state is None:
            weight = self._weights().get(tenant, 1.0)
            state = TenantState(tenant, weight, self._max_concurrent())
            state.gen = self._gen
            self._tenants[tenant] = state
            self._evict_idle_locked()
        else:
            self._tenants.move_to_end(tenant)  # LRU touch
            if state.gen != self._gen:
                state.retune(
                    self._weights().get(tenant, 1.0),
                    self._max_concurrent(),
                    self._gen,
                )
        return state

    def _evict_idle_locked(self) -> None:
        """Cap the registry: drop the LRU tenants that are idle (nothing in
        flight) with a CLOSED health breaker, together with their breakers
        — per-user tenant ids must not grow process memory without bound.
        An open breaker is quarantine state and survives; its tenant stays."""
        if len(self._tenants) <= _MAX_TENANTS:
            return
        from modin_tpu_torch.core.execution.resilience import drop_breaker

        for name in list(self._tenants):
            if len(self._tenants) <= _MAX_TENANTS:
                return
            state = self._tenants[name]
            if state.in_flight > 0 or breaker_for(name).state != "closed":
                continue
            del self._tenants[name]
            drop_breaker(f"tenant_{sanitize(name)}")

    def get(self, tenant: str) -> TenantState:
        with self._lock:
            return self._get_locked(tenant)

    def try_spend(self, tenant: str) -> Tuple[bool, float]:
        with self._lock:
            return self._get_locked(tenant).try_spend()

    def refund(self, tenant: str) -> None:
        """Return one rate token (the query was shed on CAPACITY grounds —
        queue full, or its deadline expired while queued — so it never ran;
        charging the tenant's rate for it would misattribute system
        overload to the tenant and quarantine a polite retrying client)."""
        with self._lock:
            state = self._get_locked(tenant)
            state.tokens = min(state.tokens + 1.0, state.capacity)

    def observe(self, tenant: str, cost_bytes: float, wall_s: float) -> None:
        with self._lock:
            self._get_locked(tenant).observe(cost_bytes, wall_s)

    # counter mutations all pass through the registry lock: the gate calls
    # note_admitted under ITS lock (order gate -> registry, consistent with
    # every other nesting) while note_release runs lock-free on the gate
    # side — unsynchronized read-modify-writes would drift in_flight, and
    # in_flight feeds the weighted-fair wake order, not just diagnostics

    def note_admitted(self, tenant: str) -> float:
        """Count an admission; returns the tenant's weight (for waiters)."""
        with self._lock:
            state = self._get_locked(tenant)
            state.in_flight += 1
            state.admitted += 1
            return state.weight

    def note_release(self, tenant: str) -> None:
        with self._lock:
            state = self._get_locked(tenant)
            state.in_flight = max(state.in_flight - 1, 0)

    def note_shed(self, tenant: str) -> None:
        with self._lock:
            self._get_locked(tenant).shed += 1

    def cost_estimate(self, tenant: str, default_bytes: float) -> float:
        """The tenant's EWMA cost, or the conservative default for a tenant
        with no history (unknown cost must reserve big, not small)."""
        with self._lock:
            state = self._tenants.get(tenant)
            if state is None or state.cost_ewma_bytes is None:
                return default_bytes
            return state.cost_ewma_bytes

    def wall_hint(self, tenant: str, fallback_s: float) -> float:
        with self._lock:
            state = self._tenants.get(tenant)
            if state is None or state.wall_ewma_s is None:
                return fallback_s
            return state.wall_ewma_s

    def snapshot(self) -> dict:
        with self._lock:
            return {
                name: {
                    "weight": s.weight,
                    "tokens": round(s.tokens, 3),
                    "in_flight": s.in_flight,
                    "admitted": s.admitted,
                    "shed": s.shed,
                    "cost_ewma_bytes": s.cost_ewma_bytes,
                    "wall_ewma_s": s.wall_ewma_s,
                    "breaker": breaker_for(name).state,
                }
                for name, s in sorted(self._tenants.items())
            }

    def reset(self) -> None:
        with self._lock:
            self._tenants.clear()


def breaker_for(tenant: str):
    """The tenant's health breaker: the device paths' circuit breakers,
    one ad-hoc family per tenant (``tenant_<name>``; the device-path
    family registry is for the query compiler's paths, and ad-hoc
    families are the documented escape hatch tests already use)."""
    from modin_tpu_torch.core.execution.resilience import get_breaker

    return get_breaker(f"tenant_{sanitize(tenant)}")


registry = TenantRegistry()

# runtime re-weighting: the knobs fire the generation bump immediately on
# subscribe and on every later put(), so an operator raising a tenant's
# weight (or the gate's concurrency) retunes already-seen tenants on their
# next admission instead of freezing first-touch values forever
from modin_tpu_torch.config import (  # noqa: E402
    ServingMaxConcurrent as _ServingMaxConcurrent,
    ServingTenantWeights as _ServingTenantWeights,
)

_ServingTenantWeights.subscribe(registry._bump_gen)
_ServingMaxConcurrent.subscribe(registry._bump_gen)
