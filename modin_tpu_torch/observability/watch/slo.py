"""Per-tenant SLO tracking: latency objectives and burn rates.

The port's counterpart of ``modin_tpu/observability/watch/slo.py``.  An SLO
is "at least :data:`TARGET_FRACTION` of a tenant's admitted queries finish
under its objective"; objectives come from ``MODIN_TPU_TORCH_WATCH_SLO_MS``
(``"default=250,alice=50"``; a bare number is ``default=``).  The serving
gate feeds every finished query's ``(tenant, wall_s)`` through
``watch.observe_query`` (one attribute read while watch is off), and the
feeds every view read's fold lag under a ``view:<feed>/<view>`` tenant.

Burn rate, over a window, is ``bad_fraction / (1 - TARGET_FRACTION)``: 1.0
spends the error budget exactly as fast as the SLO allows.  Two windows
(:data:`FAST_WINDOW_S`, :data:`SLOW_WINDOW_S`); a tenant is *breaching*
when both burn above 1.0 with at least :data:`MIN_SAMPLES` observations in
the fast window, so one slow query never pages and a recovered incident
stops paging once the fast window clears.  The verdict is advisory: the
gate's snapshot shows it beside the breakers and the ``slo_burn`` tripwire
captures evidence; nothing is shed for it.
"""

from __future__ import annotations

import time
from collections import OrderedDict, deque
from typing import Dict, Optional

from modin_tpu_torch.concurrency import named_lock
from modin_tpu_torch.observability.watch.timeseries import note_alloc

#: the fraction of queries that must meet the objective (the error budget
#: is ``1 - TARGET_FRACTION``)
TARGET_FRACTION = 0.99

#: the two burn windows, seconds (tests and the smoke shrink them)
FAST_WINDOW_S = 60.0
SLOW_WINDOW_S = 300.0

#: fast-window observations a breach needs
MIN_SAMPLES = 4

#: observations kept a tenant, and tenants kept (least recently observed
#: out first, as ``serving/tenants.py`` bounds its table)
_MAX_OBSERVATIONS = 4096
_MAX_TENANTS = 1024


def parse_slo_ms(spec: str) -> Dict[str, float]:
    """``"default=250,alice=50"`` -> ``{"default": 0.25, "alice": 0.05}``
    (seconds).  A bare number is ``default=``; malformed or non-positive
    entries are skipped: a setting never crashes telemetry."""
    objectives: Dict[str, float] = {}
    for part in str(spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            name, _, value = part.partition("=")
            name = name.strip()
        else:
            name, value = "default", part
        try:
            ms = float(value)
        except ValueError:
            continue
        if ms > 0 and name:
            objectives[name] = ms / 1e3
    return objectives


class SloTracker:
    """Per-tenant latency observations and their burn rates, thread-safe."""

    def __init__(self) -> None:
        note_alloc()
        self._lock = named_lock("watch.slo")
        self._observations: "OrderedDict[str, deque]" = OrderedDict()
        self.evicted_tenants = 0

    def _objectives(self) -> Dict[str, float]:
        from modin_tpu_torch.config import WatchSloMs

        return parse_slo_ms(WatchSloMs.get())

    def observe(self, tenant: str, wall_s: float, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            ring = self._observations.get(tenant)
            if ring is None:
                while len(self._observations) >= _MAX_TENANTS:
                    self._observations.popitem(last=False)
                    self.evicted_tenants += 1
                ring = self._observations[tenant] = deque(maxlen=_MAX_OBSERVATIONS)
            else:
                self._observations.move_to_end(tenant)
            # prune by age on the write: nothing reads past the slow window,
            # and health() copies every ring under this lock each tick
            horizon = now - SLOW_WINDOW_S
            while ring and ring[0][0] < horizon:
                ring.popleft()
            ring.append((now, float(wall_s)))

    def objective_s(self, tenant: str) -> Optional[float]:
        """The tenant's objective, seconds (its own entry, else ``default``),
        or None."""
        objectives = self._objectives()
        return objectives.get(tenant, objectives.get("default"))

    @staticmethod
    def _burn(window: list, objective_s: float) -> Optional[float]:
        if not window:
            return None
        bad = sum(1 for _t, wall in window if wall > objective_s)
        budget = max(1.0 - TARGET_FRACTION, 1e-9)
        return (bad / len(window)) / budget

    def health(self, now: Optional[float] = None) -> Dict[str, dict]:
        """The burn verdict of every observed tenant that has an objective;
        ``breaching`` is the advisory two-window verdict."""
        now = time.monotonic() if now is None else now
        objectives = self._objectives()
        if not objectives:
            return {}
        with self._lock:
            observed = {tenant: list(ring) for tenant, ring in self._observations.items()}
        out: Dict[str, dict] = {}
        for tenant, obs in sorted(observed.items()):
            objective = objectives.get(tenant, objectives.get("default"))
            if objective is None:
                continue
            fast = [s for s in obs if s[0] >= now - FAST_WINDOW_S]
            slow = [s for s in obs if s[0] >= now - SLOW_WINDOW_S]
            fast_burn = self._burn(fast, objective)
            slow_burn = self._burn(slow, objective)
            breaching = bool(
                fast_burn is not None and slow_burn is not None and len(fast) >= MIN_SAMPLES
                and fast_burn > 1.0 and slow_burn > 1.0
            )
            out[tenant] = {
                "objective_ms": round(objective * 1e3, 3),
                "target": TARGET_FRACTION,
                "fast_window_s": FAST_WINDOW_S,
                "slow_window_s": SLOW_WINDOW_S,
                "fast_burn": round(fast_burn, 3) if fast_burn is not None else None,
                "slow_burn": round(slow_burn, 3) if slow_burn is not None else None,
                "fast_samples": len(fast),
                "breaching": breaching,
            }
        return out

    def breaching(self, now: Optional[float] = None) -> Dict[str, dict]:
        """The tenants breaching now (the ``slo_burn`` tripwire)."""
        return {tenant: v for tenant, v in self.health(now).items() if v["breaching"]}

    def latency_stats(self, now: Optional[float] = None) -> Dict[str, dict]:
        """Per tenant, the fast window's p50, p99 and count, objective or not
        (``/statusz``)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            observed = {
                tenant: [wall for t, wall in ring if t >= now - FAST_WINDOW_S]
                for tenant, ring in self._observations.items()
            }
        out: Dict[str, dict] = {}
        for tenant, walls in sorted(observed.items()):
            if not walls:
                continue
            ordered = sorted(walls)

            def pick(q: float) -> float:
                return ordered[min(int(q * (len(ordered) - 1) + 0.5), len(ordered) - 1)]

            out[tenant] = {
                "count": len(ordered),
                "p50_ms": round(pick(0.50) * 1e3, 3),
                "p99_ms": round(pick(0.99) * 1e3, 3),
            }
        return out

    def reset(self) -> None:
        with self._lock:
            self._observations.clear()
            self.evicted_tenants = 0
