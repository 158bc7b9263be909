"""Anomaly tripwires: declarative rules over the rings.

The port's counterpart of ``modin_tpu/observability/watch/tripwires.py``.
A tripwire is a named predicate evaluated after every sampler tick.  When it
fires it (1) emits ``watch.trip.<rule>``, (2) enters the service's
recent-trips ring (``/statusz``) and (3) writes an **evidence bundle** to
``MODIN_TPU_TORCH_TRACE_DIR``: the flight recorder's spans as a chrome
trace (empty while tracing is off), the meter snapshot, a ring excerpt and
the SLO table, in one JSON file.  A bundle claims the flight recorder's
dump window, so a flapping rule (or a tripwire racing a breaker's dump of
the same incident) writes one file set, and each rule re-arms only after
:data:`RULE_COOLDOWN_S`.

The rules:

- ``latency_shift``: the fast window's p99 of ``serving.query_wall_s`` at
  least :data:`LATENCY_SHIFT_FACTOR` times the preceding window's, both
  with :data:`LATENCY_MIN_SAMPLES` samples and the new p99 past
  :data:`LATENCY_FLOOR_S`;
- ``recompile_storm``: the launch ledger's storm-signature count grew in
  the window (fused programs whose fingerprints keep changing);
- ``spill_thrash``: at least :data:`SPILL_MIN_EVENTS` device spills in the
  window while the cache hits (fused programs, sorted representations,
  views) fell against the previous window;
- ``shed_spike``: at least :data:`SHED_MIN_EVENTS` typed sheds in the window;
- ``slo_burn``: a tenant's two-window SLO burn verdict is breaching;
- ``fold_lag``: the feeds' worst fold lag passes
  ``MODIN_TPU_TORCH_INGEST_FOLD_LAG_MS``.

Every evaluation is isolated: a broken rule trips nothing and never reaches
the sampler loop.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import time
from collections import deque
from typing import Callable, List, Optional

from modin_tpu_torch.observability.watch.timeseries import note_alloc

#: the evaluation window, seconds
WINDOW_S = 60.0

#: a rule's re-trip spacing (the bundles have their own shared limit)
RULE_COOLDOWN_S = 30.0

LATENCY_SHIFT_FACTOR = 2.0
LATENCY_FLOOR_S = 0.005
LATENCY_MIN_SAMPLES = 8
SPILL_MIN_EVENTS = 4
SHED_MIN_EVENTS = 4

#: ring samples an evidence bundle carries
EVIDENCE_RING_SAMPLES = 120


class Tripwire:
    """One rule: ``check(service, now)`` returns a detail string when it
    trips, else None."""

    __slots__ = ("name", "description", "_check", "last_tripped", "trips")

    def __init__(self, name: str, description: str, check: Callable[[object, float], Optional[str]]) -> None:
        note_alloc()
        self.name = name
        self.description = description
        self._check = check
        self.last_tripped: Optional[float] = None
        self.trips = 0

    def evaluate(self, service: object, now: float) -> Optional[str]:
        if self.last_tripped is not None and now - self.last_tripped < RULE_COOLDOWN_S:
            return None
        try:
            detail = self._check(service, now)
        except Exception:
            return None  # a broken rule never reaches the sampler loop
        if detail is not None:
            self.last_tripped = now
            self.trips += 1
        return detail


# ---------------------------------------------------------------------- #
# the rules
# ---------------------------------------------------------------------- #


def _latency_shift(service, now: float) -> Optional[str]:
    rings = service.rings
    recent = rings.quantile("serving.query_wall_s", 0.99, WINDOW_S, now)
    baseline = rings.quantile("serving.query_wall_s", 0.99, WINDOW_S, now, end_offset_s=WINDOW_S)
    if recent is None or baseline is None or baseline <= 0:
        return None
    ring = rings.get("serving.query_wall_s")
    recent_n = ring.window_count(WINDOW_S, now)
    base_delta = ring.hist_delta(now - 2 * WINDOW_S, now - WINDOW_S)
    base_n = base_delta[2] if base_delta is not None else 0
    if recent_n < LATENCY_MIN_SAMPLES or base_n < LATENCY_MIN_SAMPLES:
        return None
    if recent < LATENCY_FLOOR_S:
        return None
    if recent >= LATENCY_SHIFT_FACTOR * baseline:
        return (
            f"query p99 shifted {recent * 1e3:.1f}ms vs trailing baseline "
            f"{baseline * 1e3:.1f}ms ({recent / baseline:.1f}x over "
            f"{WINDOW_S:g}s windows, n={recent_n})"
        )
    return None


def _recompile_storm(service, now: float) -> Optional[str]:
    ring = service.rings.get("compile.storm_signatures")
    if ring is None:
        return None
    window = ring.between(now - WINDOW_S, now)
    if len(window) < 2:
        return None
    growth = float(window[-1][1]) - float(window[0][1])
    if growth >= 1:
        return (
            f"recompile-storm signatures grew by {growth:g} (now "
            f"{window[-1][1]:g}) inside {WINDOW_S:g}s — shape/dtype churn "
            "is defeating the executable cache"
        )
    return None


def _spill_thrash(service, now: float) -> Optional[str]:
    rings = service.rings
    spills = rings.delta("memory.device.spill", WINDOW_S, now)
    if spills is None or spills < SPILL_MIN_EVENTS:
        return None

    def hits(t0: float, t1: float) -> float:
        total = 0.0
        for name in ("fusion.cache.hit", "sortcache.hit", "view.hit"):
            ring = rings.get(name)
            if ring is None:
                continue
            window = ring.between(t0, t1)
            if len(window) >= 2:
                total += max(float(window[-1][1]) - float(window[0][1]), 0.0)
        return total

    recent_hits = hits(now - WINDOW_S, now)
    prior_hits = hits(now - 2 * WINDOW_S, now - WINDOW_S)
    if recent_hits < prior_hits:
        return (
            f"{spills:g} device spills in {WINDOW_S:g}s while cache hits "
            f"fell ({prior_hits:g} -> {recent_hits:g}): the ledger is "
            "evicting caches the workload is consuming"
        )
    return None


def _shed_spike(service, now: float) -> Optional[str]:
    shed = service.rings.delta("serving.shed", WINDOW_S, now)
    if shed is not None and shed >= SHED_MIN_EVENTS:
        return f"{shed:g} queries shed in {WINDOW_S:g}s — the admission gate is rejecting sustained load"
    return None


def _slo_burn(service, now: float) -> Optional[str]:
    breaching = service.slo.breaching(now)
    if not breaching:
        return None
    parts = ", ".join(
        f"{tenant} (fast={verdict['fast_burn']}, slow={verdict['slow_burn']}, "
        f"objective={verdict['objective_ms']:g}ms)"
        for tenant, verdict in breaching.items()
    )
    return f"SLO error budget burning faster than sustainable for: {parts}"


def _fold_lag(service, now: float) -> Optional[str]:
    ingest_mod = sys.modules.get("modin_tpu_torch.ingest")
    if ingest_mod is None or not ingest_mod.INGEST_ON:
        return None
    from modin_tpu_torch.config import IngestFoldLagMs

    bound_ms = float(IngestFoldLagMs.get())
    lag_ms = ingest_mod.max_fold_lag_ms()
    if lag_ms > bound_ms:
        return (
            f"live-view fold lag {lag_ms:.0f}ms exceeds the "
            f"{bound_ms:g}ms bound (MODIN_TPU_TORCH_INGEST_FOLD_LAG_MS) — "
            "ingest is outrunning view maintenance; staleness-bounded "
            "reads are paying forced synchronous folds"
        )
    return None


def default_rules() -> List[Tripwire]:
    return [
        Tripwire("latency_shift", "query-latency p99 shifted vs the trailing baseline window", _latency_shift),
        Tripwire("recompile_storm", "launch-ledger recompile-storm signature count grew", _recompile_storm),
        Tripwire("spill_thrash", "device spill burst while cache hit traffic fell", _spill_thrash),
        Tripwire("shed_spike", "admission-gate shed burst", _shed_spike),
        Tripwire("slo_burn", "a tenant's multi-window SLO burn rate is breaching", _slo_burn),
        Tripwire("fold_lag", "live-view fold lag exceeds the configured bound", _fold_lag),
    ]


# ---------------------------------------------------------------------- #
# evidence
# ---------------------------------------------------------------------- #


def capture_evidence(rule: str, detail: str, service) -> Optional[str]:
    """Write one evidence bundle for a tripped rule; its path, or None (the
    dump window is claimed, or the write failed).  Never raises: it runs on
    the sampler thread."""
    from modin_tpu_torch.observability import flight_recorder as _fr

    claimed = _fr.claim_dump_window()
    if claimed is None:
        return None
    try:
        from modin_tpu_torch.config import TraceDir
        from modin_tpu_torch.observability import meters as _meters
        from modin_tpu_torch.observability import spans as _spans
        from modin_tpu_torch.observability.chrome_trace import to_chrome_trace

        bundle = {
            "kind": "watch-evidence",
            "rule": rule,
            "detail": detail,
            "tripped_at_unix_s": time.time(),
            # the flight ring now (empty while tracing is off: the bundle
            # says so rather than leaving the key out)
            "trace": to_chrome_trace(
                _fr.flight_snapshot(),
                other_data={"reason": f"watch.trip.{rule}", "detail": detail},
                counters=_spans.counter_samples(),
            ),
            "metrics": _meters.snapshot(),
            "rings": service.rings.excerpt(EVIDENCE_RING_SAMPLES),
            "slo": service.slo.health(),
        }
        outdir = pathlib.Path(TraceDir.get())
        outdir.mkdir(parents=True, exist_ok=True)
        path = outdir / f"watchtrip_{rule}_{os.getpid()}_{int(time.time() * 1e3)}.json"
        path.write_text(json.dumps(bundle))
        from modin_tpu_torch.logging.metrics import emit_metric

        emit_metric("watch.evidence", 1)
        return str(path)
    except Exception:
        _fr.release_dump_claim(claimed)
        return None


class TripwireEngine:
    """Evaluates the rules each tick and keeps the recent trips."""

    def __init__(self, service) -> None:
        note_alloc()
        self._service = service
        self.rules = default_rules()
        self.recent: deque = deque(maxlen=32)

    def on_tick(self, now: float) -> None:
        for rule in self.rules:
            detail = rule.evaluate(self._service, now)
            if detail is None:
                continue
            try:
                from modin_tpu_torch.logging.metrics import emit_metric

                emit_metric(f"watch.trip.{rule.name}", 1)
            except Exception:
                pass
            evidence = capture_evidence(rule.name, detail, self._service)
            self.recent.append(
                {"rule": rule.name, "detail": detail, "at_unix_s": round(time.time(), 3), "evidence": evidence}
            )

    def snapshot(self) -> List[dict]:
        return list(self.recent)
