"""Live telemetry: the background service that watches the serving port.

The port's counterpart of ``modin_tpu/observability/watch/``.  The spans,
meters and costs answer when asked, from inside the process; the flight
recorder dumps after a breaker opened.  The watch service runs beside the
queries, in four legs:

1. **time-series rings** (``timeseries.py``): a sampler thread folds the
   meter registry, the ledger gauges, the gate's depth and the launch
   ledger's totals into bounded rings every ``MODIN_TPU_TORCH_WATCH_INTERVAL_S``;
2. **the exporter** (``httpd.py``): ``/metrics``, ``/statusz`` and
   ``/debug/queries`` on ``MODIN_TPU_TORCH_WATCH_PORT``;
3. **per-tenant SLO burn** (``slo.py``): objectives from
   ``MODIN_TPU_TORCH_WATCH_SLO_MS``, fed per query by the serving gate
   (:func:`observe_query`) and per view read by the feeds
   (:func:`observe_view_read`), shown beside the gate's breakers;
4. **tripwires** (``tripwires.py``): rules over the rings that emit
   ``watch.trip.<rule>`` and write a rate-limited evidence bundle.

Off (``MODIN_TPU_TORCH_WATCH=0``, the default): no sampler or exporter
thread, the gate's per-query hook reads :data:`WATCH_ON` and nothing else,
and nothing is made (:func:`watch_alloc_count`).  A crash of the sampler
emits ``watch.sampler.died`` and turns the service off instead of taking
queries down.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from modin_tpu_torch.concurrency import named_rlock
from modin_tpu_torch.observability.watch.timeseries import (  # noqa: F401
    Ring,
    RingStore,
    Sampler,
)
from modin_tpu_torch.observability.watch.timeseries import alloc_count as _ts_alloc_count

#: the hooks' fast path: True only while the service runs
WATCH_ON: bool = False

_state_lock = named_rlock("watch.state")
_service: Optional["WatchService"] = None


def watch_alloc_count() -> int:
    """Watch objects ever made (rings, trackers, tripwires, samplers)."""
    return _ts_alloc_count()


class WatchService:
    """Rings, sampler, SLO tracker, tripwires and exporter: one instance
    while ``MODIN_TPU_TORCH_WATCH=1``."""

    def __init__(self) -> None:
        from modin_tpu_torch.observability.watch.httpd import Exporter
        from modin_tpu_torch.observability.watch.slo import SloTracker
        from modin_tpu_torch.observability.watch.tripwires import TripwireEngine

        self.rings = RingStore()
        self.slo = SloTracker()
        self.tripwires = TripwireEngine(self)
        self.sampler = Sampler(self.rings, on_tick=self.tripwires.on_tick, on_died=self._on_sampler_died)
        self.exporter = Exporter(self)
        self.started_monotonic: Optional[float] = None
        self.started_wall: Optional[float] = None
        self._registry_hold = False

    def start(self) -> None:
        """Start the sampler and the exporter (idempotent)."""
        if self.started_monotonic is None:
            self.started_monotonic = time.monotonic()
            self.started_wall = time.time()
        if not self._registry_hold:
            # the rings, /metrics and the registry-fed tripwires need the
            # registry's series whatever MODIN_TPU_TORCH_METERS says
            from modin_tpu_torch.observability import meters as _meters

            _meters.acquire_registry()
            self._registry_hold = True
        self.sampler.start()
        from modin_tpu_torch.config import WatchPort

        port = int(WatchPort.get())
        if port >= 0:
            self.exporter.start(port)

    def _release_registry(self) -> None:
        if self._registry_hold:
            self._registry_hold = False
            from modin_tpu_torch.observability import meters as _meters

            _meters.release_registry()

    def stop(self) -> None:
        """Stop the sampler and the exporter (the state stays readable)."""
        self.sampler.stop()
        self.exporter.stop()
        self._release_registry()

    def _on_sampler_died(self, _err: BaseException) -> None:
        """The sampler crashed: turn the fast path off and stop the
        exporter, without joining the dying thread (the caller)."""
        global WATCH_ON
        with _state_lock:
            if self.sampler._thread is not threading.current_thread():
                return  # a stop and restart raced this callback: not ours
            WATCH_ON = False
            self.exporter.stop()
            self._release_registry()

    # -- /statusz -------------------------------------------------------- #

    def statusz_text(self) -> str:
        """The one-page status.  Each section is isolated: a broken seam
        renders as an error line, never a 500."""
        lines: List[str] = ["modin_tpu_torch watch /statusz", ""]

        def section(title: str, render) -> None:
            lines.append(f"== {title} ==")
            try:
                render()
            except Exception as err:
                lines.append(f"  <unavailable: {type(err).__name__}: {err}>")
            lines.append("")

        def _service_section() -> None:
            uptime = time.monotonic() - self.started_monotonic if self.started_monotonic is not None else 0.0
            sampler = self.sampler
            age = time.monotonic() - sampler.last_tick_t if sampler.last_tick_t is not None else None
            lines.append(f"  pid: {os.getpid()}  uptime: {uptime:.1f}s")
            age_txt = f"{age:.1f}" if age is not None else "?"
            lines.append(f"  sampler: ticks={sampler.ticks} last_tick_age_s={age_txt}")
            if sampler.died:
                lines.append(f"  sampler DIED: {sampler.error}")
            lines.append(f"  rings: {len(self.rings)} series (dropped={self.rings.dropped_series})")
            lines.append(f"  exporter: 127.0.0.1:{self.exporter.port}")

        def _substrate_section() -> None:
            mesh = sys.modules.get("modin_tpu_torch.parallel.mesh")
            shape = mesh.mesh_shape_key() if mesh is not None else "uninitialized"
            lines.append(f"  mesh shape: {shape}")
            from modin_tpu_torch.observability import spans as _spans

            device_bytes, host_bytes = _spans._ledger_bytes()
            lines.append(f"  ledger: device_resident={device_bytes}B host_cache={host_bytes}B")

        def _rates_section() -> None:
            window = 60.0

            def fmt(value: Optional[float], unit: str) -> str:
                return f"{value:.3g}{unit}" if value is not None else "?"

            lines.append(
                f"  (trailing {window:g}s)  "
                f"dispatch/s: {fmt(self.rings.rate('engine.dispatch', window), '')}  "
                f"spill B/s: {fmt(self.rings.rate('memory.device.spill_bytes', window), '')}  "
                f"compiles: {fmt(self.rings.delta('compile.total', window), '')}"
            )
            p50 = self.rings.quantile("serving.query_wall_s", 0.50, window)
            p99 = self.rings.quantile("serving.query_wall_s", 0.99, window)
            lines.append(
                "  query wall: "
                f"p50={fmt(p50 * 1e3 if p50 is not None else None, 'ms')} "
                f"p99={fmt(p99 * 1e3 if p99 is not None else None, 'ms')}"
            )

        def _gate_section() -> None:
            gate_mod = sys.modules.get("modin_tpu_torch.serving.gate")
            if gate_mod is None:
                lines.append("  serving not active in this process")
                return
            snap = gate_mod.gate.snapshot()
            lines.append(
                f"  running={snap['running']}/{snap['max_concurrent']} "
                f"queued={snap['queued']}/{snap['queue_depth']} "
                f"admitted={snap['admitted']} shed={snap['shed']} degraded={snap['degraded']}"
            )

        def _tenants_section() -> None:
            tenants_mod = sys.modules.get("modin_tpu_torch.serving.tenants")
            tenant_rows = tenants_mod.registry.snapshot() if tenants_mod else {}
            health = self.slo.health()
            stats = self.slo.latency_stats()
            names = sorted(set(tenant_rows) | set(health) | set(stats))
            if not names:
                lines.append("  no tenants observed")
                return
            lines.append("  tenant | in_flight | admitted | shed | breaker | p50/p99 (60s) | slo fast/slow burn")
            for name in names:
                row = tenant_rows.get(name, {})
                st = stats.get(name, {})
                verdict = health.get(name)
                latency = f"{st.get('p50_ms', '?')}/{st.get('p99_ms', '?')}ms" if st else "?"
                slo_txt = "-"
                if verdict is not None:
                    slo_txt = f"{verdict['fast_burn']}/{verdict['slow_burn']}" + (
                        " BREACHING" if verdict["breaching"] else "")
                lines.append(
                    f"  {name} | {row.get('in_flight', 0)} | {row.get('admitted', 0)} | "
                    f"{row.get('shed', 0)} | {row.get('breaker', '?')} | {latency} | {slo_txt}"
                )

        def _fleet_section() -> None:
            fleet_mod = sys.modules.get("modin_tpu_torch.fleet")
            if fleet_mod is None or not fleet_mod.FLEET_ON:
                lines.append("  fleet not active in this process")
                return
            coordinator = fleet_mod.get_coordinator()
            if coordinator is None:
                lines.append("  fleet enabled, no coordinator here (replica process)")
                return
            snap = coordinator.snapshot()
            lines.append("  replica | state | gen | pid | rpc_port | watch_port | tenants | in_flight | "
                         "shed_rate | p50/p99 (ms)")
            for row in snap["replicas"]:
                latency = f"{row['p50_ms']:.1f}/{row['p99_ms']:.1f}" if row["p50_ms"] is not None else "?"
                lines.append(
                    f"  {row['index']} | {row['state']} | {row['generation']} | {row['pid']} | "
                    f"{row['rpc_port']} | {row['watch_port']} | {row['tenants']} | {row['in_flight']} | "
                    f"{row['shed_rate']:.2f}/s | {latency}"
                )
            lines.append(
                f"  routed={snap['routed']} redispatched={snap['redispatched']} lost={snap['lost']} "
                f"respawned={snap['respawned']} tenants_redistributed={snap['redistributed']}"
            )

        def _trips_section() -> None:
            recent = self.tripwires.snapshot()
            if not recent:
                lines.append("  none")
                return
            for trip in recent[-10:]:
                lines.append(f"  [{trip['at_unix_s']}] {trip['rule']}: {trip['detail']}  evidence={trip['evidence']}")

        section("service", _service_section)
        section("substrate", _substrate_section)
        section("windowed rates", _rates_section)
        section("admission gate", _gate_section)
        section("tenants", _tenants_section)
        section("fleet", _fleet_section)
        section("recent tripwires", _trips_section)
        return "\n".join(lines)


# ---------------------------------------------------------------------- #
# the module's API
# ---------------------------------------------------------------------- #


def get_service() -> Optional[WatchService]:
    """The service (present once watch was ever on in this process; its
    threads run only while :data:`WATCH_ON`)."""
    return _service


def observe_query(tenant: str, wall_s: float, failure_kind: Optional[str] = None) -> None:
    """One finished serving query into the tenant's SLO observations.  The
    gate reads :data:`WATCH_ON` first; this re-check covers the teardown
    race.  A query its deadline killed counts as a latency observation too."""
    service = _service
    if service is None or not WATCH_ON:
        return
    try:
        service.slo.observe(tenant, wall_s)
    except Exception:
        pass


def observe_view_read(view_key: str, lag_s: float) -> None:
    """One live-view read of a feed: its fold lag into the SLO machinery
    under the tenant ``view:<feed>/<view>``, so a view's staleness burns and
    shows like a tenant's latency.  Callers read :data:`WATCH_ON` first."""
    service = _service
    if service is None or not WATCH_ON:
        return
    try:
        service.slo.observe(f"view:{view_key}", lag_s)
    except Exception:
        pass


def slo_health() -> Dict[str, dict]:
    """Per-tenant burn verdicts ({} while off or untracked)."""
    service = _service
    if service is None:
        return {}
    try:
        return service.slo.health()
    except Exception:
        return {}


def httpd_port() -> Optional[int]:
    """The exporter's live port, or None while it serves nothing."""
    service = _service
    return service.exporter.port if service is not None else None


def recent_trips() -> List[dict]:
    service = _service
    return service.tripwires.snapshot() if service is not None else []


def watch_snapshot() -> Dict[str, Any]:
    """The service's state, for tests and dashboards."""
    service = _service
    if service is None:
        return {"enabled": WATCH_ON, "service": None}
    return {
        "enabled": WATCH_ON,
        "sampler": {
            "alive": service.sampler.is_alive(),
            "ticks": service.sampler.ticks,
            "died": service.sampler.died,
            "error": service.sampler.error,
        },
        "exporter_port": service.exporter.port,
        "ring_series": len(service.rings),
        "recent_trips": service.tripwires.snapshot(),
        "slo": slo_health(),
    }


def reset_for_tests() -> None:
    """Stop the service and forget it (the next start makes a new one)."""
    global _service, WATCH_ON
    with _state_lock:
        WATCH_ON = False
        if _service is not None:
            _service.stop()
        _service = None


# ---------------------------------------------------------------------- #
# config wiring
# ---------------------------------------------------------------------- #


def _start_locked() -> None:
    global _service, WATCH_ON
    if _service is None:
        _service = WatchService()
    _service.start()
    WATCH_ON = True


def _stop_locked() -> None:
    global WATCH_ON
    WATCH_ON = False
    if _service is not None:
        _service.stop()


def _on_watch_param(param: Any) -> None:
    with _state_lock:
        if bool(param.get()):
            _start_locked()
        else:
            _stop_locked()


from modin_tpu_torch.config import WatchEnabled as _WatchEnabled  # noqa: E402

_WatchEnabled.subscribe(_on_watch_param)
