"""Time-series rings: bounded history over the telemetry seams.

The port's counterpart of ``modin_tpu/observability/watch/timeseries.py``.
The meter registry and the spans are instantaneous: a counter's total, a
gauge's value, a cumulative histogram.  An operator asks about time: the
p99 over the last 60 seconds, the spill bytes a second now, whether the
storm count grew this minute.

- :class:`Ring`: one bounded deque of ``(t_monotonic, value)`` samples of
  one series, typed like the meters.  Counters read a windowed ``delta``/
  ``rate`` (total minus total, clamped at zero so a registry ``reset()``
  reads as a restart), histograms a windowed ``quantile`` (cumulative
  buckets subtracted between the window's edges, interpolated inside the
  bucket), gauges ``latest`` and a window's min/max.
- :class:`RingStore`: name -> Ring, capped by ``MetersMaxSeries`` like the
  meter registry, with a JSON-safe ``excerpt()`` for evidence bundles and
  ``/statusz``.
- :class:`Sampler`: the one background thread (a daemon named
  ``modin-tpu-torch-watch-sampler``).  Every ``WatchIntervalS`` it folds
  the meter registry's snapshot, the device and host ledger gauges, the
  admission gate's queue depth and running count and the launch ledger's
  build totals and storm signatures into the store, then hands the tick
  to the tripwires.  A crash emits ``watch.sampler.died`` and turns the
  service off: telemetry never takes a query down.

Every ring, tracker and tripwire made calls :func:`note_alloc`;
``watch.watch_alloc_count()`` reads the count, so a test can hold the
service to making nothing while it is off.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from modin_tpu_torch.concurrency import named_lock

#: samples a ring keeps: at the default 1 s interval about 8.5 minutes,
#: the slow SLO window with room.  Read when a ring is made.
RING_SAMPLES = 512

_alloc_count = 0


def note_alloc() -> None:
    """Count one watch object made (rings, trackers, tripwires, samplers)."""
    global _alloc_count
    _alloc_count += 1


def alloc_count() -> int:
    return _alloc_count


#: a histogram sample: (bucket upper bounds, cumulative counts per bound,
#: overall count, overall sum), the meter snapshot's shape as tuples
HistSample = Tuple[Tuple[float, ...], Tuple[int, ...], int, float]


class Ring:
    """The bounded time series of one metric.

    The sampler thread writes, the HTTP handlers and the tripwires read; the
    ring's lock makes a read's copy safe against an append."""

    __slots__ = ("name", "kind", "_samples", "_lock")

    def __init__(self, name: str, kind: str, maxlen: Optional[int] = None):
        note_alloc()
        self.name = name
        self.kind = kind
        self._samples: deque = deque(maxlen=maxlen or RING_SAMPLES)
        self._lock = named_lock("watch.ring")

    def __len__(self) -> int:
        return len(self._samples)

    def append(self, t: float, value: Any) -> None:
        with self._lock:
            self._samples.append((t, value))

    def samples(self) -> List[tuple]:
        with self._lock:
            return list(self._samples)

    def latest(self) -> Optional[tuple]:
        with self._lock:
            return self._samples[-1] if self._samples else None

    def between(self, t0: float, t1: float) -> List[tuple]:
        """Samples with ``t0 <= t <= t1``, oldest first."""
        return [s for s in self.samples() if t0 <= s[0] <= t1]

    # -- counters -------------------------------------------------------- #

    def delta(self, window_s: float, now: Optional[float] = None) -> Optional[float]:
        """The total's growth over the trailing window (>= 0), None with
        fewer than two samples in it.  A negative difference (the registry
        was reset inside the window) reads as the last sample's own total:
        what accumulated since the restart."""
        now = time.monotonic() if now is None else now
        window = self.between(now - window_s, now)
        if len(window) < 2:
            return None
        raw = float(window[-1][1]) - float(window[0][1])
        return raw if raw >= 0 else float(window[-1][1])

    def rate(self, window_s: float, now: Optional[float] = None) -> Optional[float]:
        """Growth a second over the trailing window, or None."""
        now = time.monotonic() if now is None else now
        window = self.between(now - window_s, now)
        if len(window) < 2:
            return None
        dt = window[-1][0] - window[0][0]
        if dt <= 0:
            return None
        delta = float(window[-1][1]) - float(window[0][1])
        if delta < 0:
            delta = float(window[-1][1])
        return delta / dt

    # -- gauges ---------------------------------------------------------- #

    def window_minmax(self, window_s: float, now: Optional[float] = None) -> Optional[Tuple[float, float]]:
        now = time.monotonic() if now is None else now
        window = self.between(now - window_s, now)
        if not window:
            return None
        values = [float(s[1]) for s in window]
        return (min(values), max(values))

    # -- histograms ------------------------------------------------------ #

    def hist_delta(self, t0: float, t1: float) -> Optional[Tuple[Tuple[float, ...], List[int], int]]:
        """``(bounds, per-bucket counts, total)`` of the observations between
        the window's first and last sample: the cumulative buckets of the
        first subtracted from the last's.  None for an empty window."""
        window = self.between(t0, t1)
        if not window:
            return None
        last = window[-1][1]
        first: Optional[HistSample] = window[0][1] if len(window) > 1 else None
        bounds, cums, count, _total_sum = last
        if first is not None and first[0] == bounds:
            base_cums, base_count = first[1], first[2]
        else:
            # the buckets changed (a reset and new bounds) or one sample:
            # the last sample's whole history
            base_cums, base_count = (0,) * len(cums), 0
        counts = [max(c - b, 0) for c, b in zip(cums, base_cums)]
        total = max(count - base_count, 0)
        per_bucket: List[int] = []
        prev = 0
        for c in counts:
            per_bucket.append(max(c - prev, 0))
            prev = c
        per_bucket.append(max(total - sum(per_bucket), 0))  # the overflow bucket
        return (bounds, per_bucket, total)

    def quantile(
        self, q: float, window_s: float, now: Optional[float] = None, end_offset_s: float = 0.0,
    ) -> Optional[float]:
        """The estimated q-quantile of the observations in the trailing
        window (``end_offset_s`` moves the window back: the tripwires'
        baseline is ``quantile(q, W, end_offset_s=W)``)."""
        now = time.monotonic() if now is None else now
        t1 = now - end_offset_s
        delta = self.hist_delta(t1 - window_s, t1)
        if delta is None:
            return None
        bounds, per_bucket, total = delta
        if total <= 0:
            return None
        target = q * total
        seen = 0.0
        for i, bucket_count in enumerate(per_bucket):
            if bucket_count == 0:
                continue
            if seen + bucket_count >= target:
                if i >= len(bounds):  # the overflow bucket
                    return float(bounds[-1]) if bounds else None
                lo = float(bounds[i - 1]) if i > 0 else 0.0
                hi = float(bounds[i])
                frac = (target - seen) / bucket_count
                return lo + (hi - lo) * frac
            seen += bucket_count
        return float(bounds[-1]) if bounds else None

    def window_count(self, window_s: float, now: Optional[float] = None) -> int:
        """Observations in the trailing window (0 if none)."""
        now = time.monotonic() if now is None else now
        delta = self.hist_delta(now - window_s, now)
        return delta[2] if delta is not None else 0


class RingStore:
    """Name -> :class:`Ring`, thread-safe, capped like the meter registry."""

    def __init__(self) -> None:
        note_alloc()
        self._lock = named_lock("watch.rings")
        self._rings: Dict[str, Ring] = {}
        self.dropped_series = 0

    def _max_series(self) -> int:
        try:
            from modin_tpu_torch.config import MetersMaxSeries

            return int(MetersMaxSeries.get())
        except ImportError:
            return 2048

    def observe(self, name: str, kind: str, value: Any, t: float) -> None:
        with self._lock:
            ring = self._rings.get(name)
            if ring is None:
                if len(self._rings) >= self._max_series():
                    self.dropped_series += 1
                    return
                ring = self._rings[name] = Ring(name, kind)
            ring.append(t, value)

    def observe_meter(self, name: str, series: dict, t: float) -> None:
        """Fold one series of the meter registry's snapshot into its ring."""
        kind = series.get("kind", "counter")
        if kind == "histogram":
            bounds = tuple(float(b) for b, _c in series.get("buckets", []))
            cums = tuple(int(c) for _b, c in series.get("buckets", []))
            value: Any = (bounds, cums, int(series.get("count", 0)), float(series.get("sum", 0.0)))
        elif kind == "gauge":
            value = series.get("value", 0.0)
        else:
            value = series.get("total", 0.0)
        self.observe(name, kind, value, t)

    def get(self, name: str) -> Optional[Ring]:
        with self._lock:
            return self._rings.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._rings)

    def __len__(self) -> int:
        with self._lock:
            return len(self._rings)

    def rate(self, name: str, window_s: float, now: Optional[float] = None) -> Optional[float]:
        ring = self.get(name)
        return ring.rate(window_s, now) if ring is not None else None

    def delta(self, name: str, window_s: float, now: Optional[float] = None) -> Optional[float]:
        ring = self.get(name)
        return ring.delta(window_s, now) if ring is not None else None

    def quantile(
        self, name: str, q: float, window_s: float, now: Optional[float] = None, end_offset_s: float = 0.0,
    ) -> Optional[float]:
        ring = self.get(name)
        return None if ring is None else ring.quantile(q, window_s, now, end_offset_s)

    def excerpt(self, last_n: int = 60) -> dict:
        """The JSON-safe tail of every ring (evidence bundles, ``/statusz``)."""
        with self._lock:
            rings = list(self._rings.items())
        out: Dict[str, dict] = {}
        for name, ring in rings:
            tail = ring.samples()[-last_n:]
            out[name] = {"kind": ring.kind, "samples": [[round(t, 3), _json_safe_value(v)] for t, v in tail]}
        return out

    def reset(self) -> None:
        with self._lock:
            self._rings.clear()
            self.dropped_series = 0


def _json_safe_value(value: Any) -> Any:
    if isinstance(value, tuple):  # a histogram sample
        bounds, cums, count, total_sum = value
        return {"buckets": [[b, c] for b, c in zip(bounds, cums)], "count": count, "sum": total_sum}
    return value


# ---------------------------------------------------------------------- #
# the sampler thread
# ---------------------------------------------------------------------- #


#: rings the sampler reads live each tick (step 2 below); the registry's
#: gauges of the same names are set only at spill passes, and their stale
#: values must not interleave into the same rings
_DIRECT_SAMPLED = frozenset({"memory.device.resident_bytes", "memory.host.cache_bytes"})


class Sampler:
    """The sampling loop, one daemon thread.

    ``on_tick`` runs after every sample pass (the tripwires); ``on_died``
    runs once if the loop crashes, after ``watch.sampler.died`` went out:
    the service turns itself off there without joining the dying thread.
    """

    THREAD_NAME = "modin-tpu-torch-watch-sampler"

    def __init__(
        self,
        store: RingStore,
        on_tick: Optional[Callable[[float], None]] = None,
        on_died: Optional[Callable[[BaseException], None]] = None,
    ) -> None:
        note_alloc()
        self._store = store
        self._on_tick = on_tick
        self._on_died = on_died
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._obs_span_stack: Any = None
        self._obs_scopes: Any = None
        self.ticks = 0
        self.last_tick_t: Optional[float] = None
        self.died = False
        self.error: Optional[str] = None

    def start(self) -> None:
        """Start the loop (a live thread is left running)."""
        if self._thread is not None and self._thread.is_alive():
            return
        # a fresh event a run: a run whose stop() join timed out keeps its
        # own (set) event and exits when its stalled tick returns, instead
        # of running on beside this one
        self._stop = threading.Event()
        self.died = False
        self.error = None
        self.ticks = 0
        self.last_tick_t = None
        from modin_tpu_torch.observability import meters as _meters
        from modin_tpu_torch.observability import spans as _spans

        # the sampler's emissions bill whoever started the service
        self._obs_span_stack = _spans.snapshot_stack()
        self._obs_scopes = _meters.snapshot_scopes()
        self._thread = threading.Thread(target=self._run, name=self.THREAD_NAME, daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        """Stop and join the loop (never from the sampler thread itself)."""
        self._stop.set()
        thread = self._thread
        if thread is not None and thread.is_alive() and thread is not threading.current_thread():
            thread.join(timeout)
        self._thread = None

    def is_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _interval_s(self) -> float:
        from modin_tpu_torch.config import WatchIntervalS

        return max(float(WatchIntervalS.get()), 0.001)

    def _run(self) -> None:
        from modin_tpu_torch.observability import meters as _meters
        from modin_tpu_torch.observability import spans as _spans

        _spans.seed_thread(self._obs_span_stack)
        _meters.seed_thread_scopes(self._obs_scopes)
        stop = self._stop  # this run's event (see start)
        try:
            while not stop.is_set():
                self.sample_once()
                if self._on_tick is not None:
                    self._on_tick(time.monotonic())
                if stop.wait(self._interval_s()):
                    break
        except BaseException as err:  # noqa: BLE001 - telemetry never takes a query down
            if self._thread is not threading.current_thread():
                return  # a superseded run: the restarted service is healthy
            self.died = True
            self.error = f"{type(err).__name__}: {err}"
            try:
                from modin_tpu_torch.logging.metrics import emit_metric

                emit_metric("watch.sampler.died", 1)
            except Exception:
                pass
            if self._on_died is not None:
                try:
                    self._on_died(err)
                except Exception:
                    pass
        finally:
            _meters.seed_thread_scopes(None)
            _spans.seed_thread(None)

    def sample_once(self, now: Optional[float] = None) -> None:
        """One sampling pass over every seam (the tests and the smoke call
        it directly for ticks at chosen times)."""
        now = time.monotonic() if now is None else now
        store = self._store

        # 1. the meter registry (the service holds an acquire, so series
        #    exist with MODIN_TPU_TORCH_METERS off), less the names step 2
        #    samples live
        from modin_tpu_torch.observability import meters as _meters

        for name, series in _meters.snapshot().get("series", {}).items():
            if name in _DIRECT_SAMPLED:
                continue
            store.observe_meter(name, series, now)

        # 2. the device and host ledgers' gauges
        from modin_tpu_torch.observability import spans as _spans

        device_bytes, host_bytes = _spans._ledger_bytes()
        store.observe("memory.device.resident_bytes", "gauge", device_bytes, now)
        store.observe("memory.host.cache_bytes", "gauge", host_bytes, now)

        # 3. the admission gate's pressure, only where serving is imported
        #    (the sampler never starts an import)
        gate_mod = sys.modules.get("modin_tpu_torch.serving.gate")
        if gate_mod is not None:
            try:
                queued, running = gate_mod.counter_sample()
            except Exception:
                queued, running = 0, 0
            store.observe("serving.gate.queued", "gauge", queued, now)
            store.observe("serving.gate.running", "gauge", running, now)

        # 4. the launch ledger's builds and lowerings, and its storm
        #    signatures (one walk of the signature table a tick)
        from modin_tpu_torch.observability.compile_ledger import get_compile_ledger

        ledger = get_compile_ledger()
        compiles, compile_s = ledger.totals()
        store.observe("compile.total", "counter", compiles, now)
        store.observe("compile.wall_s", "counter", compile_s, now)
        store.observe("compile.storm_signatures", "gauge", len(ledger.recompile_storms()), now)

        self.ticks += 1
        self.last_tick_t = now
