"""The port's live telemetry service against the JAX package's.

The units of ``observability/watch/`` run through both packages on the same
seeded inputs: ring deltas, rates, window quantiles and the reset clamp;
``parse_slo_ms`` and the SLO burn verdicts; each tripwire's verdict string
on the same ring contents.  The port's own legs run here on the CPU: the
service off makes no thread and nothing else; the sampler fills the rings
the tripwires read (``spill_thrash``'s four series emitted by the port's
real seams); the exporter's endpoints; the gate's and the feeds' hooks; the
evidence bundle's shape and its rate limit; a crashed sampler turning the
service off.

Steadiness: the thread checks count only the port's watch threads (named
``modin-tpu-torch-watch-*``), and the fixture resets the service, the
meters, the flight recorder, the gate, the tenants and the breakers.
"""

import glob
import json
import os
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pandas
import pytest

from modin_tpu import config as jcfg
from modin_tpu.observability.watch import slo as j_slo
from modin_tpu.observability.watch import timeseries as j_ts
from modin_tpu.observability.watch import tripwires as j_tw

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch import config as tcfg
from modin_tpu_torch import serving as t_serving
from modin_tpu_torch.core.execution import resilience as t_res
from modin_tpu_torch.logging import add_metric_handler, clear_metric_handler
from modin_tpu_torch.logging.metrics import emit_metric
from modin_tpu_torch.observability import flight_recorder, meters, watch
from modin_tpu_torch.observability.exposition import parse_prometheus
from modin_tpu_torch.observability.watch import slo as t_slo
from modin_tpu_torch.observability.watch import timeseries as t_ts
from modin_tpu_torch.observability.watch import tripwires as t_tw
from modin_tpu_torch.serving import tenants as t_tenants
from modin_tpu_torch.serving.gate import gate as t_gate

JAX = types.SimpleNamespace(name="jax", ts=j_ts, slo=j_slo, tw=j_tw, cfg=jcfg)
PORT = types.SimpleNamespace(name="port", ts=t_ts, slo=t_slo, tw=t_tw, cfg=tcfg)
PACKAGES = (JAX, PORT)

_KNOBS = ("WatchEnabled", "WatchIntervalS", "WatchPort", "WatchSloMs", "MetersEnabled", "ServingEnabled",
          "TraceDir", "TraceEnabled", "ResilienceBackoffS")
_PORT_ONLY = ("IngestEnabled", "IngestFoldEvery", "IngestFoldLagMs", "DeviceMemoryBudget")


def _reset_port_service():
    watch.reset_for_tests()
    meters.reset()
    flight_recorder.reset_for_tests()
    t_res.reset_breakers()
    t_res.reset_counts()
    t_gate.reset_for_tests()
    t_tenants.registry.reset()


@pytest.fixture(autouse=True)
def _clean_state():
    modin_tpu_torch.set_device("cpu")
    saved = [(getattr(P.cfg, k), getattr(P.cfg, k).get()) for P in PACKAGES for k in _KNOBS]
    saved += [(getattr(tcfg, k), getattr(tcfg, k).get()) for k in _PORT_ONLY]
    _reset_port_service()
    yield
    for p, v in saved:
        p.put(v)
    _reset_port_service()


@pytest.fixture
def metric_names():
    seen = []

    def handler(name, value):
        seen.append(name)

    add_metric_handler(handler)
    yield seen
    clear_metric_handler(handler)


def _watch_threads():
    return [t.name for t in threading.enumerate() if t.name.startswith("modin-tpu-torch-watch")]


def _get(port, path, timeout=5.0):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout).read().decode()


def _quiet_service(tmp_path):
    """The port's service on, with a long interval (the tests tick it) and no
    exporter."""
    tcfg.TraceDir.put(str(tmp_path))
    tcfg.WatchIntervalS.put(60.0)
    tcfg.WatchPort.put(-1)
    tcfg.WatchEnabled.put(True)
    return watch.get_service()


# ---------------------------------------------------------------------- #
# the rings, both packages on the same samples
# ---------------------------------------------------------------------- #


def _counter_series(seed):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.5, 3.0, 24))
    v = np.cumsum(rng.integers(0, 50, 24)).astype(float)
    if seed % 2:
        v[15:] = v[15:] - v[14] + rng.integers(0, 5)  # a registry reset
    return list(zip(t.tolist(), v.tolist()))


def _ring_reads(P, series, kind):
    ring = P.ts.Ring("r", kind)
    for t, v in series:
        ring.append(t, v)
    last = series[-1][0]
    out = []
    for window in (1.0, 5.0, 12.0, 30.0, 100.0):
        for now in (last, last - 7.0, last + 3.0):
            if kind == "counter":
                out.append((ring.delta(window, now=now), ring.rate(window, now=now)))
            else:
                out.append(ring.window_minmax(window, now=now))
    return out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kind", ["counter", "gauge"])
def test_ring_reads_match_the_jax_package(seed, kind):
    series = _counter_series(seed)
    assert _ring_reads(PORT, series, kind) == _ring_reads(JAX, series, kind)


def _hist_series(seed):
    rng = np.random.default_rng(100 + seed)
    bounds = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0)
    cums = np.zeros(len(bounds), dtype=np.int64)
    count, total = 0, 0.0
    out = []
    t = 0.0
    for step in range(20):
        t += float(rng.uniform(1.0, 8.0))
        obs = rng.lognormal(-4.0 + 2.0 * (step > 12), 1.0, int(rng.integers(0, 30)))
        for x in obs:
            cums += (np.asarray(bounds) >= x).astype(np.int64)
        count += len(obs)
        total += float(obs.sum())
        sample = (bounds, tuple(int(c) for c in cums), count, total)
        if seed == 3 and step == 10:
            sample = (bounds[:-1], tuple(int(c) for c in cums[:-1]), count, total)  # a re-bucket
        out.append((t, sample))
    return out


def _hist_reads(P, series):
    ring = P.ts.Ring("h", "histogram")
    for t, v in series:
        ring.append(t, v)
    last = series[-1][0]
    out = []
    for window in (5.0, 20.0, 60.0):
        for offset in (0.0, 10.0, 30.0):
            for q in (0.5, 0.9, 0.99):
                out.append(ring.quantile(q, window, now=last, end_offset_s=offset))
        out.append(ring.window_count(window, now=last))
        out.append(ring.hist_delta(last - window, last))
    return out


@pytest.mark.parametrize("seed", range(5))
def test_histogram_quantiles_match_the_jax_package(seed):
    series = _hist_series(seed)
    assert _hist_reads(PORT, series) == _hist_reads(JAX, series)


@pytest.mark.parametrize("P", PACKAGES, ids=lambda P: P.name)
def test_counter_reset_clamp_and_single_sample_history(P):
    ring = P.ts.Ring("c", "counter")
    for t, v in [(0.0, 100.0), (10.0, 150.0), (20.0, 180.0)]:
        ring.append(t, v)
    assert ring.delta(25.0, now=20.0) == pytest.approx(80.0)
    assert ring.rate(25.0, now=20.0) == pytest.approx(4.0)
    ring.append(30.0, 5.0)  # a registry reset reads as a restart
    assert ring.delta(25.0, now=30.0) == pytest.approx(5.0)
    assert ring.rate(40.0, now=30.0) >= 0.0
    hist = P.ts.Ring("h", "histogram")
    hist.append(5.0, ((1.0,), (7,), 9, 9.0))
    assert hist.hist_delta(0.0, 10.0) == ((1.0,), [7, 2], 9)


def test_ring_store_excerpt_matches_and_is_json_safe():
    excerpts = []
    for P in PACKAGES:
        store = P.ts.RingStore()
        store.observe("c", "counter", 3, 1.0)
        store.observe("h", "histogram", ((1.0,), (2,), 2, 1.5), 1.0)
        store.observe_meter("m", {"kind": "histogram", "buckets": [[0.5, 1], [1.0, 3]], "count": 4, "sum": 2.0},
                            2.0)
        store.observe_meter("g", {"kind": "gauge", "value": 7.0}, 2.0)
        excerpts.append(json.loads(json.dumps(store.excerpt())))
    assert excerpts[0] == excerpts[1]
    assert excerpts[1]["h"]["samples"][0][1]["count"] == 2


def test_ring_store_caps_its_series(monkeypatch):
    monkeypatch.setattr(t_ts.RingStore, "_max_series", lambda self: 3)
    store = t_ts.RingStore()
    for i in range(5):
        store.observe(f"s{i}", "gauge", i, 1.0)
    assert len(store) == 3 and store.dropped_series == 2


# ---------------------------------------------------------------------- #
# SLO burn, both packages
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("spec", ["250", "default=100,alice=20", "junk,=5,x=,neg=-2,ok=10", "", " a = 3 , b=0 ",
                                  "default=1.5e2,bob=7"])
def test_parse_slo_ms_matches_the_jax_package(spec):
    assert t_slo.parse_slo_ms(spec) == j_slo.parse_slo_ms(spec)


def _slo_observed(P, seed):
    P.cfg.WatchSloMs.put("default=50,alice=20,view:f/v=100")
    tracker = P.slo.SloTracker()
    rng = np.random.default_rng(seed)
    now = 10_000.0
    for tenant, scale in (("alice", 0.03), ("bob", 0.01), ("carol", 0.2), ("view:f/v", 0.05), ("sparse", 9.9)):
        n = 2 if tenant == "sparse" else int(rng.integers(5, 60))
        for _ in range(n):
            age = float(rng.uniform(0, 400))
            tracker.observe(tenant, float(rng.exponential(scale)), now=now - age)
    return tracker.health(now=now), tracker.breaching(now=now), tracker.latency_stats(now=now)


@pytest.mark.parametrize("seed", range(6))
def test_slo_burn_verdicts_match_the_jax_package(seed):
    assert _slo_observed(PORT, seed) == _slo_observed(JAX, seed)


@pytest.mark.parametrize("P", PACKAGES, ids=lambda P: P.name)
def test_slo_fast_window_recovery_and_min_samples(P):
    P.cfg.WatchSloMs.put("default=50")
    tracker = P.slo.SloTracker()
    now = time.monotonic()
    for _ in range(20):
        tracker.observe("t", 1.0, now=now - P.slo.FAST_WINDOW_S - 5)
    for _ in range(20):
        tracker.observe("t", 0.001, now=now)
    tracker.observe("sparse", 9.9, now=now)
    health = tracker.health(now=now)
    assert health["t"]["slow_burn"] > 1.0 and health["t"]["fast_burn"] == 0.0
    assert not health["t"]["breaching"] and not health["sparse"]["breaching"]


def test_slo_tenant_table_evicts_the_least_recent(monkeypatch):
    monkeypatch.setattr(t_slo, "_MAX_TENANTS", 8)
    tracker = t_slo.SloTracker()
    for i in range(20):
        tracker.observe(f"tenant{i}", 0.01)
    assert len(tracker._observations) == 8 and tracker.evicted_tenants == 12
    assert "tenant19" in tracker._observations and "tenant0" not in tracker._observations


# ---------------------------------------------------------------------- #
# the tripwires' verdicts, both packages on the same rings
# ---------------------------------------------------------------------- #


def _service(P):
    return types.SimpleNamespace(rings=P.ts.RingStore(), slo=P.slo.SloTracker())


def _fill(P, case, now):
    service = _service(P)
    rings = service.rings
    win = P.tw.WINDOW_S
    if case in ("latency_shift", "latency_floor"):
        bounds = (0.01, 0.1, 1.0) if case == "latency_shift" else (1e-6, 1e-5, 1e-4)
        rings.observe("serving.query_wall_s", "histogram", (bounds, (0, 0, 0), 0, 0.0), now - 2 * win)
        rings.observe("serving.query_wall_s", "histogram", (bounds, (10, 10, 10), 10, 0.05), now - win)
        rings.observe("serving.query_wall_s", "histogram", (bounds, (10, 10, 20), 20, 5.0), now)
    elif case == "recompile_storm":
        rings.observe("compile.storm_signatures", "gauge", 0, now - 30)
        rings.observe("compile.storm_signatures", "gauge", 2, now)
    elif case in ("spill_thrash", "spill_rising"):
        for t, v in [(now - win, 0), (now, 8)]:
            rings.observe("memory.device.spill", "counter", v, t)
        hits = [0, 40, 40, 41] if case == "spill_thrash" else [0, 2, 2, 50]
        for name in ("sortcache.hit", "view.hit", "fusion.cache.hit"):
            for t, v in zip([now - 2 * win, now - win - 1, now - win + 1, now], hits):
                rings.observe(name, "counter", v, t)
    elif case == "shed_spike":
        for t, v in [(now - 30, 0), (now, 10)]:
            rings.observe("serving.shed", "counter", v, t)
    elif case == "slo_burn":
        P.cfg.WatchSloMs.put("default=10")
        for _ in range(10):
            service.slo.observe("alice", 5.0, now=now)
            service.slo.observe("bob", 0.001, now=now)
    return service


_RULES = {
    "latency_shift": "_latency_shift", "latency_floor": "_latency_shift", "recompile_storm": "_recompile_storm",
    "spill_thrash": "_spill_thrash", "spill_rising": "_spill_thrash", "shed_spike": "_shed_spike",
    "slo_burn": "_slo_burn",
}


@pytest.mark.parametrize("case", sorted(_RULES))
def test_tripwire_verdicts_match_the_jax_package(case):
    now = 50_000.0
    verdicts = [getattr(P.tw, _RULES[case])(_fill(P, case, now), now) for P in PACKAGES]
    assert verdicts[0] == verdicts[1]
    tripped = case not in ("latency_floor", "spill_rising")
    assert (verdicts[1] is not None) == tripped


@pytest.mark.parametrize("lag_ms", [200.0, 1500.0])
def test_fold_lag_verdict_matches_the_jax_package(monkeypatch, lag_ms):
    import modin_tpu.ingest as j_ingest
    import modin_tpu_torch.ingest as t_ingest

    verdicts = []
    for P, mod in ((JAX, j_ingest), (PORT, t_ingest)):
        monkeypatch.setattr(mod, "INGEST_ON", True)
        monkeypatch.setattr(mod, "max_fold_lag_ms", lambda: lag_ms)
        P.cfg.IngestFoldLagMs.put(1000.0)
        verdicts.append(P.tw._fold_lag(_service(P), 0.0))
    assert (verdicts[1] is not None) == (lag_ms > 1000.0)
    if verdicts[1] is not None:
        # the one difference is the setting's name
        assert verdicts[1] == verdicts[0].replace("MODIN_TPU_INGEST", "MODIN_TPU_TORCH_INGEST")


def test_default_rules_match_the_jax_package():
    def rules(P):
        return [(r.name, r.description.replace("compile-ledger", "ledger").replace("launch-ledger", "ledger")
                 .replace("graftfeed ", "")) for r in P.tw.default_rules()]

    assert rules(PORT) == rules(JAX)


# ---------------------------------------------------------------------- #
# the port's service
# ---------------------------------------------------------------------- #


def test_off_makes_no_thread_and_nothing_else():
    before = watch.watch_alloc_count()
    t_serving.submit(lambda: 1)
    watch.observe_query("alice", 0.1)
    watch.observe_view_read("f/v", 0.1)
    assert not watch.WATCH_ON and watch.get_service() is None
    assert watch.watch_alloc_count() == before
    assert _watch_threads() == []
    assert watch.watch_snapshot() == {"enabled": False, "service": None}
    assert watch.slo_health() == {} and watch.recent_trips() == [] and watch.httpd_port() is None


def test_start_stop_is_idempotent_and_leaves_no_thread(tmp_path):
    tcfg.TraceDir.put(str(tmp_path))
    tcfg.WatchIntervalS.put(0.05)
    tcfg.WatchPort.put(0)
    tcfg.WatchEnabled.put(True)
    tcfg.WatchEnabled.put(True)
    assert watch.WATCH_ON and len(_watch_threads()) == 2
    port = watch.httpd_port()
    assert port and port > 0
    tcfg.WatchEnabled.put(False)
    assert not watch.WATCH_ON and _watch_threads() == [] and watch.httpd_port() is None
    assert not meters.METERS_ON  # the registry acquire went back


def test_watch_alone_turns_on_registry_aggregation(tmp_path):
    tcfg.MetersEnabled.put(False)
    _quiet_service(tmp_path)
    assert meters.METERS_ON
    emit_metric("engine.dispatch", 1)
    assert meters.snapshot()["series"]["engine.dispatch"]["total"] == 1


def _spill_once():
    """A real spill through the device ledger: two frames under a budget
    that holds one."""
    n = 50_000
    a = tpd.DataFrame({"v": np.arange(n, dtype=np.float64)})
    a._query_compiler._modin_frame
    tcfg.DeviceMemoryBudget.put(int(n * 8 * 1.5))
    try:
        b = tpd.DataFrame({"w": np.arange(n, dtype=np.float64)})
        b._query_compiler._modin_frame
        float(a["v"].sum())
    finally:
        tcfg.DeviceMemoryBudget.put(None)


def test_sampler_fills_the_rings_spill_thrash_reads(tmp_path):
    service = _quiet_service(tmp_path)
    rng = np.random.default_rng(4)
    df = tpd.DataFrame({"x": rng.normal(size=4096), "k": rng.integers(0, 7, 4096)})
    for _ in range(2):
        float(df["x"].sum())  # view.hit on the second
        float((df["x"] * 2 + 1).sum())  # fusion.cache.hit on the second
        float(df["x"].median())
    float(df["x"].quantile(0.3))  # the median's sorted representation: sortcache.hit
    _spill_once()
    service.sampler.sample_once()
    for name in ("memory.device.spill", "fusion.cache.hit", "sortcache.hit", "view.hit"):
        ring = service.rings.get(name)
        assert ring is not None and len(ring) >= 1, name
        assert float(ring.latest()[1]) > 0, name
    for name in ("memory.device.resident_bytes", "memory.host.cache_bytes", "compile.total",
                 "compile.storm_signatures"):
        assert service.rings.get(name) is not None


def test_sampler_ticks_and_gate_gauges(tmp_path):
    tcfg.TraceDir.put(str(tmp_path))
    tcfg.WatchIntervalS.put(0.02)
    tcfg.WatchPort.put(-1)
    tcfg.WatchEnabled.put(True)
    service = watch.get_service()
    deadline = time.monotonic() + 10
    while service.sampler.ticks < 3 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert service.sampler.ticks >= 3
    assert service.rings.get("serving.gate.queued") is not None
    snap = watch.watch_snapshot()
    assert snap["sampler"]["alive"] and snap["ring_series"] >= 4


def test_crashed_sampler_turns_the_service_off(tmp_path, metric_names, monkeypatch):
    service = _quiet_service(tmp_path)
    tcfg.WatchEnabled.put(False)

    def boom(now=None):
        raise RuntimeError("sampler seam broke")

    monkeypatch.setattr(service.sampler, "sample_once", boom)
    tcfg.WatchIntervalS.put(0.01)
    tcfg.WatchEnabled.put(True)
    deadline = time.monotonic() + 10
    while watch.WATCH_ON and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not watch.WATCH_ON and service.sampler.died
    assert "modin_tpu_torch.watch.sampler.died" in metric_names
    t_serving.submit(lambda: 1)  # queries go on


def test_tick_trips_emit_and_write_one_bundle(tmp_path, metric_names, monkeypatch):
    service = _quiet_service(tmp_path)
    tcfg.WatchSloMs.put("default=10")
    now = time.monotonic()
    for _ in range(10):
        service.slo.observe("alice", 5.0, now=now)
    service.tripwires.on_tick(now)
    bundles = glob.glob(str(tmp_path / "watchtrip_*.json"))
    assert len(bundles) == 1
    bundle = json.loads(open(bundles[0]).read())
    assert bundle["rule"] == "slo_burn" and set(bundle) >= {"trace", "metrics", "rings", "slo", "detail"}
    assert bundle["slo"]["alice"]["breaching"]
    assert "modin_tpu_torch.watch.trip.slo_burn" in metric_names
    assert "modin_tpu_torch.watch.evidence" in metric_names
    # inside the claim window nothing new is written, cooldown or not
    monkeypatch.setattr(t_tw, "RULE_COOLDOWN_S", 0.0)
    service.tripwires.on_tick(now + 1)
    assert len(glob.glob(str(tmp_path / "watchtrip_*.json"))) == 1
    assert [t["rule"] for t in watch.recent_trips()].count("slo_burn") == 2


def test_failed_bundle_releases_its_claim_and_broken_rule_is_isolated(tmp_path):
    service = _quiet_service(tmp_path)
    blocker = tmp_path / "blocked"
    blocker.write_text("a file where the trace dir should be")
    tcfg.TraceDir.put(str(blocker))
    assert t_tw.capture_evidence("unit", "detail", service) is None
    tcfg.TraceDir.put(str(tmp_path))
    path = t_tw.capture_evidence("unit", "detail", service)
    assert path is not None and os.path.exists(path)

    def explode(_service, _now):
        raise RuntimeError("broken rule")

    service.tripwires.rules.append(t_tw.Tripwire("broken", "unit", explode))
    service.tripwires.on_tick(time.monotonic())
    assert all(t["rule"] != "broken" for t in service.tripwires.snapshot())


def test_rule_cooldown_spaces_its_trips(tmp_path, monkeypatch):
    service = _quiet_service(tmp_path)
    monkeypatch.setattr(flight_recorder, "MIN_DUMP_INTERVAL_S", 0.0)
    now = time.monotonic()
    for t, v in [(now - 30, 0), (now, 10)]:
        service.rings.observe("serving.shed", "counter", v, t)
    service.tripwires.on_tick(now)
    service.tripwires.on_tick(now + 1)
    assert [t["rule"] for t in service.tripwires.snapshot()].count("shed_spike") == 1


# ---------------------------------------------------------------------- #
# the exporter
# ---------------------------------------------------------------------- #


def test_exporter_endpoints_serve_and_parse(tmp_path, metric_names):
    tcfg.TraceDir.put(str(tmp_path))
    tcfg.WatchIntervalS.put(0.05)
    tcfg.WatchPort.put(0)
    tcfg.WatchEnabled.put(True)
    emit_metric("engine.dispatch", 1)
    emit_metric("io.read.bytes", 4096)
    port = watch.httpd_port()
    parsed = parse_prometheus(_get(port, "/metrics"))
    assert "modin_tpu_torch_engine_dispatch" in parsed
    statusz = _get(port, "/statusz")
    for header in ("service", "substrate", "windowed rates", "admission gate", "tenants", "fleet",
                   "recent tripwires"):
        assert f"== {header} ==" in statusz
    with meters.query_stats("live-probe"):
        dbg = json.loads(_get(port, "/debug/queries"))
    assert dbg["open_scopes"] == 1 and dbg["queries"][0]["label"] == "live-probe"
    assert dbg["queries"][0]["open"] is True
    assert "/metrics" in _get(port, "/")
    with pytest.raises(urllib.error.HTTPError):
        _get(port, "/nope")
    assert "modin_tpu_torch.watch.scrape" in metric_names


def test_exporter_port_settings():
    tcfg.WatchPort.put(-1)
    tcfg.WatchIntervalS.put(1.0)
    tcfg.WatchEnabled.put(True)
    assert watch.WATCH_ON and watch.httpd_port() is None
    assert not any("httpd" in n for n in _watch_threads())
    from modin_tpu_torch.observability.watch.httpd import Exporter

    exporter = Exporter(object())
    assert exporter.start(70000) is False and exporter.port is None
    for bad in (-2, 70000):
        with pytest.raises(ValueError):
            tcfg.WatchPort.put(bad)
    with pytest.raises(ValueError):
        tcfg.WatchIntervalS.put(0)


# ---------------------------------------------------------------------- #
# the hooks: the gate and the feeds
# ---------------------------------------------------------------------- #


def test_gate_feeds_the_slo_and_its_snapshot_shows_it(tmp_path):
    _quiet_service(tmp_path)
    tcfg.WatchSloMs.put("default=100000")
    tcfg.ServingEnabled.put(True)
    tcfg.ResilienceBackoffS.put(0.0)
    df = tpd.DataFrame({"a": np.arange(64.0)})
    for _ in range(3):
        assert t_serving.submit(lambda: float(df["a"].sum()), tenant="alice") == float(np.arange(64.0).sum())
    health = watch.get_service().slo.health()
    assert health["alice"]["fast_samples"] >= 3 and not health["alice"]["breaching"]
    snap = t_serving.serving_snapshot()
    assert "alice" in snap["slo"] and snap["shed"] == 0
    assert "fleet" not in snap


def test_snapshot_has_no_slo_while_watch_is_off():
    tcfg.ServingEnabled.put(True)
    assert "slo" not in t_serving.serving_snapshot()


def test_feed_reads_feed_the_view_slo_and_fold_lag_trips(tmp_path, monkeypatch):
    from modin_tpu_torch import ingest

    service = _quiet_service(tmp_path)
    monkeypatch.setattr(flight_recorder, "MIN_DUMP_INTERVAL_S", 0.0)
    tcfg.WatchSloMs.put("default=100000")
    tcfg.IngestEnabled.put(True)
    tcfg.IngestFoldEvery.put(1000)  # batches stay pending: the lag grows
    tcfg.IngestFoldLagMs.put(5.0)
    try:
        feed = ingest.create_feed("wfeed", {"k": "int64", "x": "float64"})
        feed.register_view("total", {"kind": "scalar", "column": "x", "agg": "sum"})
        feed.append(pandas.DataFrame({"k": [1, 2], "x": [1.0, 2.0]}))
        time.sleep(0.03)
        assert ingest.max_fold_lag_ms() > 5.0
        service.tripwires.on_tick(time.monotonic())
        trips = [t for t in service.tripwires.snapshot() if t["rule"] == "fold_lag"]
        assert trips and "fold lag" in trips[0]["detail"]
        read = feed.read("total", fresh_within_ms=0.0)
        assert read.value == 3.0
        assert "view:wfeed/total" in service.slo.latency_stats()
    finally:
        ingest.reset()


def test_watch_metric_families_are_registered():
    from modin_tpu_torch.logging.metrics import METRICS

    patterns = {e[0] for e in METRICS}
    assert {"watch.sampler.died", "watch.trip.*", "watch.evidence", "watch.scrape", "view.export",
            "view.ingest"} <= patterns
