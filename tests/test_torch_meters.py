"""Meters of the torch port against the JAX package's ``meters.py`` and
``exposition.py``, and per-query accounting.

The same values go into both packages' histograms (the same buckets) and
registries: the snapshots, p50/p95/p99 included, are equal, and so are
``to_json`` and ``meter_rollup`` over one snapshot; ``to_prometheus`` and
``parse_prometheus`` are equal once the JAX package's ``modin_tpu_`` prefix
reads ``modin_tpu_torch_``, each HELP line where the family's description is
the same in both registries.  Under the same injected faults in both
packages, the ``resilience.*`` families of the meter snapshots are equal.
``QueryStats`` has the JAX package's fields; a scope counts the port's
dispatches, lowerings and cache hits, and is thread-isolated.
"""

import fnmatch
import threading

import numpy as np
import pandas
import pytest

import modin_tpu.pandas as mpd
from modin_tpu import config as jcfg
from modin_tpu.core.execution import resilience as jres
from modin_tpu.logging import metrics as jmetrics
from modin_tpu.observability import exposition as jexpo
from modin_tpu.observability import meters as jmeters
from modin_tpu.testing import inject_faults as j_inject

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch import config as tcfg
from modin_tpu_torch.core.execution import resilience as tres
from modin_tpu_torch.logging import emit_metric
from modin_tpu_torch.logging import metrics as tmetrics
from modin_tpu_torch.observability import exposition as texpo
from modin_tpu_torch.observability import meters as tmeters
from modin_tpu_torch.ops import lazy
from modin_tpu_torch.testing import inject_faults as t_inject

RTOL = 1e-12


@pytest.fixture(autouse=True)
def _clean():
    modin_tpu_torch.set_device("cpu")
    jmeters.reset()
    tmeters.reset()
    yield
    jmeters.reset()
    tmeters.reset()


@pytest.fixture(autouse=True, scope="module")
def _join_jax_watchdog_threads():
    yield
    for t in threading.enumerate():
        if t.name.startswith("modin-tpu-watchdog"):
            t.join(timeout=5)


# ====================================================================== #
# histograms and snapshots, against the JAX package
# ====================================================================== #

#: a value range per histogram family, inside and past its buckets
_HIST_SCALES = {"pandas-api.*": 0.05, "io.read.bytes": 1 << 20, "plan.optimize.passes": 4, "plan.lower.nodes": 40}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("family", sorted(_HIST_SCALES))
def test_histogram_buckets_and_percentiles_match_the_jax_package(family, seed):
    assert tmeters.HISTOGRAM_BUCKETS[family] == jmeters.HISTOGRAM_BUCKETS[family]
    rng = np.random.default_rng(seed)
    values = rng.lognormal(0.0, 1.5, 257) * _HIST_SCALES[family]
    ht, hj = tmeters.Histogram(tmeters.HISTOGRAM_BUCKETS[family]), jmeters.Histogram(jmeters.HISTOGRAM_BUCKETS[family])
    for v in values:
        ht.add(float(v))
        hj.add(float(v))
    got, want = ht.snapshot(), hj.snapshot()
    assert got == want
    assert got["p50"] <= got["p95"] <= got["p99"]


def _events(seed: int) -> list:
    """(name, value) emissions of families both registries declare with
    the same kind."""
    rng = np.random.default_rng(seed)
    names = [
        "resilience.engine.deploy.oom", "resilience.engine.materialize.transient",
        "resilience.breaker.reduce.open", "resilience.fallback.groupby.device_lost",
        "engine.dispatch", "engine.cost.bytes", "engine.cost.flops", "memory.device.spill",
        "memory.device.resident_bytes", "view.hit", "fusion.cache.hit", "plan.optimize.passes",
        "plan.lower.nodes", "pandas-api.dataframe_sum", "io.read.bytes", "recovery.reseat.host",
    ]
    out = []
    for _ in range(200):
        name = names[int(rng.integers(0, len(names)))]
        value = float(rng.integers(1, 5)) if "passes" in name or "nodes" in name else float(rng.random() * 1e6)
        out.append((name, value))
    return out


def _snapshots(seed: int):
    rt, rj = tmeters.MeterRegistry(), jmeters.MeterRegistry()
    for name, value in _events(seed):
        rt.record(name, value)
        rj.record(name, value)
    return rt.snapshot(), rj.snapshot()


def _descriptions(metrics) -> dict:
    return {e[0]: " ".join(str(e[2]).split()) for e in metrics}


def _same_help(name: str) -> bool:
    t = next(e[0] for e in tmetrics.METRICS if fnmatch.fnmatchcase(name, e[0]))
    j = next(e[0] for e in jmetrics.METRICS if fnmatch.fnmatchcase(name, e[0]))
    return _descriptions(tmetrics.METRICS)[t] == _descriptions(jmetrics.METRICS)[j]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snapshot_json_and_rollup_match_the_jax_package(seed):
    got, want = _snapshots(seed)
    assert got == want
    assert texpo.to_json(got) == jexpo.to_json(want)
    assert texpo.to_json(got, indent=2) == jexpo.to_json(want, indent=2)
    assert texpo.meter_rollup(got) == jexpo.meter_rollup(want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prometheus_text_matches_the_jax_package(seed):
    got, want = _snapshots(seed)
    t_text = texpo.to_prometheus(got)
    j_text = jexpo.to_prometheus(want).replace("modin_tpu_", texpo.PREFIX)
    helps = 0
    for t_line, j_line in zip(t_text.splitlines(), j_text.splitlines(), strict=True):
        if t_line.startswith("# HELP "):
            metric = next(n for n in got["series"] if texpo.prometheus_name(n) == t_line.split(" ")[2])
            if _same_help(metric):
                assert t_line == j_line
                helps += 1
            else:
                assert t_line.split(" ")[:3] == j_line.split(" ")[:3]
        else:
            assert t_line == j_line
    assert helps >= 5
    parsed_t, parsed_j = texpo.parse_prometheus(t_text), texpo.parse_prometheus(j_text)
    for parsed in (parsed_t, parsed_j):
        for entry in parsed.values():
            entry.pop("help")
    assert parsed_t == parsed_j


def test_parse_prometheus_refuses_malformed_text():
    with pytest.raises(ValueError):
        texpo.parse_prometheus("modin_tpu_torch_x 1\n")  # a sample before its TYPE
    with pytest.raises(ValueError):
        texpo.parse_prometheus("# TYPE m histogram\nm_bucket{le=\"1\"} 5\nm_bucket{le=\"2\"} 3\n")


def test_cardinality_guard():
    with tcfg.MetersMaxSeries.context(3), tcfg.MetersEnabled.context(True):
        for i in range(7):
            emit_metric(f"view.invalidate.r{i}", 1)
        snap = tmeters.snapshot()
    assert len(snap["series"]) == 3 and snap["dropped_series"] == 4 and snap["dropped_observations"] == 4


# ====================================================================== #
# resilience families under the same injected faults
# ====================================================================== #

_N = 512
_KNOBS = ("ResilienceBreakerThreshold", "ResilienceBackoffS", "RecoveryMode", "MetersEnabled")


@pytest.fixture
def both_metered():
    saved = [(getattr(m, k), getattr(m, k).get()) for m in (jcfg, tcfg) for k in _KNOBS]
    for cfg in (jcfg, tcfg):
        cfg.ResilienceBreakerThreshold.put(50)
        cfg.ResilienceBackoffS.put(0.0)
        cfg.RecoveryMode.put("Disable")
        cfg.MetersEnabled.put(True)
    jres.reset_breakers()
    tres.reset_breakers()
    yield
    for p, v in saved:
        p.put(v)
    jres.reset_breakers()
    tres.reset_breakers()


FAMILY_QUERIES = [
    ("reduce", lambda df: df.median(numeric_only=True)),
    ("groupby", lambda df: df.groupby("key").sum()),
    ("merge", lambda df: df.merge(df, on="key", suffixes=("_l", "_r"))),
]


def _resilience_series(snapshot: dict) -> dict:
    return {k: v["total"] for k, v in snapshot["series"].items() if k.startswith(("resilience.", "recovery."))}


@pytest.mark.parametrize("kind", ["oom", "device_lost", "transient"])
@pytest.mark.parametrize("family,query", FAMILY_QUERIES, ids=[f[0] for f in FAMILY_QUERIES])
def test_resilience_meters_match_the_jax_package(family, query, kind, both_metered):
    rng = np.random.default_rng(abs(hash((family, kind))) % 2**32)
    data = {"a": rng.normal(size=_N), "b": rng.integers(0, 1000, _N), "key": rng.integers(0, 7, _N)}
    pdf = pandas.DataFrame(data)
    jdf = mpd.DataFrame(data)
    jdf._query_compiler.execute()
    tdf = tpd.DataFrame(data)
    tdf._query_compiler._modin_frame
    jmeters.reset()
    tmeters.reset()
    with j_inject(kind, times=4):
        j_got = query(jdf)._to_pandas()
    with t_inject(kind, times=4):
        t_got = query(tdf)._to_pandas()
    want = query(pdf)
    check = pandas.testing.assert_frame_equal if isinstance(want, pandas.DataFrame) else \
        pandas.testing.assert_series_equal
    for got in (j_got, t_got):
        check(got, want, check_exact=False, rtol=RTOL)
    t_series, j_series = _resilience_series(tmeters.snapshot()), _resilience_series(jmeters.snapshot())
    assert t_series == j_series
    assert t_series[f"resilience.fallback.{family}.{kind}"] == 1


# ====================================================================== #
# per-query accounting
# ====================================================================== #


def test_query_stats_has_the_jax_package_fields():
    public = lambda cls: [s for s in cls.__slots__ if not s.startswith("_")]  # noqa: E731
    assert public(tmeters.QueryStats) == public(jmeters.QueryStats)
    with tmeters.query_stats() as tq, jmeters.query_stats() as jq:
        pass
    assert list(tq.as_dict()) == list(jq.as_dict())
    assert tq.summary().splitlines()[0].startswith("wall: ")


def test_query_stats_counts_dispatches_lowerings_and_hits():
    lazy._FUSED_CACHE.clear()
    df = tpd.DataFrame({"a": np.arange(1000.0), "b": np.arange(1000.0)})
    with tmeters.query_stats("q") as qs:
        assert tmeters.ACCOUNTING_ON
        for _ in range(3):
            float(((df * 1.5 - df) + 0.25).sum()["a"])
    assert not tmeters.ACCOUNTING_ON
    assert qs.dispatches >= 3 and qs.compiles >= 1 and qs.compile_s > 0
    assert qs.cache_hits["fused"] >= 2 and qs.wall_s > 0 and qs.api_calls > 0
    assert qs.hbm_high_water >= 0 and qs.collective_bytes == 0 and qs.stream_windows == 0


def test_query_stats_nest_and_stay_on_their_thread():
    with tmeters.query_stats("outer") as outer:
        with tmeters.query_stats("inner") as inner:
            emit_metric("memory.device.spill", 2)
        t = threading.Thread(target=lambda: emit_metric("memory.device.spill", 5))
        t.start()
        t.join()
        emit_metric("memory.device.restore", 1)
    assert (outer.spills, inner.spills) == (2, 2)
    assert (outer.restores, inner.restores) == (1, 0)


def test_meters_off_make_no_meter():
    assert not tmeters.ACCOUNTING_ON and tmetrics._aggregate is None
    before = tmeters.meter_alloc_count()
    df = tpd.DataFrame({"k": [1, 2, 1, 3], "v": [1.0, 2.0, 3.0, 4.0]})
    df.groupby("k").sum()._to_pandas()
    (df + df).sum()
    assert tmeters.meter_alloc_count() == before
    assert tmeters.snapshot()["series"] == {}


def test_meters_on_aggregate_the_port_counters():
    df = tpd.DataFrame({"k": np.arange(64) % 5, "v": np.arange(64.0)})
    with tcfg.MetersEnabled.context(True):
        assert tmeters.meters_enabled()
        df.groupby("k").sum()._to_pandas()
        df.median()
        float((df * 2 + 1).sum()["v"])  # a fused launch through the engine's deploy
    series = tmeters.snapshot()["series"]
    assert series["engine.dispatch"]["total"] >= 1
    assert any(k.startswith("pandas-api.") for k in series)
    assert any(k.startswith("router.") for k in series)
    rollup = texpo.meter_rollup()
    assert rollup["dispatches"] == series["engine.dispatch"]["total"] and rollup["api_calls"] >= 2
    text = texpo.to_prometheus(tmeters.snapshot())
    assert texpo.parse_prometheus(text) and "modin_tpu_torch_engine_dispatch" in text


def test_the_port_counts_are_reads_of_one_tally():
    from modin_tpu_torch.core import memory
    from modin_tpu_torch.ops import router
    from modin_tpu_torch.views import registry

    tres.reset_counts()
    spills0, restore_s0 = memory.COUNTS["memory.device.spill"], memory.SECONDS["memory.device.restore"]
    verdicts0 = router.COUNTS.get("router.median.device", 0)
    with tcfg.MetersEnabled.context(True):
        tres.count("resilience.engine.deploy.retry", 2)
        memory.count("memory.device.spill")
        memory.add_seconds("memory.device.restore", 0.25)
        router._count("router.median.device")
    # each view reads the one store, only under its own names
    assert tres.COUNTS["resilience.engine.deploy.retry"] == tmetrics._counted["resilience.engine.deploy.retry"] == 2
    assert memory.COUNTS["memory.device.spill"] == spills0 + 1
    assert memory.SECONDS["memory.device.restore"] == restore_s0 + 0.25
    assert router.COUNTS["router.median.device"] == verdicts0 + 1
    assert "memory.device.spill" not in tres.COUNTS and "resilience.engine.deploy.retry" not in memory.COUNTS
    assert len(memory.COUNTS) == 10 and set(memory.SECONDS) == {"memory.device.spill_copy", "memory.device.restore"}
    assert registry.COUNTS["view.build"] >= 0 and "view.hit" in registry.COUNTS
    with pytest.raises(KeyError):
        memory.COUNTS["memory.device.restore_s"]  # seconds are read through SECONDS
    # the meters fold the same emissions
    series = tmeters.snapshot()["series"]
    assert series["resilience.engine.deploy.retry"]["total"] == 2 and series["memory.device.restore_s"]["total"] == 0.25
    tres.reset_counts()
    assert "resilience.engine.deploy.retry" not in tres.COUNTS
    assert memory.COUNTS["memory.device.spill"] == spills0 + 1
