"""Observability of the torch port: spans, the launch ledger, costs and the
flight recorder, held to the JAX package's ``modin_tpu/observability``.

Pure functions run on the same inputs through both packages and must give
the same bytes: ``to_chrome_trace`` over the same span records,
``roofline_fraction`` under the same peaks, the flight recorder's ring and
the fields of a dump.  The same queries (``from_pandas``, arithmetic,
reductions, an int-key groupby, ``to_pandas``) run under ``profile()`` in
both packages: the PANDAS-API spans and their nesting are identical, and so
are the QUERY-COMPILER spans once ``Tpu*`` is mapped to ``Torch*``; the
engine attempt spans are the same set.  The port wraps public methods and
the special methods outside ``logger_decorator.NEVER_WRAP`` (the JAX package
wraps its private helpers too), so both trees are read through that filter,
a span's parent being its nearest kept ancestor.  With tracing, meters and
cost capture off, the main path makes no span, no meter and no ledger
record; ``LogMode`` off writes no file.  A scan of the port's sources holds
every literal metric and span name to a pattern of ``METRICS``/``SPANS`` and
every pattern to a site.  Tracing changes no answer of
``tests/test_torch_slice.py``'s queries.  The kernels run their plain
versions on the CPU, which launch nothing: the ledger's launch hook is held
here through its own entry point, and on the card by ``chip_smoke.py``'s
phase 18.
"""

import ast
import collections
import fnmatch
import json
import os
import pathlib
import threading
import types

import numpy as np
import pandas
import pytest

import modin_tpu.observability as jobs
import modin_tpu.pandas as mpd
from modin_tpu import config as jcfg
from modin_tpu.logging import metrics as jmetrics
from modin_tpu.observability import chrome_trace as jchrome
from modin_tpu.observability import costs as jcosts
from modin_tpu.observability import flight_recorder as jflight

import modin_tpu_torch
import modin_tpu_torch.observability as tobs
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch import config as tcfg
from modin_tpu_torch.core.execution import resilience as tres
from modin_tpu_torch.logging import ClassLogger, disable_logging, logger_decorator
from modin_tpu_torch.logging import metrics as tmetrics
from modin_tpu_torch.observability import chrome_trace as tchrome
from modin_tpu_torch.observability import compile_ledger, meters
from modin_tpu_torch.observability import costs as tcosts
from modin_tpu_torch.observability import flight_recorder as tflight
from modin_tpu_torch.observability import spans as tspans
from modin_tpu_torch.ops import lazy
from modin_tpu_torch.testing import inject_faults as t_inject
from tests.test_torch_slice import QUERIES, RELATIONAL_QUERIES, make_data

PORT_ROOT = pathlib.Path(modin_tpu_torch.__file__).parent


@pytest.fixture(autouse=True)
def _clean():
    modin_tpu_torch.set_device("cpu")
    tres.reset_breakers()
    yield
    tres.reset_breakers()
    compile_ledger.get_compile_ledger().reset()


@pytest.fixture(autouse=True, scope="module")
def _join_jax_watchdog_threads():
    """Let the JAX package's per-fetch watchdog threads end before the next
    test file runs in this worker (``tests/test_watch.py`` counts threads)."""
    yield
    for t in threading.enumerate():
        if t.name.startswith("modin-tpu-watchdog"):
            t.join(timeout=5)


# ====================================================================== #
# pure functions, byte for byte against the JAX package
# ====================================================================== #


def _span_records(seed: int, n: int = 12) -> list:
    rng = np.random.default_rng(seed)
    layers = ["PANDAS-API", "QUERY-COMPILER", "CORE-FRAME", "APP"]
    records = []
    for i in range(n):
        attrs = {"rows": int(rng.integers(0, 1000)), "op": f"op{i % 3}"}
        if i % 4 == 0:
            attrs["ratio"] = float(rng.random())
        if i % 5 == 0:
            attrs["flag"] = bool(i % 2)
        records.append(types.SimpleNamespace(
            name=f"span.{i}", layer=layers[i % 4], span_id=i + 1,
            parent_id=int(rng.integers(1, i + 1)) if i and i % 3 else None,
            start_us=float(rng.random() * 1e6), dur_us=float(rng.random() * 1e3),
            attrs=attrs, thread_id=int(rng.integers(1, 4)), thread_name=f"t{i % 3}",
            status="ok" if i % 7 else "error",
        ))
    return records


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_to_chrome_trace_matches_the_jax_package(seed):
    rng = np.random.default_rng(seed + 10)
    spans = _span_records(seed)
    counters = [(float(rng.random() * 1e6), tuple(int(v) for v in rng.integers(0, 1 << 30, 5)))
                for _ in range(6)]
    other = {"rollup": {"wall_s": 0.5, "by_layer_self_s": {"APP": 0.25}}, "note": "x"}
    got = tchrome.to_chrome_trace(spans, other_data=other, counters=counters)
    want = jchrome.to_chrome_trace(spans, other_data=other, counters=counters)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert tchrome.COUNTER_TRACKS == jchrome.COUNTER_TRACKS[: len(tchrome.COUNTER_TRACKS)]


ROOFLINE_CASES = [
    (None, 8e9, 0.01),
    (1e9, 8e9, 0.01),
    (5e12, 1e9, 0.2),
    (1e6, None, 1e-3),
    (None, None, 0.5),
    (1e9, 8e9, 0.0),
]


@pytest.mark.parametrize("flops,nbytes,wall", ROOFLINE_CASES)
def test_roofline_fraction_matches_the_jax_package(flops, nbytes, wall):
    peaks = {"flops_per_s": 3.1e13, "bytes_per_s": 3.0e12, "source": "test"}
    saved = jcosts._peaks_cache
    jcosts._peaks_cache = dict(peaks)
    tcosts.set_substrate_peaks(dict(peaks))
    try:
        assert tcosts.roofline_fraction(flops, nbytes, wall) == jcosts.roofline_fraction(flops, nbytes, wall)
    finally:
        jcosts._peaks_cache = saved
        tcosts.set_substrate_peaks(None)


def _finish_spans(spans_mod, names):
    for name in names:
        spans_mod.finish_span(spans_mod.start_span(name, "CORE-IO", {"dispatcher": name}))


@pytest.mark.parametrize("size", [3, 8])
def test_flight_recorder_ring_and_dump_match_the_jax_package(size, tmp_path):
    from modin_tpu.observability import spans as jspans

    names = [f"io.read.{i}" for i in range(6)]
    saved = [(m.TraceFlightRecorderSize, m.TraceFlightRecorderSize.get()) for m in (jcfg, tcfg)]
    saved += [(m.TraceDir, m.TraceDir.get()) for m in (jcfg, tcfg)]
    try:
        for cfg, sub in ((jcfg, "jax"), (tcfg, "torch")):
            cfg.TraceFlightRecorderSize.put(size)
            cfg.TraceDir.put(str(tmp_path / sub))
        jflight.reset_for_tests()
        tflight.reset_for_tests()
        with jobs.profile(), tobs.profile():
            _finish_spans(jspans, names)
            _finish_spans(tspans, names)
            j_ring, t_ring = jflight.flight_snapshot(), tflight.flight_snapshot()
            assert [s.name for s in t_ring] == [s.name for s in j_ring] == names[-min(size, len(names)):]
            j_path = jflight.dump_flight_record("breaker_open_reduce", detail="d")
            t_path = tflight.dump_flight_record("breaker_open_reduce", detail="d")
        assert j_path and t_path
        j_rec, t_rec = (json.loads(pathlib.Path(p).read_text()) for p in (j_path, t_path))
        assert pathlib.Path(t_path).name.split("_")[:3] == pathlib.Path(j_path).name.split("_")[:3]
        assert set(t_rec["otherData"]) == set(j_rec["otherData"])
        for key in ("reason", "detail", "spans"):
            assert t_rec["otherData"][key] == j_rec["otherData"][key]
        assert set(t_rec["otherData"]["metrics"]) == set(j_rec["otherData"]["metrics"])

        def events(rec):
            return [(e["name"], e["cat"], sorted(k for k in e["args"] if not k.endswith("_id")))
                    for e in rec["traceEvents"] if e["ph"] == "X"]

        assert events(t_rec) == events(j_rec)
    finally:
        for p, v in saved:
            p.put(v)
        jflight.reset_for_tests()
        tflight.reset_for_tests()


def test_flight_recorder_is_rate_limited_and_off_without_tracing(tmp_path):
    with tcfg.TraceDir.context(str(tmp_path)):
        assert tflight.dump_flight_record("x") is None  # tracing off
        tflight.reset_for_tests()
        with tobs.profile():
            _finish_spans(tspans, ["io.read"])
            assert tflight.dump_flight_record("first") is not None
            assert tflight.dump_flight_record("second") is None  # inside the window
    tflight.reset_for_tests()


# ====================================================================== #
# the same queries under profile(), both packages
# ====================================================================== #


def _query(pd):
    rng = np.random.default_rng(5)
    p = pandas.DataFrame({"k": rng.integers(0, 5, 64), "a": rng.integers(0, 100, 64), "b": rng.random(64)})
    df = pd.DataFrame(p)
    total = (df + df).sum()
    scaled = (df * 2).mean()
    grouped = df.groupby("k").sum()
    return [total, scaled, grouped._to_pandas()]


#: a compiler built from host values: the JAX package builds a reduction's
#: one-row result from pandas, the port from numpy columns
_SAME_SEAM = {"TorchQueryCompiler.from_numpy_columns": "TorchQueryCompiler.from_pandas"}


def _kept(prof, layers) -> list:
    """``(nearest kept ancestor, name)`` of each span of ``layers`` whose
    method the port wraps, in start order, names mapped Tpu -> Torch."""
    out = []

    def visit(node, parent):
        sp = node["span"]
        name = _SAME_SEAM.get(sp.name.replace("Tpu", "Torch"), sp.name.replace("Tpu", "Torch"))
        if sp.layer in layers and logger_decorator.wraps_name(name.rsplit(".", 1)[-1]):
            out.append((parent, name))
            parent = name
        for child in node["children"]:
            visit(child, parent)

    for root in prof.tree():
        visit(root, None)
    return out


@pytest.fixture(scope="module")
def both_profiles():
    modin_tpu_torch.set_device("cpu")
    with jobs.profile() as jprof:
        j_answers = _query(mpd)
    with tobs.profile() as tprof:
        t_answers = _query(tpd)
    return jprof, tprof, j_answers, t_answers


def test_api_spans_and_their_nesting_match_the_jax_package(both_profiles):
    jprof, tprof, j_answers, t_answers = both_profiles
    got, want = _kept(tprof, {"PANDAS-API"}), _kept(jprof, {"PANDAS-API"})
    assert got == want and len(got) > 10
    pandas.testing.assert_frame_equal(t_answers[2], j_answers[2])


def test_query_compiler_spans_match_the_jax_package(both_profiles):
    jprof, tprof, _, _ = both_profiles
    got, want = _kept(tprof, {"QUERY-COMPILER"}), _kept(jprof, {"QUERY-COMPILER"})
    assert got == want
    assert ("TorchQueryCompiler.groupby_agg", "TorchQueryCompiler.to_pandas") in got


def test_engine_attempt_spans_in_both(both_profiles):
    jprof, tprof, _, _ = both_profiles
    names = lambda prof: {s.name for s in prof.spans if s.name.startswith("engine.") and s.name.endswith(".attempt")}
    assert names(tprof) == names(jprof) >= {"engine.put.attempt", "engine.materialize.attempt"}
    assert {s.layer for s in tprof.spans if s.name.startswith("engine.")} == {"TORCH-ENGINE"}
    attempts = [s for s in tprof.spans if s.name.endswith(".attempt")]
    assert all(s.attrs["attempt"] == 0 and s.status == "ok" for s in attempts)


def test_rollup_reports_its_clocks(both_profiles):
    _, tprof, _, _ = both_profiles
    rollup = tprof.rollup()
    assert rollup["wall_s"] > 0 and rollup["host_s"] <= rollup["wall_s"] + 1e-9
    assert rollup["engine_s"] > 0 and rollup["spans"] == len(tprof.spans)
    assert set(rollup["by_layer_self_s"]) >= {"PANDAS-API", "QUERY-COMPILER", "TORCH-ENGINE"}
    assert rollup["clocks"]["device_s"] == "events" and rollup["clocks"]["wall_s"] == "host"
    # no card here: no event pair, so the event-clock figures read 0
    assert rollup["device_s"] == rollup["kernel_device_s"] == rollup["engine_device_s"] == 0.0


def test_chrome_trace_exports_and_parses_back(both_profiles, tmp_path):
    _, tprof, _, _ = both_profiles
    path = tprof.export_chrome_trace(tmp_path / "q.trace.json")
    trace = json.loads(pathlib.Path(path).read_text())
    complete = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert len(complete) == len(tprof.spans)
    assert trace["otherData"]["rollup"]["spans"] == len(tprof.spans)
    ids = {e["args"]["span_id"] for e in complete}
    assert all(e["args"].get("parent_id", next(iter(ids))) in ids for e in complete)


# ====================================================================== #
# the disabled contract
# ====================================================================== #


def _main_path():
    d1 = make_data((500, 6), ngroups=7)
    d2 = make_data((500, 6), seed=1, ngroups=7)
    out = []
    for name in ("df_plus_df", "sum", "mean", "groupby_sum", "groupby_mean", "groupby_size"):
        out.append(tpd.to_pandas(QUERIES[name](tpd.DataFrame(d1), tpd.DataFrame(d2))))
    return out


def test_disabled_contract_makes_nothing():
    assert not tspans.TRACE_ON and not meters.ACCOUNTING_ON and not tcosts.COST_ON
    assert not compile_ledger.LEDGER_ON and logger_decorator._PLAIN
    ledger = compile_ledger.get_compile_ledger()
    lazy._FUSED_CACHE.clear()  # the run lowers programs: none is billed while off
    before = (tspans.span_alloc_count(), meters.meter_alloc_count(), ledger.totals(), ledger.launch_counts())
    _main_path()
    after = (tspans.span_alloc_count(), meters.meter_alloc_count(), ledger.totals(), ledger.launch_counts())
    assert after == before
    assert tspans.span("io.read") is tspans._NULL_HANDLE


def test_log_mode_off_writes_no_file(tmp_path):
    logdir = tmp_path / "logs"
    with tcfg.LogDir.context(str(logdir)):
        _main_path()
    assert not logdir.exists()


def test_log_mode_enable_writes_start_and_stop(tmp_path):
    import logging

    from modin_tpu_torch.logging import config as log_config

    logdir = tmp_path / "logs"
    saved = log_config.__LOGGER_CONFIGURED__
    log_config.__LOGGER_CONFIGURED__ = False
    try:
        with tcfg.LogDir.context(str(logdir)), tcfg.LogMode.context("Enable_Api_Only"):
            assert not logger_decorator._PLAIN
            tpd.DataFrame({"a": [1, 2]}).sum()
        for h in logging.getLogger("modin_tpu_torch.logger").handlers:
            h.flush()
        text = "".join(p.read_text() for p in logdir.rglob("*.log"))
        assert "START::PANDAS-API::BasePandasDataset.sum" in text
        assert "STOP::PANDAS-API::BasePandasDataset.sum" in text
        assert "QUERY-COMPILER" not in text  # the API layer only
    finally:
        log = logging.getLogger("modin_tpu_torch.logger")
        for h in list(log.handlers):
            log.removeHandler(h)
            h.close()
        log_config.__LOGGER_CONFIGURED__ = saved
    assert logger_decorator._PLAIN


def test_api_metrics_reach_a_handler():
    seen = collections.Counter()
    handler = lambda name, value: seen.update([name])  # noqa: E731
    tmetrics.add_metric_handler(handler)
    try:
        assert not logger_decorator._PLAIN
        tpd.DataFrame({"a": [1, 2]}).sum()
    finally:
        tmetrics.clear_metric_handler(handler)
    assert seen["modin_tpu_torch.pandas-api.basepandasdataset_sum"] == 1
    assert logger_decorator._PLAIN


# ====================================================================== #
# ClassLogger's wrap
# ====================================================================== #


class _Base(ClassLogger, modin_layer="PANDAS-API"):
    def public(self):
        return "public"

    def _private(self):
        return "private"

    @classmethod
    def make(cls):
        return cls()

    @staticmethod
    def helper(x):
        return x + 1

    @property
    def prop(self):
        return 7

    def __getattr__(self, key):
        raise AttributeError(key)

    def __repr__(self):
        return "<base>"

    def __add__(self, other):
        return "added"

    @disable_logging
    def quiet(self):
        return "quiet"


class _Child(_Base):
    inherited = _Base.public

    def public(self):
        return "child"


def test_class_wrap_takes_public_and_special_methods_once():
    assert getattr(_Base.__dict__["public"], "__wrapped__", None) is not None
    assert not hasattr(_Base.__dict__["_private"], "__wrapped__")
    assert hasattr(_Base.__dict__["make"].__func__, "__wrapped__")
    assert hasattr(_Base.__dict__["helper"].__func__, "__wrapped__")
    assert isinstance(_Base.__dict__["prop"], property) and not hasattr(_Base.__dict__["prop"].fget, "__wrapped__")
    for name in ("__getattr__", "__repr__", "quiet"):
        assert not hasattr(_Base.__dict__[name], "__wrapped__"), name
    assert hasattr(_Base.__dict__["__add__"], "__wrapped__")
    # an inherited wrapper is not wrapped again
    assert _Child.__dict__["inherited"] is _Base.__dict__["public"]
    assert not hasattr(_Child.__dict__["inherited"].__wrapped__, "__wrapped__")
    obj = _Child.make()
    assert (obj.public(), obj.inherited(), _Child.helper(1), obj.prop, repr(obj), obj + obj, obj.quiet()) == (
        "child", "public", 2, 7, "<base>", "added", "quiet")
    with tobs.profile() as prof:
        obj.public()
        obj._private()
        _Child.make()
    assert [s.name for s in prof.spans] == ["_Child.public", "_Base.make"]
    assert {s.layer for s in prof.spans} == {"PANDAS-API"}


def test_port_classes_keep_their_getattr_dispatch():
    df = tpd.DataFrame({"col_a": [1, 2, 3]})
    assert list(df.col_a._to_pandas()) == [1, 2, 3]
    for cls in (tpd.DataFrame, tpd.Series):
        for name in ("__getattr__", "__getattribute__", "__setattr__", "__repr__", "__len__"):
            fn = cls.__dict__.get(name)
            assert fn is None or not hasattr(fn, "__wrapped__"), (cls, name)


# ====================================================================== #
# registries: every literal name matches a pattern, every pattern a site
# ====================================================================== #

#: the port's emit sites: the call's name, and what it adds to its name
_METRIC_CALLS = {"emit_metric": "", "count": "", "_count": "", "timed_copy": "_s"}
_SPAN_CALLS = {"span", "start_span", "event"}


def _literals(node) -> list:
    """A call's first argument as name patterns (``*`` for each
    interpolated part; both branches of a conditional), or [] when it is
    not a literal."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, ast.JoinedStr):
        return ["".join(v.value if isinstance(v, ast.Constant) else "*" for v in node.values)]
    if isinstance(node, ast.IfExp):
        return _literals(node.body) + _literals(node.orelse)
    return []


def _sites():
    metrics, spans = collections.defaultdict(list), collections.defaultdict(list)
    for path in PORT_ROOT.rglob("*.py"):
        if "_build" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fn = node.func
            fname = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", None)
            where = f"{path.relative_to(PORT_ROOT)}:{node.lineno}"
            for name in _literals(node.args[0]):
                if name.startswith("*"):
                    continue  # a forwarding helper re-emits its caller's name
                if fname in _METRIC_CALLS:
                    metrics[name + _METRIC_CALLS[fname]].append(where)
                elif fname in _SPAN_CALLS:
                    spans[name].append(where)
    return metrics, spans


def _matches(site: str, pattern: str) -> bool:
    return fnmatch.fnmatchcase(site, pattern)


@pytest.mark.parametrize("kind", ["metric", "span"])
def test_every_literal_name_is_registered(kind):
    metrics, spans = _sites()
    sites, registry = (metrics, tmetrics.METRICS) if kind == "metric" else (spans, tspans.SPANS)
    assert sites
    unregistered = {s: w for s, w in sites.items() if not any(_matches(s, entry[0]) for entry in registry)}
    assert not unregistered


@pytest.mark.parametrize("kind", ["metric", "span"])
def test_every_pattern_has_a_site(kind):
    metrics, spans = _sites()
    sites, registry = (metrics, tmetrics.METRICS) if kind == "metric" else (spans, tspans.SPANS)
    dead = [entry[0] for entry in registry if not any(_matches(s, entry[0]) for s in sites)]
    assert not dead


def test_registries_are_well_formed():
    patterns = [e[0] for e in tmetrics.METRICS]
    assert len(patterns) == len(set(patterns))
    assert all(e[1] in meters.VALID_KINDS and e[2] for e in tmetrics.METRICS)
    hist = {e[0] for e in tmetrics.METRICS if e[1] == "histogram"}
    assert hist == set(meters.HISTOGRAM_BUCKETS)
    # the JAX package's names are kept where the port emits the same event
    jax_patterns = {e[0]: e[1] for e in jmetrics.METRICS}
    shared = [p for p in patterns if p in jax_patterns]
    assert len(shared) > 40
    assert all(jax_patterns[p] == dict((e[0], e[1]) for e in tmetrics.METRICS)[p] for p in shared)
    assert [e[0] for e in tspans.SPANS] == sorted({e[0] for e in tspans.SPANS}, key=[e[0] for e in tspans.SPANS].index)


# ====================================================================== #
# the launch ledger
# ====================================================================== #


def test_launch_ledger_counts_per_kernel_and_signature():
    ledger = compile_ledger.get_compile_ledger()
    ledger.reset()
    with tobs.profile() as prof:
        assert compile_ledger.LEDGER_ON and not compile_ledger.EVENTS_ON  # no card: no events
        with tspans.span("fuse.lower", "QUERY-COMPILER"):
            compile_ledger.note_launch("fused", None, None, 100, 2400.0, 300.0)
            compile_ledger.note_launch("fused", None, None, 50, 1200.0, 150.0)
        compile_ledger.note_launch("bincount", None, None, 10, 88.0, 0.0)
    snap = ledger.launch_snapshot()
    assert ledger.launch_counts() == {"fused": 2, "bincount": 1}
    assert snap["fused"]["rows"] == 150 and snap["fused"]["bytes"] == 3600.0
    assert set(snap["fused"]["signatures"]) == {"fuse.lower"}
    assert set(snap["bincount"]["signatures"]) == {"<untraced>"}
    assert snap["fused"]["timed"] == 0 and compile_ledger.pending_events() == 0
    rollup = prof.rollup()
    assert rollup["kernels"]["fused"] == {"launches": 2, "device_ms": 0.0, "bytes": 3600.0, "flops": 450.0}


def test_launch_hook_is_off_by_default():
    from modin_tpu_torch.ops.cuda import groupby_kernels

    assert not compile_ledger.LEDGER_ON
    assert compile_ledger.launch_begin() is None
    import torch

    groupby_kernels.bincount(torch.tensor([0, 1, 1, 5]), 3)  # the plain version: no launch
    assert compile_ledger.get_compile_ledger().launch_counts() == {}


def test_fused_program_cache_bills_lowerings_and_hits():
    ledger = compile_ledger.get_compile_ledger()
    ledger.reset()
    lazy._FUSED_CACHE.clear()
    df = tpd.DataFrame({"a": np.arange(100.0), "b": np.arange(100.0)})
    with tobs.profile() as prof:
        for _ in range(3):
            ((df * 3.5 + df) - 1.25).sum()
    snap = ledger.snapshot()
    assert snap["total_compiles"] >= 1 and snap["total_compile_s"] > 0
    assert sum(e["lowerings"] for e in snap["signatures"].values()) == snap["total_compiles"]
    assert sum(e["cache_hits"] for e in snap["signatures"].values()) >= 2
    # billed to the innermost span: the reduction's API call (the port's
    # generated compiler methods, like the JAX package's, carry no span)
    billed = [s for s, e in snap["signatures"].items() if e["lowerings"]]
    assert billed == ["BasePandasDataset.sum"]
    assert ledger.recompile_storms(min_compiles=1)
    assert prof.find("fusion.lower") and prof.rollup()["compile_s"] > 0


# ====================================================================== #
# the seams emit their spans
# ====================================================================== #


def test_breaker_opening_dumps_a_flight_record(tmp_path, monkeypatch):
    df = tpd.DataFrame({"a": np.arange(64.0), "b": np.arange(64)})
    tflight.reset_for_tests()
    monkeypatch.setattr(tflight, "MIN_DUMP_INTERVAL_S", 0.0)
    with tcfg.TraceDir.context(str(tmp_path)), tcfg.ResilienceBreakerThreshold.context(2), \
            tcfg.ResilienceBackoffS.context(0.0), tcfg.RecoveryMode.context("Disable"), tobs.profile() as prof:
        with t_inject("device_lost", ops=("materialize",), times=None):
            for _ in range(3):
                df.median()._to_pandas()
    dumps = sorted(os.listdir(tmp_path))
    assert any("breaker_open_reduce" in d for d in dumps)
    record = json.loads((tmp_path / [d for d in dumps if "breaker_open_reduce" in d][0]).read_text())
    names = {e["name"] for e in record["traceEvents"] if e["ph"] == "X"}
    assert "engine.materialize.attempt" in names
    assert "metrics" in record["otherData"]
    fallbacks = prof.find("fallback.reduce")
    assert {s.attrs["reason"] for s in fallbacks} == {"device_lost", "short_circuit"}
    failed = [s for s in prof.find("engine.materialize.attempt") if s.status == "error"]
    assert failed and all(s.attrs["failure_kind"] == "device_lost" for s in failed)
    tflight.reset_for_tests()


def test_plan_seams_emit_spans(tmp_path):
    path = tmp_path / "p.csv"
    rng = np.random.default_rng(3)
    pandas.DataFrame({"a": rng.integers(-50, 50, 300), "b": rng.random(300), "d": rng.integers(0, 9, 300)}).to_csv(
        path, index=False)
    with tobs.profile() as prof:
        got = tpd.read_csv(path).query("a > 0")[["b"]].sum()
    want = pandas.read_csv(path).query("a > 0")[["b"]].sum()
    pandas.testing.assert_series_equal(got._to_pandas(), want)
    names = {s.name for s in prof.spans}
    assert {"plan.optimize", "plan.lower", "io.read"} <= names
    assert any(s.name == "FileDispatcher.read" or s.name.endswith("Dispatcher.read") for s in prof.spans)


def test_explain_analyze_shows_the_cost_leg(tmp_path):
    path = tmp_path / "p.csv"
    pandas.DataFrame({"a": np.arange(50), "b": np.arange(50.0)}).to_csv(path, index=False)
    text = tpd.read_csv(path).query("a > 5")[["b"]]._query_compiler.explain(analyze=True)
    assert "moved=" in text and "roofline~host=" in text and "padding=" in text and "cost=off" not in text
    with tcfg.CostCapture.context("Off"):
        text = tpd.read_csv(path).query("a > 5")[["b"]]._query_compiler.explain(analyze=True)
    assert "cost=off" in text


def test_explain_cost_leg_takes_the_launch_events_where_they_ran():
    from modin_tpu_torch.plan import explain as texplain

    measured = {"est_flops": 0.0, "est_bytes": 8e9, "total_s": 4.0, "device": {"device_ms": 2000.0, "launches": 3}}
    tcosts.set_substrate_peaks({"flops_per_s": 1e12, "bytes_per_s": 8e9, "source": "test"})
    try:
        on_events = texplain._cost_suffix(measured)
        assert "bw=4.0GB/s" in on_events and "roofline=50.0%" in on_events and "~host" not in on_events
        on_host = texplain._cost_suffix({**measured, "device": None})
        assert "bw~host=2.0GB/s" in on_host and "roofline~host=25.0%" in on_host
    finally:
        tcosts.set_substrate_peaks(None)


def test_explain_node_accumulators_nest_and_take_their_launch_events(monkeypatch):
    import time

    import torch

    class FakeEvent:
        def __init__(self):
            self.t = time.perf_counter()

        def elapsed_time(self, other):
            return 2.0

    monkeypatch.setattr(compile_ledger, "EVENTS_ON", True)
    monkeypatch.setattr(compile_ledger, "_event", lambda device=None: FakeEvent())
    monkeypatch.setattr(compile_ledger, "_pool", [])  # the stand-ins never reach the real pool
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    outer = compile_ledger.push_device_acc()
    compile_ledger.note_launch("fused", None, FakeEvent(), 10, 80.0, 0.0)
    inner = compile_ledger.push_device_acc()
    compile_ledger.note_launch("scan", None, FakeEvent(), 10, 160.0, 0.0)
    compile_ledger.pop_device_acc(inner)
    compile_ledger.note_launch("fused", None, FakeEvent(), 10, 80.0, 0.0)
    compile_ledger.pop_device_acc(outer)
    compile_ledger.note_launch("bincount", None, FakeEvent(), 10, 40.0, 0.0)
    assert compile_ledger.resolve_events() == 4
    assert outer == {"device_ms": 6.0, "launches": 3} and inner == {"device_ms": 2.0, "launches": 1}
    monkeypatch.setattr(compile_ledger, "EVENTS_ON", False)
    assert compile_ledger.push_device_acc() is None


def test_peaks_are_measured_only_on_an_explicit_call(tmp_path, monkeypatch):
    def refuse():
        raise AssertionError("substrate_peaks measured the device")

    monkeypatch.setattr(tcosts, "_measure_host_peaks", refuse)
    monkeypatch.setattr(tcosts, "measure_card_peaks", refuse)
    with tcfg.CacheDir.context(str(tmp_path)):
        tcosts.set_substrate_peaks(None)
        try:
            assert tcosts.substrate_peaks() is None
            assert tcosts.roofline_fraction(None, 1e9, 1.0) is None
            monkeypatch.undo()
            measured = tcosts.measure_substrate_peaks()
            assert measured["source"] == "measured" and measured["bytes_per_s"] > 0
            assert tcosts.substrate_peaks() is measured
            tcosts.set_substrate_peaks(None)  # a new process reads the cached table
            cached = tcosts.substrate_peaks()
            assert cached["source"] == "measured (cached)"
            assert cached["bytes_per_s"] == measured["bytes_per_s"]
        finally:
            tcosts.set_substrate_peaks(None)


def test_padding_is_billed_to_the_thread_and_the_ledger():
    tcosts.reset()
    with meters.query_stats("pad") as qs:
        assert tcosts.COST_ON
        p0 = tcosts.thread_padding()
        tcosts.note_padding("fuse.groupby.slots", 3 * 17 * 8, 3 * 10 * 8)
        p1 = tcosts.thread_padding()
    assert (p1[0] - p0[0], p1[1] - p0[1]) == (408, 168)
    assert qs.padded_bytes == 408 and qs.padding_waste_bytes == 168
    assert tcosts.get_cost_ledger().snapshot()["padding"]["fuse.groupby.slots"]["waste_bytes"] == 168
    assert tcosts.counter_sample()[0] == 168
    tcosts.reset()


def test_progress_bar_seeds_its_thread(monkeypatch):
    from modin_tpu_torch.core.execution import progress

    seen = {}
    monkeypatch.setattr(progress, "_LONG_OP_SECONDS", 0.0)
    orig_run = progress._OpProgress._run

    def run(self):
        seen["stack"] = list(self._span_stack or [])
        return orig_run(self)

    monkeypatch.setattr(progress._OpProgress, "_run", run)
    df = tpd.DataFrame({"a": [1, 2, 3]})
    with tcfg.ProgressBar.context(True), tobs.profile():
        with tspans.layer_span("outer", "APP") as outer:
            got = df.sum()
    assert int(got._to_pandas()["a"]) == 6
    # the bar's thread adopts the caller's stack: its spans nest under it
    assert seen["stack"] == [outer]


# ====================================================================== #
# tracing changes no answer of the slice's queries
# ====================================================================== #


def _exact(got, want):
    if isinstance(want, pandas.DataFrame):
        pandas.testing.assert_frame_equal(got, want, check_exact=True)
    else:
        pandas.testing.assert_series_equal(got, want, check_exact=True)


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_tracing_changes_no_main_path_answer(query):
    d1 = make_data((2000, 10), ngroups=100)
    d2 = make_data((2000, 10), seed=1, ngroups=100)
    fn = QUERIES[query]
    plain = tpd.to_pandas(fn(tpd.DataFrame(d1), tpd.DataFrame(d2)))
    with tcfg.MetersEnabled.context(True), tobs.profile() as prof:
        traced = tpd.to_pandas(fn(tpd.DataFrame(d1), tpd.DataFrame(d2)))
    _exact(traced, plain)
    assert prof.spans


@pytest.mark.parametrize("query", sorted(RELATIONAL_QUERIES))
def test_tracing_changes_no_relational_answer(query):
    d1 = make_data((2000, 10), seed=8, ngroups=20)
    d2 = make_data((2000, 10), seed=9, ngroups=20)
    fn = RELATIONAL_QUERIES[query]
    plain = tpd.to_pandas(fn(tpd, tpd.DataFrame(d1), tpd.DataFrame(d2)))
    with tcfg.MetersEnabled.context(True), tobs.profile() as prof:
        traced = tpd.to_pandas(fn(tpd, tpd.DataFrame(d1), tpd.DataFrame(d2)))
    _exact(traced, plain)
    assert prof.spans
