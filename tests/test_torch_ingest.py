"""Continuous ingestion of the torch port against the JAX package's.

Every case of ``tests/test_ingest.py`` runs through both packages on the
same seeded batch streams: the JAX package (TpuOnJax on the CPU mesh) and
the port on the CPU.  A scenario returns what it observed (the feed's
frame, each view's maintained answer and its ``recompute`` on the frame,
the typed refusals' reasons, the ``ingest.*`` metric events), and the two
packages' observations must be equal: ints, counts and order exactly,
floats to rtol 1e-12.  Each scenario also holds its answers to pandas, as
``tests/test_ingest.py`` does.

The one departure: a batch column of pandas' ``str`` dtype (which numpy
cannot interpret) makes the JAX package's ``np.can_cast`` raise a bare
``TypeError``; the port rejects it with ``IngestRejected("dtype")``, and
casts it to ``object`` where the schema column is ``object``.
"""

import collections
import fnmatch
import importlib
import types
import zlib

import numpy as np
import pandas
import pytest
import torch

import modin_tpu.pandas as mpd
from modin_tpu import config as jcfg
from modin_tpu import ingest as j_ingest
from modin_tpu.core import memory as j_memory
from modin_tpu.logging.metrics import add_metric_handler as j_add
from modin_tpu.logging.metrics import clear_metric_handler as j_clear
from modin_tpu.testing import faults as j_faults
from modin_tpu.views import registry as j_registry

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch import config as tcfg
from modin_tpu_torch import ingest as t_ingest
from modin_tpu_torch.concurrency import lockdep as t_lockdep
from modin_tpu_torch.core import memory as t_memory
from modin_tpu_torch.logging.metrics import add_metric_handler as t_add
from modin_tpu_torch.logging.metrics import clear_metric_handler as t_clear
from modin_tpu_torch.testing import faults as t_faults
from modin_tpu_torch.views import registry as t_registry

from tests.test_ingest import _PLANS, _SCHEMA, _apply_upsert, _assert_answer, _batch, _truth
from tests.utils import require_tpu_execution

JAX = types.SimpleNamespace(name="jax", ingest=j_ingest, cfg=jcfg, pd=mpd, registry=j_registry, memory=j_memory,
                            faults=j_faults, add=j_add, clear=j_clear, prefix="modin_tpu.")
PORT = types.SimpleNamespace(name="port", ingest=t_ingest, cfg=tcfg, pd=tpd, registry=t_registry, memory=t_memory,
                             faults=t_faults, add=t_add, clear=t_clear, prefix="modin_tpu_torch.")
PACKAGES = (JAX, PORT)
_KNOBS = ("IngestEnabled", "IngestFoldEvery", "IngestRetentionRows", "IngestRetentionAgeS", "ViewsMaxChain",
          "ServingEnabled")
#: the metric families a scenario's observations carry
_FAMILIES = ("ingest.", "view.lag_ms")
FLOAT_RTOL = 1e-12


@pytest.fixture(autouse=True)
def _ingest_env():
    require_tpu_execution()
    modin_tpu_torch.set_device("cpu")
    saved = [(getattr(P.cfg, k), getattr(P.cfg, k).get()) for P in PACKAGES for k in _KNOBS]
    for P in PACKAGES:
        P.registry.reset()
        P.ingest.reset()
        P.cfg.IngestEnabled.put(True)
    yield
    for P in PACKAGES:
        P.ingest.reset()
        P.registry.reset()
    for param, value in saved:
        param.put(value)


def _seed(*parts) -> int:
    return zlib.crc32(repr(parts).encode())


def _run(P, scenario, *args):
    """One scenario on one package; its observations with the counts of the
    ingest metric events it emitted."""
    seen = []

    def handler(name, value):
        seen.append(name[len(P.prefix):])

    P.add(handler)
    try:
        observed = dict(scenario(P, *args) or {})
    finally:
        P.clear(handler)
    observed["metrics"] = collections.Counter(n for n in seen if n.startswith(_FAMILIES))
    if P is PORT:
        assert_declared(seen)
    return observed


def assert_declared(names):
    """Every ``ingest.*``, ``view.lag_ms``, ``wal.*``, ``checkpoint.*`` and
    ``recovery.*`` name the port emitted matches a family of ``METRICS``."""
    from modin_tpu_torch.logging.metrics import METRICS

    families = ("ingest.", "view.lag_ms", "wal.", "checkpoint.", "recovery.")
    undeclared = {n for n in names if n.startswith(families)
                  and not any(fnmatch.fnmatchcase(n, pattern) for pattern, _kind, _what in METRICS)}
    assert not undeclared, undeclared


def _values_same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind == "f" or got.dtype.kind == "f":
        np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=FLOAT_RTOL, atol=0,
                                   equal_nan=True, err_msg=what)
    else:
        assert got.tolist() == want.tolist(), (what, got, want)


def _same(got, want, what="observed"):
    """The port's observation ``got`` against the JAX package's ``want``:
    frames and series with their index, dtypes and names; ints exactly,
    floats to rtol 1e-12."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (what, sorted(got), sorted(want))
        for k in want:
            _same(got[k], want[k], f"{what}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (what, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
    elif isinstance(want, pandas.DataFrame):
        assert isinstance(got, pandas.DataFrame), (what, type(got))
        assert list(got.columns) == list(want.columns) and list(got.dtypes) == list(want.dtypes), what
        pandas.testing.assert_index_equal(got.index, want.index, exact=False, obj=what)
        for col in want.columns:
            _values_same(got[col].to_numpy(), want[col].to_numpy(), f"{what}.{col}")
    elif isinstance(want, pandas.Series):
        assert isinstance(got, pandas.Series), (what, type(got))
        assert got.dtype == want.dtype and got.name == want.name, (what, got.dtype, want.dtype, got.name, want.name)
        pandas.testing.assert_index_equal(got.index, want.index, exact=False, obj=what)
        _values_same(got.to_numpy(), want.to_numpy(), what)
    elif isinstance(want, (np.generic, int, float, bool)) and not isinstance(want, str):
        _values_same(got, want, what)
    else:
        assert got == want, (what, got, want)


def _both(scenario, *args):
    """The scenario on the JAX package, then on the port: the port's
    observations equal the JAX package's."""
    jax_seen = _run(JAX, scenario, *args)
    port_seen = _run(PORT, scenario, *args)
    _same(port_seen, jax_seen)
    return port_seen


def _frame(feed):
    return feed.frame._to_pandas().reset_index(drop=True)


def _empty_mirror(feed):
    return pandas.DataFrame({c: pandas.Series(dtype=d) for c, d in feed.schema.items()})


# ====================================================================== #
# the differential grid
# ====================================================================== #


def _grid(P, name, mode, seed):
    if mode == "trim":
        P.cfg.IngestRetentionRows.put(70)
    rng = np.random.default_rng(seed)
    feed = P.ingest.create_feed("events", _SCHEMA, key="k" if mode == "upsert" else None)
    feed.register_view(name, _PLANS[name])
    mirror = _empty_mirror(feed)
    for b in range(5):
        batch = _batch(rng, 24, key_start=b * 24)
        feed.append(batch)
        mirror = pandas.concat([mirror, batch], ignore_index=True)
        if mode == "trim":
            while len(mirror) > 70:
                mirror = mirror.iloc[24:].reset_index(drop=True)
    if mode == "upsert":
        up = _batch(rng, 30, key_start=96)  # 24 updates and 6 new keys
        feed.upsert(up)
        mirror = _apply_upsert(mirror, up)
    frame = _frame(feed)
    pandas.testing.assert_frame_equal(frame, mirror.astype(_SCHEMA))
    maintained, recomputed = feed.read(name).value, feed.recompute(name)
    _assert_answer(name, maintained, _truth(name, mirror))
    _assert_answer(name, recomputed, _truth(name, mirror))
    return {"frame": frame, "maintained": maintained, "recompute": recomputed, "rows": feed.rows}


class TestDifferentialGrid:
    @pytest.mark.parametrize("name", sorted(_PLANS))
    @pytest.mark.parametrize("mode", ["append", "upsert", "trim"])
    def test_grid(self, name, mode):
        _both(_grid, name, mode, _seed(name, mode))

    def test_upsert_semantics_exact(self):
        kinds = ("scalar", "groupby", "topk", "windowed", "filtered")

        def scenario(P):
            feed = P.ingest.create_feed("events", _SCHEMA, key="k")
            for v in kinds:
                feed.register_view(v, _PLANS[v])
            rng = np.random.default_rng(11)
            b0 = _batch(rng, 40)
            feed.append(b0)
            up = _batch(rng, 20, key_start=30)  # keys 30..39 update, 40..49 new
            up = pandas.concat([up, up.iloc[:1].assign(i=np.int64(999))], ignore_index=True)
            feed.upsert(up)
            expect = _apply_upsert(b0.astype(_SCHEMA), up.astype(_SCHEMA))
            assert expect.loc[30, "i"] == 999
            out = {"frame": _frame(feed)}
            pandas.testing.assert_frame_equal(out["frame"], expect)
            for v in kinds:
                out[v] = (feed.read(v).value, feed.recompute(v))
                for got in out[v]:
                    _assert_answer(v, got, _truth(v, expect))
            return out

        _both(scenario)

    @pytest.mark.parametrize("agg", ["min", "max", "mean", "sum", "count"])
    def test_filtered_agg_survives_empty_match_batches(self, agg):
        def scenario(P):
            feed = P.ingest.create_feed(f"empty_{agg}", _SCHEMA)
            feed.register_view("v", {"kind": "filtered", "column": "i", "agg": agg, "predicate": ("x", ">", 0.0)})
            frames = []
            for rows in ([(0, 3, 1.0), (1, 5, 1.0)], [(2, -7, -1.0)], [(3, 9, 1.0)]):
                b = pandas.DataFrame({"k": [r[0] for r in rows], "i": [r[1] for r in rows],
                                      "x": [r[2] for r in rows], "g": 0, "ts": 0.0}).astype(_SCHEMA)
                feed.append(b)
                frames.append(b)
            full = pandas.concat(frames, ignore_index=True)
            want = getattr(full["i"][full["x"] > 0.0], agg)()
            got = feed.read("v").value
            assert got == want
            recomputed = feed.recompute("v")
            _assert_answer("filtered", recomputed, want)
            return {"maintained": got, "recompute": recomputed}

        _both(scenario)

    def test_filtered_minmax_refold_skips_empty_partials(self):
        def scenario(P):
            feed = P.ingest.create_feed("empty_refold", _SCHEMA, retention_rows=2)
            feed.register_view("v", {"kind": "filtered", "column": "i", "agg": "min", "predicate": ("x", ">", 0.0)})
            for i, x in [(3, 1.0), (-7, -1.0), (9, 1.0)]:
                feed.append(pandas.DataFrame({"k": [i], "i": [i], "x": [x], "g": [0], "ts": [0.0]}).astype(_SCHEMA))
            assert feed.rows == 2 and feed.read("v").value == 9
            none_feed = P.ingest.create_feed("all_empty", _SCHEMA)
            none_feed.register_view("v", {"kind": "filtered", "column": "i", "agg": "min",
                                          "predicate": ("x", ">", 0.0)})
            none_feed.append(pandas.DataFrame({"k": [0], "i": [1], "x": [-1.0], "g": [0], "ts": [0.0]})
                             .astype(_SCHEMA))
            empty = none_feed.read("v").value
            assert np.isnan(empty)
            return {"rows": feed.rows, "min": feed.read("v").value, "empty": empty}

        _both(scenario)

    def test_keyless_upsert_rejected_not_keyed(self):
        def scenario(P):
            feed = P.ingest.create_feed("events", _SCHEMA)
            with pytest.raises(P.ingest.IngestRejected) as err:
                feed.upsert(_batch(np.random.default_rng(0), 3))
            assert feed.rows == 0
            return {"reason": err.value.reason, "rows": feed.rows}

        seen = _both(scenario)
        assert seen["reason"] == "not_keyed" and seen["metrics"]["ingest.reject"] == 1

    def test_per_feed_retention_override(self):
        def scenario(P):
            bounded = P.ingest.create_feed("bounded", _SCHEMA, retention_rows=20)
            unbounded = P.ingest.create_feed("unbounded", _SCHEMA)
            rng = np.random.default_rng(7)
            for b in range(4):
                batch = _batch(rng, 10, key_start=b * 10)
                bounded.append(batch)
                unbounded.append(batch)
            return {"bounded": bounded.rows, "unbounded": unbounded.rows, "frame": _frame(bounded)}

        seen = _both(scenario)
        assert (seen["bounded"], seen["unbounded"]) == (20, 40)

    def test_keyed_append_rejects_duplicates(self):
        def scenario(P):
            feed = P.ingest.create_feed("events", _SCHEMA, key="k")
            feed.append(_batch(np.random.default_rng(0), 10))
            dup_in_batch = _batch(np.random.default_rng(1), 4, key_start=100)
            dup_in_batch.loc[3, "k"] = 100
            reasons = []
            for bad in (dup_in_batch, _batch(np.random.default_rng(2), 4, key_start=8)):
                with pytest.raises(P.ingest.IngestRejected) as err:
                    feed.append(bad)
                reasons.append(err.value.reason)
            return {"reasons": reasons, "rows": feed.rows, "frame": _frame(feed)}

        seen = _both(scenario)
        assert seen["reasons"] == ["duplicate_key", "key_exists"] and seen["rows"] == 10
        assert seen["metrics"]["ingest.reject"] == 2

    def test_trim_by_age(self):
        def scenario(P):
            P.cfg.IngestRetentionAgeS.put(1e-9)  # all but the newest batch expire
            feed = P.ingest.create_feed("events", _SCHEMA)
            feed.register_view("scalar", _PLANS["scalar"])
            rng = np.random.default_rng(3)
            for _ in range(4):
                last = _batch(rng, 10)
                feed.append(last)
            value = feed.read("scalar").value
            _assert_answer("scalar", value, _truth("scalar", last.astype(_SCHEMA)))
            return {"rows": feed.rows, "value": value, "frame": _frame(feed)}

        assert _both(scenario)["rows"] == 10

    def test_trim_survives_deferred_folds(self):
        def scenario(P):
            P.cfg.IngestFoldEvery.put(3)
            P.cfg.IngestRetentionRows.put(40)
            feed = P.ingest.create_feed("events", _SCHEMA)
            for v in ("filtered", "topk", "windowed"):
                feed.register_view(v, _PLANS[v])
            rng = np.random.default_rng(4)
            mirror = _empty_mirror(feed)
            for b in range(8):
                batch = _batch(rng, 16, key_start=b * 16)
                feed.append(batch)
                mirror = pandas.concat([mirror, batch], ignore_index=True)
                while len(mirror) > 40:
                    mirror = mirror.iloc[16:].reset_index(drop=True)
            out = {}
            for v in ("filtered", "topk", "windowed"):
                out[v] = feed.read(v, fresh_within_ms=0.0).value  # forces the backlog
                _assert_answer(v, out[v], _truth(v, mirror))
            return out

        _both(scenario)

    def test_keyed_trim_rebuilds_the_key_index(self):
        """A keyed feed's trim rebuilds the key index (the port from the key
        column alone): the same dict as the JAX package's, and a later
        upsert updates the retained rows in place."""
        def scenario(P):
            feed = P.ingest.create_feed("keyed", _SCHEMA, key="k", retention_rows=50)
            for v in ("scalar", "groupby", "topk"):
                feed.register_view(v, _PLANS[v])
            rng = np.random.default_rng(12)
            for b in range(5):
                feed.append(_batch(rng, 20, key_start=20 * b))
            index = dict(feed._key_index)
            up = _batch(rng, 30, key_start=50)  # keys 50-79: 10 trimmed ones come back as new rows
            feed.upsert(up)
            return {"index": index, "rows": feed.rows, "frame": _frame(feed),
                    "views": {v: feed.read(v).value for v in ("scalar", "groupby", "topk")}}

        seen = _both(scenario)
        assert seen["index"] == {k: k - 60 for k in range(60, 100)} and seen["rows"] == 50

    def test_late_rows_fold_into_closed_buckets(self):
        def scenario(P):
            feed = P.ingest.create_feed("events", _SCHEMA)
            view = feed.register_view("windowed", _PLANS["windowed"])
            rows = [(0, 5, 3.0), (1, 7, 55.0), (2, 11, 4.0)]  # the last a straggler
            frames = [pandas.DataFrame({"k": [k], "i": [i], "x": [0.0], "g": [0], "ts": [t]}).astype(_SCHEMA)
                      for k, i, t in rows]
            for b in frames:
                feed.append(b)
            got = feed.read("windowed").value
            _assert_answer("windowed", got, _truth("windowed", pandas.concat(frames, ignore_index=True)))
            return {"value": got, "late_buckets": view.late_buckets}

        assert _both(scenario)["late_buckets"] >= 1


# ====================================================================== #
# refusals and the schema
# ====================================================================== #


_REFUSALS = [
    ({"kind": "scalar", "column": "x", "agg": "median"}, "non_foldable_agg"),
    ({"kind": "scalar", "column": "x", "agg": "var"}, "non_foldable_agg"),
    ({"kind": "groupby", "by": "g", "column": "x", "agg": "nunique"}, "non_foldable_agg"),
    ({"kind": "scalar", "column": "x", "agg": "summ"}, "unknown_agg"),
    ({"kind": "windowed", "column": "x", "agg": "prod", "bucket_s": 5.0, "time_column": "ts"}, "non_foldable_agg"),
    ({"kind": "filtered", "column": "x", "predicate": ("g", ">", 0)}, "row_view_unbounded"),
    ({"kind": "filtered", "column": "x", "agg": "sum", "predicate": ("g", "~", 0)}, "bad_predicate"),
    ({"kind": "topk", "column": "x", "k": 0}, "bad_k"),
    ({"kind": "windowed", "column": "x", "agg": "sum", "bucket_s": 0, "time_column": "ts"}, "bad_window"),
    ({"kind": "windowed", "column": "x", "agg": "sum", "bucket_s": 5.0}, "bad_window"),
    ({"kind": "sorted", "column": "x"}, "unknown_kind"),
    ({"kind": "scalar", "column": "zz", "agg": "sum"}, "unknown_column"),
]


def _outcome(P, feed, batch):
    """What appending ``batch`` did: ("rejected", reason), ("raised",
    exception type) or ("admitted", dtypes)."""
    try:
        feed.append(batch)
    except P.ingest.IngestRejected as err:
        return ("rejected", err.reason)
    except Exception as err:  # the JAX package's bare TypeError on pandas' str dtype
        return ("raised", type(err).__name__)
    return ("admitted", [str(d) for d in feed.frame._to_pandas().dtypes])


class TestRefusalsAndSchema:
    @pytest.mark.parametrize("plan,reason", _REFUSALS)
    def test_typed_refusals(self, plan, reason):
        def scenario(P):
            feed = P.ingest.create_feed("events", _SCHEMA)
            with pytest.raises(P.ingest.ViewNotIncrementalizable) as err:
                feed.register_view("bad", plan)
            return {"reason": err.value.reason, "views": feed.views()}

        seen = _both(scenario)
        assert seen["reason"] == reason and seen["views"] == []
        assert seen["metrics"]["ingest.view.refused"] == 1

    def test_schema_rejections(self):
        ok = _batch(np.random.default_rng(0), 4)
        cases = [
            (ok.drop(columns=["x"]), "missing_column"),
            (ok.assign(extra=1), "extra_column"),
            (ok.assign(i=np.array([1.5, 2.5, 3.5, 4.5])), "dtype"),
            (object(), "unsupported_type"),
            ("", "malformed"),  # the CSV parser's EmptyDataError
            ({"k": [1, 2], "i": [0]}, "malformed"),  # a ragged dict
        ]

        def scenario(P):
            feed = P.ingest.create_feed("events", _SCHEMA)
            feed.append(ok)
            outcomes = [_outcome(P, feed, bad) for bad, _ in cases]
            return {"outcomes": outcomes, "rows": feed.rows}

        seen = _both(scenario)
        assert seen["outcomes"] == [("rejected", reason) for _, reason in cases]
        assert seen["rows"] == 4 and seen["metrics"]["ingest.reject"] == len(cases)

    def test_str_dtype_column_is_a_typed_rejection_on_the_port(self):
        """pandas' ``str`` dtype: the JAX package's ``np.can_cast`` raises a
        bare ``TypeError``; the port rejects it as ``dtype`` against an int
        column, and casts it to ``object`` against an object column."""
        ok = _batch(np.random.default_rng(0), 4)
        bad = ok.assign(i=["a", "b", "c", "d"])
        assert isinstance(bad["i"].dtype, pandas.StringDtype)
        strings = {"k": "int64", "s": "object"}
        sbatch = pandas.DataFrame({"k": np.arange(3, dtype=np.int64), "s": ["a", "b", None]})

        def scenario(P):
            feed = P.ingest.create_feed("events", _SCHEMA)
            feed.append(ok)
            texts = P.ingest.create_feed("texts", strings)
            return {"int_column": _outcome(P, feed, bad), "rows": feed.rows,
                    "object_column": _outcome(P, texts, sbatch), "text_rows": texts.rows}

        jax_seen, port_seen = _run(JAX, scenario), _run(PORT, scenario)
        assert jax_seen["int_column"] == ("raised", "TypeError")
        assert jax_seen["object_column"] == ("raised", "TypeError")
        assert port_seen["int_column"] == ("rejected", "dtype")
        assert port_seen["object_column"] == ("admitted", ["int64", "object"])
        assert (jax_seen["rows"], port_seen["rows"], jax_seen["text_rows"], port_seen["text_rows"]) == (4, 4, 0, 3)
        assert port_seen["metrics"]["ingest.reject"] == 1 and jax_seen["metrics"]["ingest.reject"] == 0
        got = PORT.ingest.get_feed("texts").frame._to_pandas()["s"]
        assert got.tolist()[:2] == ["a", "b"] and got.isna().tolist() == [False, False, True]

    def test_safe_casts_accepted(self):
        def scenario(P):
            feed = P.ingest.create_feed("events", _SCHEMA)
            batch = _batch(np.random.default_rng(0), 3)
            batch["x"] = batch["x"].astype(np.float32)  # float32 -> float64
            batch["g"] = batch["g"].astype(np.int32)  # int32 -> int64
            feed.append(batch)
            return {"frame": _frame(feed)}

        assert _both(scenario)["frame"]["x"].dtype == np.float64

    def test_csv_and_dict_batches(self):
        def scenario(P):
            feed = P.ingest.create_feed("events", _SCHEMA)
            feed.register_view("s", _PLANS["scalar"])
            feed.append("k,i,x,g,ts\n1,10,0.5,2,3.0\n2,-4,1.5,0,8.0\n")
            feed.append({"k": [3], "i": [7], "x": [2.5], "g": [1], "ts": [11.0]})
            return {"rows": feed.rows, "value": feed.read("s").value, "frame": _frame(feed)}

        seen = _both(scenario)
        assert seen["rows"] == 3 and seen["value"] == 10 - 4 + 7

    def test_create_feed_duplicate_and_lookup(self):
        def scenario(P):
            feed = P.ingest.create_feed("events", _SCHEMA)
            with pytest.raises(P.ingest.IngestError):
                P.ingest.create_feed("events", _SCHEMA)
            assert P.ingest.get_feed("events") is feed
            listed = P.ingest.feeds()
            P.ingest.drop_feed("events")
            with pytest.raises(P.ingest.IngestError):
                P.ingest.get_feed("events")
            return {"listed": listed, "after": P.ingest.feeds()}

        assert _both(scenario) == {"listed": ["events"], "after": [], "metrics": collections.Counter()}


# ====================================================================== #
# staleness and the serving gate
# ====================================================================== #


class TestStaleness:
    def test_deferred_fold_creates_lag_and_bound_forces_fold(self):
        def scenario(P):
            P.cfg.IngestFoldEvery.put(1000)  # never fold on append
            feed = P.ingest.create_feed("events", _SCHEMA)
            feed.register_view("s", _PLANS["scalar"])
            rng = np.random.default_rng(5)
            full = []
            for _ in range(3):
                b = _batch(rng, 8)
                feed.append(b)
                full.append(b)
            full = pandas.concat(full, ignore_index=True)
            lag = feed.fold_lag_ms()
            served = feed.read("s", fresh_within_ms=1e12)
            forced = feed.read("s", fresh_within_ms=0.0)
            _assert_answer("scalar", forced.value, _truth("scalar", full))
            return {"lagging": lag > 0.0, "served": (served.forced, served.covered_rows),
                    "forced": (forced.forced, forced.covered_rows, forced.value, forced.lag_ms),
                    "lag_after": feed.fold_lag_ms()}

        seen = _both(scenario)
        assert seen["lagging"] and seen["served"] == (False, 0) and seen["forced"][:2] == (True, 24)
        assert seen["lag_after"] == 0.0
        assert seen["metrics"]["ingest.read.forced_fold"] == 1 and seen["metrics"]["ingest.read.served"] == 1

    def test_reads_and_ingest_ride_the_admission_gate(self):
        def scenario(P):
            P.cfg.ServingEnabled.put(True)
            feed = P.ingest.create_feed("events", _SCHEMA)
            feed.register_view("s", _PLANS["scalar"])
            b = _batch(np.random.default_rng(6), 12)
            feed.append(b, tenant="ingestor")
            read = feed.read("s", tenant="reader")
            _assert_answer("scalar", read.value, _truth("scalar", b.astype(_SCHEMA)))
            tenants = importlib.import_module(f"{P.prefix}serving.gate").serving_snapshot()["tenants"]
            return {"value": read.value, "tenants": sorted(t for t in tenants if t in ("ingestor", "reader"))}

        assert _both(scenario)["tenants"] == ["ingestor", "reader"]


# ====================================================================== #
# chaos
# ====================================================================== #


class TestChaos:
    def test_device_lost_during_ingest_concat(self):
        kinds = ("filtered", "topk", "windowed")

        def scenario(P):
            feed = P.ingest.create_feed("events", _SCHEMA)
            for v in kinds:
                feed.register_view(v, _PLANS[v])
            rng = np.random.default_rng(7)
            b = _batch(rng, 16)
            feed.append(b)
            tail = _batch(rng, 16, key_start=16)
            # the append's concat dispatch dies mid-flight; the recovery
            # re-seats and the retry lands the batch once
            with P.faults.midquery_device_loss(after_deploys=0, times=1) as inj:
                feed.append(tail)
            full = pandas.concat([b, tail], ignore_index=True).astype(_SCHEMA)
            out = {v: feed.read(v).value for v in kinds}
            for v in kinds:
                _assert_answer(v, out[v], _truth(v, full))
            out["frame"] = _frame(feed)
            pandas.testing.assert_frame_equal(out["frame"], full)
            out["injected"] = inj.injected
            return out

        assert _both(scenario)["injected"] == 1

    def test_ledger_pressure_drop_leaves_views_exact(self):
        kinds = ("filtered", "topk", "windowed")

        def scenario(P):
            feed = P.ingest.create_feed("events", _SCHEMA)
            for v in kinds:
                feed.register_view(v, _PLANS[v])
            rng = np.random.default_rng(8)
            full = []
            for _ in range(3):
                b = _batch(rng, 16)
                feed.append(b)
                full.append(b)
            full = pandas.concat(full, ignore_index=True)
            feed.frame.sum()  # artifacts on the frame
            P.memory.device_ledger.spill_lru(1)  # pressure: derived artifacts drop first
            out = {v: feed.read(v).value for v in kinds}
            for v in kinds:
                _assert_answer(v, out[v], _truth(v, full))
            out["sum"] = feed.frame.sum()._to_pandas()
            pandas.testing.assert_series_equal(out["sum"], full.sum())
            return out

        _both(scenario)


# ====================================================================== #
# the views registry's append chains under micro-batches (the port's)
# ====================================================================== #


class _FakeCol:
    """A column as the views registry sees it: 1k chained appends without
    1k device concats."""

    def __init__(self, length):
        self._view_token = None
        self._view_parent = None
        self._data = torch.zeros(1)
        self.length = length
        self.is_lazy = False


class TestChainBound:
    def test_lookup_cost_flat_across_1k_appends(self):
        col = _FakeCol(10)
        t_registry.store(col, "reduce", ("sum",), {"v": 0}, can_fold=True)
        per_block = []
        for block in range(10):
            before = t_registry.walk_stats()
            for a in range(100):
                child = _FakeCol(col.length + 1)
                t_registry.note_append(child, col)
                col = child
                if a % 10 == 9:
                    outcome, _state, _base = t_registry.lookup(col, "reduce", ("sum",))
                    assert outcome == "fold", (block, a, outcome)
                    t_registry.store(col, "reduce", ("sum",), {"v": 0}, can_fold=True, folded=True)
            after = t_registry.walk_stats()
            per_block.append((after["hops"] - before["hops"]) / (after["lookups"] - before["lookups"]))
        assert per_block[-1] <= per_block[0] + 1.0, per_block
        assert max(per_block) <= 10.0, per_block

    def test_fold_resolves_past_old_eight_hop_horizon(self):
        root = _FakeCol(10)
        t_registry.store(root, "reduce", ("sum",), {"v": 1}, can_fold=True)
        col = root
        for _ in range(30):
            child = _FakeCol(col.length + 1)
            t_registry.note_append(child, col)
            col = child
        outcome, state, base = t_registry.lookup(col, "reduce", ("sum",))
        assert outcome == "fold" and base == root.length and state == {"v": 1}

    def test_compaction_respects_max_chain(self):
        seen = []
        handler = lambda name, value: seen.append(name)  # noqa: E731
        t_add(handler)
        try:
            tcfg.ViewsMaxChain.put(4)
            col = _FakeCol(10)
            for _ in range(12):
                child = _FakeCol(col.length + 1)
                t_registry.note_append(child, col)
                col = child
        finally:
            t_clear(handler)
        assert seen.count("modin_tpu_torch.view.chain_compact") >= 1
        assert t_registry.walk_stats()["compactions"] >= 1

    def test_real_frame_appends_stay_foldable(self):
        def scenario(P):
            pdf = pandas.DataFrame({"a": np.arange(64, dtype=np.int64)})
            mdf = P.pd.DataFrame(pdf)
            mdf.sum()
            sums = []
            for i in range(30):
                tail = pandas.DataFrame({"a": np.arange(4, dtype=np.int64) + i})
                mdf = P.pd.concat([mdf, P.pd.DataFrame(tail)], ignore_index=True)
                pdf = pandas.concat([pdf, tail], ignore_index=True)
                sums.append(mdf.sum()["a"])
                assert sums[-1] == pdf["a"].sum()
            stats = P.registry.walk_stats()
            assert stats["hops"] <= stats["lookups"] * 3
            return {"sums": sums}

        _both(scenario)


# ====================================================================== #
# the ingest-off contract and the settings
# ====================================================================== #


class TestOffContract:
    def test_ingest_off_zero_alloc_over_real_workload(self):
        def scenario(P):
            P.cfg.IngestEnabled.put(False)
            before = P.ingest.ingest_alloc_count()
            pdf = pandas.DataFrame({"a": np.arange(200, dtype=np.int64),
                                    "b": np.random.default_rng(0).normal(size=200)})
            mdf = P.pd.DataFrame(pdf)
            s1 = mdf.sum()._to_pandas()
            mdf2 = P.pd.concat([mdf, P.pd.DataFrame(pdf)], ignore_index=True)
            s2 = mdf2.sum()._to_pandas()
            pandas.testing.assert_series_equal(s2, pandas.concat([pdf, pdf], ignore_index=True).sum())
            with pytest.raises(P.ingest.IngestError):
                P.ingest.create_feed("nope", {"a": "int64"})
            return {"sums": (s1, s2), "allocated": P.ingest.ingest_alloc_count() - before}

        assert _both(scenario)["allocated"] == 0

    def test_knob_validation(self):
        for P in PACKAGES:
            for knob, bad in (("IngestFoldEvery", 0), ("IngestRetentionRows", -1), ("ViewsMaxChain", 0),
                              ("IngestRetentionAgeS", -1.0), ("IngestFoldLagMs", 0.0)):
                with pytest.raises(ValueError):
                    getattr(P.cfg, knob).put(bad)
        assert tcfg.IngestEnabled.varname == "MODIN_TPU_TORCH_INGEST"


# ====================================================================== #
# threads: appends and reads under serving and strict lockdep (the port's)
# ====================================================================== #


def test_threaded_appends_and_reads_under_strict_lockdep():
    """Four threads append and read one feed through the serving gate with
    lockdep strict: no violation, the views exact against pandas, and the
    ingest edges observed."""
    import threading

    tcfg.ServingEnabled.put(True)
    feed = t_ingest.create_feed("events", _SCHEMA)
    for v in ("scalar", "groupby", "filtered"):
        feed.register_view(v, _PLANS[v])
    batches = [_batch(np.random.default_rng(100 + b), 32, key_start=32 * b) for b in range(16)]
    errors = []

    def worker(t):
        try:
            for b in range(t, len(batches), 4):
                feed.append(batches[b], tenant=f"t{t}")
                feed.read("scalar", tenant=f"t{t}")
                t_ingest.max_fold_lag_ms()
        except Exception as err:  # pragma: no cover - reported below
            errors.append(err)

    t_lockdep.enable(strict=True)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        violations = t_lockdep.violations()
        edges = t_lockdep.observed_edges()
    finally:
        t_lockdep.disable()
        from modin_tpu_torch.serving import gate, tenants

        gate.gate.reset_for_tests()
        tenants.registry.reset()
    assert not errors and not violations, (errors, [v.render() for v in violations])
    assert {("ingest.feeds", "ingest.feed"), ("ingest.feed", "views.registry"),
            ("ingest.feed", "resilience.dispatch")} <= set(edges)
    full = _frame(feed).sort_values("k").reset_index(drop=True)
    want = pandas.concat(batches, ignore_index=True).astype(_SCHEMA)
    pandas.testing.assert_frame_equal(full, want)
    for v in ("scalar", "groupby", "filtered"):
        _assert_answer(v, feed.read(v).value, _truth(v, want))
