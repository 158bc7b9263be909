"""Out-of-core streaming in the torch port (``modin_tpu_torch/streaming/``).

The counterpart of ``tests/test_streaming.py``, its four classes:

1. the pipeline grid: CSV scan -> filter -> reduce/groupby with the window
   loop forced (``StreamMode`` Windowed, a 4 KB window, so every frame
   streams in many windows), held to pandas, to the port's resident path
   and to the JAX package's own streamed path on the CPU mesh: a ragged
   last window, an all-NaN window, a window ending exactly on a record
   boundary, windows a filter leaves empty, ``sort=False``, a series
   groupby, ``dropna=False`` and the ``StreamMaxGroups`` degrade;
2. the external sort and merge-join across the dtype, direction, tie, NaN
   and miss grids, held to the resident device paths, pandas and the JAX
   package's external kernels;
3. chaos: ``midquery_device_loss`` and ``oom_burst_until_eviction``
   mid-stream give the exact answer, the seams re-seating far fewer
   columns than a whole-dataset replay would; with the card's legs
   (``resilience._on_card`` patched true) a loss the seams cannot absorb
   replays exactly one window; the window loop's own replay legs;
4. routing and accounting: ``decide_residency``'s pins and Auto arm
   against the JAX router, the window sizing, the ``QueryStats`` fields,
   EXPLAIN's windowed residency with its staged compile leg and no
   donation, the optimizer's ``ledger_pressure`` consult, and with no
   budget every hook resident.

The kernels' plain versions run here.  Tolerance: the data are integers
and halves, whose sums, means and products are exact in float64 whatever
the order, so every comparison is exact (``check_exact``).
"""

import contextlib
import gc
import threading

import numpy as np
import pandas
import pytest

import modin_tpu.pandas as mpd
from modin_tpu.config import StreamMode as JaxStreamMode
from modin_tpu.config import StreamWindowBytes as JaxStreamWindowBytes
from modin_tpu.utils import to_pandas as jax_to_pandas

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch.config import (
    DeviceMemoryBudget,
    FuseMode,
    PlanScanCacheBytes,
    ResilienceBackoffS,
    StreamMaxGroups,
    StreamMode,
    StreamPrefetch,
    StreamWindowBytes,
)
from modin_tpu_torch.core import memory
from modin_tpu_torch.core.execution import resilience as tres
from modin_tpu_torch.core.execution.torch_engine.io import TorchCSVDispatcher
from modin_tpu_torch.logging import metrics as tmetrics
from modin_tpu_torch.ops import router
from modin_tpu_torch.streaming import executor, external
from modin_tpu_torch.streaming import windows as stream_windows

WINDOW_BYTES = 4096


@pytest.fixture(autouse=True)
def _cpu_device():
    modin_tpu_torch.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _join_jax_watchdog_threads():
    yield
    for t in threading.enumerate():
        if t.name.startswith("modin-tpu-watchdog"):
            t.join(timeout=5)


@pytest.fixture
def metric_counts():
    """Every metric the port emits during the test, summed by name."""
    seen = {}

    def handler(name, value):
        key = name.replace("modin_tpu_torch.", "", 1)
        seen[key] = seen.get(key, 0) + value

    tmetrics.add_metric_handler(handler)
    yield seen
    tmetrics.clear_metric_handler(handler)


@pytest.fixture
def windowed():
    """The window loop forced at a small window: every test frame streams
    in many windows without a large file."""
    with StreamMode.context("Windowed"), StreamWindowBytes.context(WINDOW_BYTES):
        yield


def _jax_streamed(fn):
    """``fn(modin_tpu.pandas)`` through the JAX package's window loop."""
    with JaxStreamMode.context("Windowed"), JaxStreamWindowBytes.context(WINDOW_BYTES):
        return jax_to_pandas(fn(mpd))


def _resident(fn):
    with StreamMode.context("Resident"):
        return tpd.to_pandas(fn(tpd))


def _same(got, want):
    if isinstance(want, pandas.DataFrame):
        pandas.testing.assert_frame_equal(got, want, check_exact=True)
    else:
        pandas.testing.assert_series_equal(got, want, check_exact=True)


def _csv(tmp_path, df, name="stream.csv"):
    path = tmp_path / name
    df.to_csv(path, index=False)
    return str(path)


def _base_df(n=12000, nan_block=False, seed=5):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 1000, n).astype(np.float64) * 0.5
    if nan_block:
        # a NaN run wide enough to cover whole 4 KB windows
        v[2000:6000] = np.nan
    return pandas.DataFrame({"k": rng.integers(0, 20, n), "a": rng.integers(-50, 50, n), "v": v})


def _check_pipeline(path, query, want):
    """The port's streamed answer equals pandas', the port's resident one
    and the JAX package's streamed one."""
    got = tpd.to_pandas(query(tpd, path))
    _same(got, want)
    _same(got, _resident(lambda pd: query(pd, path)))
    _same(got, _jax_streamed(lambda pd: query(pd, path)))
    return got


# ---------------------------------------------------------------------- #
# 1. the pipeline grid
# ---------------------------------------------------------------------- #


class TestStreamedPipelines:
    @pytest.mark.parametrize("agg", ["sum", "mean", "min", "max", "count"])
    def test_filter_groupby_exact_and_streamed(self, tmp_path, windowed, metric_counts, agg):
        df = _base_df()
        path = _csv(tmp_path, df)

        def query(pd, p):
            m = pd.read_csv(p)
            return getattr(m[m["a"] > 0].groupby("k"), agg)()

        _check_pipeline(path, query, getattr(df[df["a"] > 0].groupby("k"), agg)())
        assert metric_counts.get("stream.window.count", 0) > 1

    @pytest.mark.parametrize("agg", ["sum", "mean", "min", "max", "count", "prod"])
    def test_filter_reduce_exact(self, tmp_path, windowed, metric_counts, agg):
        df = _base_df()
        path = _csv(tmp_path, df)

        def query(pd, p):
            m = pd.read_csv(p)
            return getattr(m[m["a"] > 0][["v", "a"]], agg)()

        with np.errstate(over="ignore", invalid="ignore"):
            _check_pipeline(path, query, getattr(df[df["a"] > 0][["v", "a"]], agg)())
        assert metric_counts.get("stream.window.count", 0) > 1

    def test_windowed_meets_resident(self, tmp_path, metric_counts):
        df = _base_df()
        path = _csv(tmp_path, df)

        def run():
            m = tpd.read_csv(path)
            return tpd.to_pandas(m[m["a"] > 0].groupby("k").sum())

        with StreamMode.context("Resident"):
            resident = run()
        assert metric_counts.get("stream.window.count", 0) == 0
        with StreamMode.context("Windowed"), StreamWindowBytes.context(WINDOW_BYTES):
            streamed = run()
        assert metric_counts.get("stream.window.count", 0) > 1
        _same(streamed, resident)

    def test_all_nan_window(self, tmp_path, windowed):
        df = _base_df(nan_block=True)
        path = _csv(tmp_path, df)
        for agg in ("sum", "mean", "min"):
            _check_pipeline(path, lambda pd, p: getattr(pd.read_csv(p)[["v"]], agg)(), getattr(df[["v"]], agg)())
        _check_pipeline(path, lambda pd, p: pd.read_csv(p).groupby("k").min(), df.groupby("k").min())

    def test_skipna_false_with_nans(self, tmp_path, windowed):
        df = _base_df(nan_block=True)
        path = _csv(tmp_path, df)
        for agg in ("sum", "mean", "min", "max"):
            got = tpd.to_pandas(getattr(tpd.read_csv(path)[["v", "a"]], agg)(skipna=False))
            _same(got, getattr(df[["v", "a"]], agg)(skipna=False))

    def test_exact_window_boundary(self, tmp_path, metric_counts):
        # fixed-width records of exactly 10 bytes: a 400-record window
        # target ends precisely on a record boundary
        n = 4000
        rng = np.random.default_rng(3)
        k = rng.integers(0, 9, n)
        v = rng.integers(0, 9999, n)
        path = tmp_path / "fixed.csv"
        with open(path, "w") as f:
            f.write("k,v\n")
            for ki, vi in zip(k, v):
                f.write(f"{ki:04d},{vi:04d}\n")
        df = pandas.read_csv(path)
        with StreamMode.context("Windowed"), StreamWindowBytes.context(10 * 400):
            got = tpd.to_pandas(tpd.read_csv(str(path)).groupby("k").sum())
        _same(got, df.groupby("k").sum())
        assert metric_counts.get("stream.window.count", 0) == (n + 399) // 400

    def test_ragged_final_window(self, tmp_path, windowed, metric_counts):
        # a prime row count: the last byte window is ragged
        df = _base_df(n=10007)
        path = _csv(tmp_path, df)
        _check_pipeline(path, lambda pd, p: pd.read_csv(p).groupby("k").count(), df.groupby("k").count())
        assert metric_counts.get("stream.window.count", 0) > 1

    def test_sparse_filter_empty_windows(self, tmp_path, windowed):
        df = _base_df()
        path = _csv(tmp_path, df)

        def query(pd, p):
            m = pd.read_csv(p)
            return m[m["a"] > 48].groupby("k").sum()

        _check_pipeline(path, query, df[df["a"] > 48].groupby("k").sum())

    def test_sort_false_and_series_groupby(self, tmp_path, windowed):
        df = _base_df()
        path = _csv(tmp_path, df)
        _check_pipeline(path, lambda pd, p: pd.read_csv(p).groupby("k", sort=False)["v"].sum(),
                        df.groupby("k", sort=False)["v"].sum())

    def test_groupby_dropna_false_nan_keys(self, tmp_path, windowed):
        df = _base_df()
        df["k"] = df["k"].astype(np.float64)
        df.loc[df.index % 7 == 0, "k"] = np.nan
        path = _csv(tmp_path, df)
        _check_pipeline(path, lambda pd, p: pd.read_csv(p).groupby("k", dropna=False).sum(),
                        df.groupby("k", dropna=False).sum())

    def test_projection_prunes_per_window(self, tmp_path, windowed, metric_counts):
        df = _base_df()
        path = _csv(tmp_path, df)

        def query(pd, p):
            m = pd.read_csv(p)
            return m[m["a"] > 0][["v"]].sum()

        _check_pipeline(path, query, df[df["a"] > 0][["v"]].sum())
        # the pushed projection: k is never parsed, in any window
        with StreamPrefetch.context(0):
            source = stream_windows.WindowSource(
                TorchCSVDispatcher, {"filepath_or_buffer": path, "usecols": ["a", "v"]}, WINDOW_BYTES
            )
            with source:
                window = source.parse_window(0)
            assert list(window._modin_frame.columns) == ["a", "v"]
            stream_windows.release_qc(window)

    def test_max_groups_degrades_to_resident(self, tmp_path, windowed, metric_counts):
        df = _base_df()
        path = _csv(tmp_path, df)
        with StreamMaxGroups.context(5):  # 20 real groups pass it
            got = tpd.to_pandas(tpd.read_csv(path).groupby("k").sum())
        _same(got, df.groupby("k").sum())
        assert metric_counts.get("stream.degrade", 0) >= 1

    def test_serial_prefetch_zero(self, tmp_path, metric_counts):
        df = _base_df()
        path = _csv(tmp_path, df)
        with StreamMode.context("Windowed"), StreamWindowBytes.context(WINDOW_BYTES), StreamPrefetch.context(0):
            got = tpd.to_pandas(tpd.read_csv(path).groupby("k").sum())
        _same(got, df.groupby("k").sum())
        assert metric_counts.get("stream.window.count", 0) > 1
        assert metric_counts.get("stream.prefetch.overlap_s", 0) == 0

    def test_windows_release_device_memory(self, tmp_path, windowed):
        df = _base_df()
        path = _csv(tmp_path, df)
        before = memory.device_ledger.total_bytes()
        got = tpd.to_pandas(tpd.read_csv(path).groupby("k").sum())
        assert len(got) == 20
        # only the small result may stay resident: the dead windows were
        # deregistered as each was consumed, not left to the collector
        assert memory.device_ledger.total_bytes() - before < 1 << 17

    def test_unsupported_agg_stays_resident(self, tmp_path, windowed, metric_counts):
        df = _base_df()
        path = _csv(tmp_path, df)
        got = tpd.to_pandas(tpd.read_csv(path)[["v"]].median())
        _same(got, df[["v"]].median())
        assert metric_counts.get("stream.window.count", 0) == 0


# ---------------------------------------------------------------------- #
# 2. external sort and merge-join
# ---------------------------------------------------------------------- #


def _sort_frame(n=9000, key_dtype="float"):
    rng = np.random.default_rng(11)
    if key_dtype == "float":
        key = rng.integers(0, 300, n).astype(np.float64) * 0.5
        key[rng.random(n) < 0.04] = np.nan
    else:
        key = rng.integers(-500, 500, n)
    return pandas.DataFrame({"key": key, "pay": rng.integers(0, 1000, n),
                             "w": rng.integers(0, 50, n).astype(np.float64)})


def _check_external(df_or_pair, op, want):
    """The port's external answer equals the port's resident one, pandas'
    and the JAX package's external one."""
    port = tuple(tpd.DataFrame(d) for d in df_or_pair)
    jax = tuple(mpd.DataFrame(d) for d in df_or_pair)
    got = tpd.to_pandas(op(*port))
    with StreamMode.context("Resident"):
        resident = tpd.to_pandas(op(*port))
    _same(got, resident)
    _same(got, want)
    with JaxStreamMode.context("Windowed"), JaxStreamWindowBytes.context(WINDOW_BYTES):
        _same(got, jax_to_pandas(op(*jax)))
    return got


class TestExternalKernels:
    @pytest.mark.parametrize("key_dtype", ["float", "int"])
    @pytest.mark.parametrize("ascending", [True, False])
    def test_external_sort_exact(self, windowed, metric_counts, key_dtype, ascending):
        df = _sort_frame(key_dtype=key_dtype)
        got = _check_external((df,), lambda d: d.sort_values("key", ascending=ascending),
                              df.sort_values("key", ascending=ascending, kind="stable"))
        assert metric_counts.get("stream.window.count", 0) > 1
        assert metric_counts.get("stream.spill.run_bytes", 0) > 0
        assert len(got) == len(df)

    def test_merge_keys_and_run_fold_equal_the_reference(self):
        """The host mirror of the device comparator and the k-way fold give
        the JAX package's keys and order (the fold by one stable sort, the
        reference's by a tree of searchsorted passes)."""
        from modin_tpu.streaming import external as jax_external

        rng = np.random.default_rng(21)
        floats = np.concatenate([rng.standard_normal(500), [0.0, -0.0, np.inf, -np.inf, np.nan, np.nan]])
        for vals in (floats, floats.astype(np.float32), rng.integers(-9, 9, 500), rng.random(500) < 0.5):
            for ascending in (True, False):
                got = external._merge_key(vals, ascending)
                np.testing.assert_array_equal(got, jax_external._merge_key(vals, ascending))
        keys = rng.integers(0, 50, 3000)
        runs = []
        for start in range(0, 3000, 700):
            window = keys[start:start + 700]
            order = np.argsort(window, kind="stable")
            runs.append((window[order], start + order))
        got_keys, got_ids = external._fold_runs(list(runs))
        want_keys, want_ids = jax_external._fold_runs(list(runs))
        np.testing.assert_array_equal(got_keys, want_keys)
        np.testing.assert_array_equal(got_ids, want_ids)
        np.testing.assert_array_equal(got_ids, np.argsort(keys, kind="stable"))

    def test_external_sort_output_is_born_spilled(self, windowed):
        df = _sort_frame(key_dtype="int")
        md = tpd.DataFrame(df)
        before = memory.device_ledger.total_bytes()
        out = md.sort_values("key")
        frame = out._query_compiler._modin_frame
        assert all(c.is_spilled for c in frame._columns)
        assert memory.device_ledger.total_bytes() == before
        # a device consumer restores the column it reads, exactly
        assert int(out["pay"].sum()) == int(df["pay"].sum())

    def test_external_sort_ignore_index(self, windowed):
        df = _sort_frame(key_dtype="int")
        _check_external((df,), lambda d: d.sort_values("key", ignore_index=True),
                        df.sort_values("key", kind="stable", ignore_index=True))

    def test_external_sort_heavy_ties_stable(self, windowed):
        rng = np.random.default_rng(2)
        df = pandas.DataFrame({"key": rng.integers(0, 3, 8000), "pay": np.arange(8000)})
        _check_external((df,), lambda d: d.sort_values("key"), df.sort_values("key", kind="stable"))

    def test_multikey_declines_to_resident(self, windowed, metric_counts):
        df = _sort_frame(key_dtype="int")
        got = tpd.to_pandas(tpd.DataFrame(df).sort_values(["key", "pay"]))
        _same(got, df.sort_values(["key", "pay"], kind="stable"))
        assert metric_counts.get("stream.window.count", 0) == 0

    @pytest.mark.parametrize("how", ["inner", "left"])
    def test_external_merge_exact(self, windowed, metric_counts, how):
        rng = np.random.default_rng(4)
        left = pandas.DataFrame({"k": rng.integers(0, 150, 9000), "lv": rng.integers(0, 100, 9000)})
        right = pandas.DataFrame({"k": rng.integers(0, 150, 3000), "rv": rng.integers(0, 100, 3000)})
        _check_external((left, right), lambda a, b: a.merge(b, on="k", how=how), left.merge(right, on="k", how=how))
        assert metric_counts.get("stream.window.count", 0) > 1

    def test_external_left_merge_misses_promote(self, windowed):
        rng = np.random.default_rng(6)
        left = pandas.DataFrame({"k": rng.integers(0, 200, 8000), "lv": rng.integers(0, 9, 8000)})
        right = pandas.DataFrame({"k": rng.integers(0, 40, 2500), "rv": rng.integers(0, 9, 2500)})
        got = _check_external((left, right), lambda a, b: a.merge(b, on="k", how="left"),
                              left.merge(right, on="k", how="left"))
        assert got["rv"].dtype == np.float64  # the misses promote, as in pandas

    def test_external_merge_nan_keys_match(self, windowed):
        rng = np.random.default_rng(8)
        lk = rng.integers(0, 60, 7000).astype(np.float64)
        lk[rng.random(7000) < 0.03] = np.nan
        rk = rng.integers(0, 60, 2000).astype(np.float64)
        rk[rng.random(2000) < 0.03] = np.nan
        left = pandas.DataFrame({"k": lk, "lv": np.arange(7000)})
        right = pandas.DataFrame({"k": rk, "rv": np.arange(2000)})
        _check_external((left, right), lambda a, b: a.merge(b, on="k", how="inner"),
                        left.merge(right, on="k", how="inner"))

    def test_external_merge_preserves_string_dtype(self, windowed):
        rng = np.random.default_rng(12)
        left = pandas.DataFrame({"k": rng.integers(0, 60, 7000), "lv": rng.integers(0, 9, 7000)})
        right = pandas.DataFrame({
            "k": rng.integers(0, 60, 2500),
            "tag": pandas.array(rng.choice(["x", "y", "z"], 2500), dtype="string"),
        })
        ml, mr = tpd.DataFrame(left), tpd.DataFrame(right)
        with StreamMode.context("Resident"):
            resident = tpd.to_pandas(ml.merge(mr, on="k", how="inner"))
        streamed = tpd.to_pandas(ml.merge(mr, on="k", how="inner"))
        # the resident path's dtype, the string column included
        _same(streamed, resident)
        pandas.testing.assert_frame_equal(streamed, left.merge(right, on="k", how="inner"), check_dtype=False)

    def test_external_merge_empty_result(self, windowed):
        left = pandas.DataFrame({"k": np.arange(6000), "lv": np.arange(6000)})
        right = pandas.DataFrame({"k": np.arange(6000) + 10_000_000, "rv": np.arange(6000)})
        _check_external((left, right), lambda a, b: a.merge(b, on="k", how="inner"),
                        left.merge(right, on="k", how="inner"))


# ---------------------------------------------------------------------- #
# 3. chaos
# ---------------------------------------------------------------------- #


def _filtered_groupby_sum(path):
    m = tpd.read_csv(path)
    return tpd.to_pandas(m[m["a"] > 0].groupby("k").sum())


class TestChaos:
    def test_midquery_device_loss_reseats_a_window_not_the_dataset(self, tmp_path, windowed, metric_counts):
        from modin_tpu_torch.testing.faults import midquery_device_loss

        df = _base_df(16000)
        path = _csv(tmp_path, df)
        with ResilienceBackoffS.context(0.0), midquery_device_loss(after_deploys=8, times=1) as inj:
            got = _filtered_groupby_sum(path)
        _same(got, df[df["a"] > 0].groupby("k").sum())
        assert inj.injected == 1
        assert metric_counts.get("recovery.device_lost", 0) >= 1
        windows = metric_counts.get("stream.window.count", 0)
        assert windows > 10
        # the live window's columns (and the prefetched one's) re-seated: a
        # whole-dataset replay would re-seat a column a window a source column
        reseats = sum(v for k, v in metric_counts.items() if k.startswith("recovery.reseat."))
        assert 1 <= reseats < windows

    def test_oom_burst_mid_stream_absorbed(self, tmp_path, windowed, metric_counts):
        from modin_tpu_torch.testing.faults import oom_burst_until_eviction

        df = _base_df(16000)
        path = _csv(tmp_path, df)
        with ResilienceBackoffS.context(0.0), oom_burst_until_eviction(spills=1) as inj:
            got = _filtered_groupby_sum(path)
        _same(got, df[df["a"] > 0].groupby("k").sum())
        assert inj.injected >= 1
        assert metric_counts.get("memory.device.spill", 0) >= 1
        assert metric_counts.get("stream.window.count", 0) > 10
        assert metric_counts.get("stream.window.replay", 0) == 0

    def test_unabsorbed_loss_on_the_card_replays_one_window(self, tmp_path, windowed, metric_counts, monkeypatch):
        """The card's legs: a loss that outlasts the seam's re-seat and the
        deploy's rebind raises (no pandas answer on the card), and the
        window loop replays that one window from its byte range."""
        from modin_tpu_torch.testing.faults import midquery_device_loss

        monkeypatch.setattr(tres, "_on_card", lambda qc, args, kwargs: True)
        df = _base_df(16000)
        path = _csv(tmp_path, df)
        fallbacks = tres.fallback_count()
        try:
            with ResilienceBackoffS.context(0.0), midquery_device_loss(after_deploys=8, times=6) as inj:
                got = _filtered_groupby_sum(path)
        finally:
            tres.reset_breakers()
        _same(got, df[df["a"] > 0].groupby("k").sum())
        assert inj.injected == 6
        assert metric_counts.get("stream.window.replay", 0) == 1
        assert tres.fallback_count() == fallbacks

    def test_terminal_consume_failure_replays_one_window(self, tmp_path, windowed, metric_counts):
        from modin_tpu_torch.core.execution.resilience import DeviceLost

        path = _csv(tmp_path, _base_df(8000))
        failed, consumed = [], []

        def consume(index, qc):
            if index == 2 and not failed:
                failed.append(True)
                raise DeviceLost("injected loss mid-window")
            consumed.append(index)

        with stream_windows.WindowSource(TorchCSVDispatcher, {"filepath_or_buffer": path}, 2048) as source:
            assert len(source) > 3
            executor.window_loop(source, consume)
            n = len(source)
        assert sorted(consumed) == list(range(n))
        assert metric_counts.get("stream.window.replay", 0) == 1
        assert metric_counts.get("stream.window.count", 0) == n

    def test_terminal_prefetch_failure_finishes_serially(self, tmp_path, windowed, metric_counts, monkeypatch):
        from modin_tpu_torch.core.execution.resilience import DeviceLost

        path = _csv(tmp_path, _base_df(8000))
        with stream_windows.WindowSource(TorchCSVDispatcher, {"filepath_or_buffer": path}, 2048) as source:
            real_parse = source.parse_window
            failed = []

            def flaky_parse(index):
                if index == 3 and not failed:
                    failed.append(True)
                    raise DeviceLost("injected loss while prefetching")
                return real_parse(index)

            monkeypatch.setattr(source, "parse_window", flaky_parse)
            consumed = []
            executor.window_loop(source, lambda i, qc: consumed.append(i))
            n = len(source)
        assert sorted(consumed) == list(range(n))
        assert metric_counts.get("stream.window.replay", 0) == 1

    def test_mid_consume_replay_does_not_double_count(self, tmp_path, windowed, metric_counts, monkeypatch):
        """A loss after a window's sum partial landed and before its count
        partial replays the window; the partials are keyed by window, so
        the replay overwrites them and the mean stays exact."""
        import modin_tpu_torch.core.storage_formats.torch.query_compiler as qcmod
        from modin_tpu_torch.core.execution.resilience import DeviceLost

        df = _base_df(8000)
        path = _csv(tmp_path, df)
        orig = qcmod.TorchQueryCompiler.groupby_agg
        state = {"tripped": False}

        def flaky(self, by, agg_func, *args, **kwargs):
            result = orig(self, by, agg_func, *args, **kwargs)
            if agg_func == "count" and not state["tripped"]:
                state["tripped"] = True
                raise DeviceLost("injected after the window's sum partial landed")
            return result

        monkeypatch.setattr(qcmod.TorchQueryCompiler, "groupby_agg", flaky)
        got = tpd.to_pandas(tpd.read_csv(path).groupby("k").mean())
        _same(got, df.groupby("k").mean())
        assert state["tripped"]
        assert metric_counts.get("stream.window.replay", 0) == 1

    def test_non_device_errors_propagate(self, tmp_path, windowed):
        path = _csv(tmp_path, _base_df(6000))

        def consume(index, qc):
            if index == 1:
                raise ValueError("not a device problem")

        with stream_windows.WindowSource(TorchCSVDispatcher, {"filepath_or_buffer": path}, 2048) as source:
            with pytest.raises(ValueError, match="not a device problem"):
                executor.window_loop(source, consume)


# ---------------------------------------------------------------------- #
# 4. routing and accounting
# ---------------------------------------------------------------------- #


class TestRoutingAndAccounting:
    def test_decide_residency_pins_and_auto(self, metric_counts):
        import modin_tpu.config as jax_config
        from modin_tpu.ops import router as jax_router

        from modin_tpu.core.memory import device_ledger as jax_ledger

        cases = [("Resident", None, 1 << 60), ("Windowed", None, 1), ("Auto", None, 1 << 60),
                 ("Auto", 1 << 20, 1 << 30), ("Auto", 1 << 20, 1 << 10)]
        for mode, budget, est in cases:
            with contextlib.ExitStack() as stack:
                stack.enter_context(StreamMode.context(mode))
                stack.enter_context(jax_config.StreamMode.context(mode))
                stack.enter_context(DeviceMemoryBudget.context(budget))
                if budget is not None:  # the JAX package's budget is unset by default
                    stack.enter_context(jax_config.DeviceMemoryBudget.context(budget))
                assert jax_ledger.budget() == memory.device_ledger.budget() == budget
                # each ledger's own residents as the op's own bytes: the
                # headroom is the budget on both sides
                got = router.decide_residency("sort", est, self_bytes=memory.device_ledger.total_bytes())
                want = jax_router.decide_residency("sort", est, self_bytes=jax_ledger.total_bytes())
            assert got == want, (mode, budget, est)
        assert [router.decide_residency("sort", 1 << 60)] == ["resident"]  # Auto, no budget
        assert metric_counts.get("router.residency_sort.windowed", 0) == 2
        assert metric_counts.get("router.residency_sort.resident", 0) == 4

    def test_decide_residency_self_bytes_discount(self):
        df = tpd.DataFrame({"a": np.arange(4096, dtype=np.float64), "b": np.arange(4096, dtype=np.float64)})
        frame = df._query_compiler._modin_frame
        own = stream_windows.frame_resident_bytes(frame)
        assert own == stream_windows.frame_nbytes(frame) == 2 * 4096 * 8
        with StreamMode.context("Auto"), DeviceMemoryBudget.context(memory.device_ledger.total_bytes() + 1024):
            # counted against its own headroom, the frame would stream
            assert router.decide_residency("sort", own) == "windowed"
            assert router.decide_residency("sort", own, self_bytes=own) == "resident"

    def test_window_bytes_derivation(self):
        import modin_tpu.config as jax_config
        from modin_tpu.streaming import windows as jax_windows

        with StreamWindowBytes.context(12345):
            assert stream_windows.window_bytes_for(1) == 12345
        with StreamWindowBytes.context(0), jax_config.StreamWindowBytes.context(0):
            for budget in (1 << 26, 1 << 10):
                with DeviceMemoryBudget.context(budget), jax_config.DeviceMemoryBudget.context(budget):
                    for prefetch in (0, 1, 3):
                        got = stream_windows.window_bytes_for(prefetch)
                        assert got == jax_windows.window_bytes_for(prefetch)
                        assert got == max(budget // (8 * (1 + prefetch)), stream_windows._MIN_WINDOW_BYTES)
            if DeviceMemoryBudget.get() is None:
                assert stream_windows.window_bytes_for(1) == stream_windows._MIN_WINDOW_BYTES

    def test_windows_upload_at_their_exact_rows(self, tmp_path):
        """No power-of-two bucket: each window's tensors hold its rows."""
        df = _base_df(5000)
        path = _csv(tmp_path, df)
        rows = []
        with stream_windows.WindowSource(TorchCSVDispatcher, {"filepath_or_buffer": path}, 3000) as source:
            for i in range(len(source)):
                qc = source.parse_window(i)
                frame = qc._modin_frame
                assert all(c.data.shape[0] == len(frame) for c in frame._columns)
                rows.append(len(frame))
                stream_windows.release_qc(qc)
                assert all(c.is_spilled and c.host_cache is None for c in frame._columns)
        assert sum(rows) == len(df) and len(set(rows)) > 1

    def test_scan_cache_evicts_by_bytes(self, tmp_path, metric_counts):
        df = _base_df(4000)
        path = _csv(tmp_path, df)
        with PlanScanCacheBytes.context(1):
            got = tpd.to_pandas(tpd.read_csv(path)[["v"]].sum())
        _same(got, df[["v"]].sum())
        assert metric_counts.get("plan.scan.cache_evict", 0) >= 1

    def test_scan_cache_zero_disables_caching(self, tmp_path, metric_counts):
        df = _base_df(4000)
        path = _csv(tmp_path, df)
        with PlanScanCacheBytes.context(0):
            got = tpd.to_pandas(tpd.read_csv(path)[["v"]].sum())
        _same(got, df[["v"]].sum())
        assert metric_counts.get("plan.scan.cache_evict", 0) == 0
        assert metric_counts.get("plan.scan.cache_hit", 0) == 0

    def test_query_stats_window_fields(self, tmp_path, windowed):
        from modin_tpu_torch.observability import meters

        df = _base_df()
        path = _csv(tmp_path, df)
        with meters.query_stats("stream-test") as stats:
            _filtered_groupby_sum(path)
        assert stats.stream_windows > 1
        assert stats.stream_replays == 0
        assert stats.stream_overlap_s >= 0.0 and stats.stream_wait_s >= 0.0
        assert stats.bytes_parsed >= (tmp_path / "stream.csv").stat().st_size * 0.9
        rolled = stats.as_dict()
        assert rolled["stream_windows"] == stats.stream_windows and "stream_overlap_s" in rolled
        assert stats.hbm_high_water > 0
        assert "stream:" in stats.summary()
        with meters.query_stats("sort") as sort_stats:
            tpd.to_pandas(tpd.DataFrame(_sort_frame(key_dtype="int")).sort_values("key"))
        assert sort_stats.stream_windows > 1 and sort_stats.spill_bytes > 0

    def test_explain_shows_a_windowed_residency_staged_and_undonated(self, tmp_path, metric_counts):
        df = _base_df()
        path = _csv(tmp_path, df)
        donated = memory.COUNTS["fuse.donated"]
        gc.collect()
        budget = memory.device_ledger.total_bytes() + 4096  # under the source's bytes
        with FuseMode.context("Fused"), DeviceMemoryBudget.context(budget):
            md = tpd.read_csv(path)
            selected = md[md["a"] > 0][["v", "a"]]
            result = tpd.to_pandas(selected.sum())
        _same(result, df[df["a"] > 0][["v", "a"]].sum())
        assert metric_counts.get("stream.window.count", 0) > 1
        assert metric_counts.get("router.residency_scan_reduce.windowed", 0) >= 1
        assert memory.COUNTS["fuse.donated"] == donated
        qc = selected._query_compiler
        legs = [st for st in qc._plan_strategies.by_node.values() if "residency" in st.legs]
        assert len(legs) == 1
        st = legs[0]
        assert st.legs["residency"] == "windowed" and st.legs["compile"] == "staged"
        assert {"residency", "compile"} <= st.firm and not st.donate
        assert st.measured_bytes == (tmp_path / "stream.csv").stat().st_size
        # the streamed query adopted no scan, so its compiler stays
        # deferred: the materialization's own EXPLAIN
        from modin_tpu_torch.plan import explain

        text = explain.explain_plan(*qc._plan_explain, strategies=qc._plan_strategies)
        assert "residency=windowed!" in text and "compile=staged!" in text and "stream_bytes=" in text

    def test_ledger_pressure_consult_windows_a_resident_plan(self, tmp_path, metric_counts):
        """The plan's estimate is the pruned scan's bytes, the live verdict's
        the whole file's: between them the optimizer planned resident, the
        router says windowed, and the consult re-plans and follows it."""
        from modin_tpu_torch.plan import optimizer

        rng = np.random.default_rng(9)
        df = pandas.DataFrame({c: rng.integers(0, 100, 6000) for c in "abcdefgh"})
        path = _csv(tmp_path, df)
        size = (tmp_path / "stream.csv").stat().st_size
        chosen = []
        choose = optimizer.choose

        def spy(root, *a, **k):
            chosen.append(choose(root, *a, **k))
            return chosen[-1]

        gc.collect()
        budget = memory.device_ledger.total_bytes() + size // 2  # over 2 of 8 columns, under the file
        with DeviceMemoryBudget.context(budget):
            optimizer.choose = spy
            try:
                got = tpd.to_pandas(tpd.read_csv(path)[["a", "b"]].sum())
            finally:
                optimizer.choose = choose
        _same(got, df[["a", "b"]].sum())
        assert optimizer.REPLANS.get("ledger_pressure", 0) >= 1
        assert any(r["trigger"] == "ledger_pressure" for state in chosen for r in state.replans)
        assert metric_counts.get("stream.window.count", 0) > 1

    def test_no_budget_keeps_every_hook_resident(self, tmp_path, metric_counts):
        from modin_tpu_torch import streaming

        assert StreamMode.get() == "Auto" and DeviceMemoryBudget.get() is None and not streaming.STREAM_ON
        df = _base_df(6000)
        path = _csv(tmp_path, df)
        m = tpd.read_csv(path)
        _same(tpd.to_pandas(m[m["a"] > 0][["v"]].sum()), df[df["a"] > 0][["v"]].sum())
        m = tpd.read_csv(path)
        _same(tpd.to_pandas(m.groupby("k").sum()), df.groupby("k").sum())
        md = tpd.DataFrame(df)
        _same(tpd.to_pandas(md.sort_values("v")), df.sort_values("v", kind="stable"))
        right = pandas.DataFrame({"k": np.arange(20), "r": np.arange(20) * 2})
        _same(tpd.to_pandas(md.merge(tpd.DataFrame(right), on="k")), df.merge(right, on="k"))
        assert metric_counts.get("stream.window.count", 0) == 0
        assert not any(k.startswith("router.residency_") for k in metric_counts)

    def test_a_budget_below_the_source_streams_every_hook(self, tmp_path, metric_counts):
        """Auto under a budget below the data: the reduce, the groupby, the
        sort and the merge each stream, and each answers as the resident
        path does."""
        df = _base_df(12000)
        path = _csv(tmp_path, df)
        right = pandas.DataFrame({"k": np.arange(20).repeat(3), "r": np.arange(60)})
        queries = {
            "reduce": lambda pd: (lambda m: m[m["a"] > 0][["v", "a"]].sum())(pd.read_csv(path)),
            "groupby": lambda pd: (lambda m: m[m["a"] > 0].groupby("k").mean())(pd.read_csv(path)),
            "sort": lambda pd: pd.DataFrame(df).sort_values("v", ascending=False),
            "merge": lambda pd: pd.DataFrame(df).merge(pd.DataFrame(right), on="k", how="left"),
        }
        for name, query in queries.items():
            resident = _resident(query)
            before = metric_counts.get("stream.window.count", 0)
            gc.collect()  # the budget is relative to the live residents
            with DeviceMemoryBudget.context(memory.device_ledger.total_bytes() + 4096):
                got = tpd.to_pandas(query(tpd))
            assert metric_counts.get("stream.window.count", 0) > before, name
            _same(got, resident)

