"""The derived-artifact cache of the torch port (``modin_tpu_torch/views/``)
against pandas, against ``MODIN_TPU_TORCH_VIEWS=Off`` and against the JAX
package's ``modin_tpu/views/``.

The cases of ``tests/test_views.py`` that apply to the port, at its sizes
(400 rows, tails of 120):

- whole-result reuse (scalar reductions, nunique/mode/median, groupby
  tables), across threads too;
- append-only folds: int folds bit for bit, float folds against pandas and
  against Off, chained appends (ten of them), branches that never cross, a
  non-foldable artifact that stays warm while its parent lives, groupby
  folds, ``size`` and selection, the ``ViewsMaxGroups`` decline, dictionary
  code-table extension;
- invalidation by setitem, by spill and restore, by an in-place write (the
  tensor's ``_version``), and by pressure (derived entries first);
- the stale-write guard and its concurrent stress;
- Off: no token allocated, answers equal to the cache's absence;
- chaos (``tests/test_views.py``'s): a re-seat drops the column's
  artifacts, an artifact of an earlier device epoch never answers, a
  recovery pass leaves nothing that answers, and a loss in the middle of a
  fold recovers bit for bit through both packages under one schedule.

Then the differential test: one sequence of queries and appends through
``modin_tpu.pandas`` and the port gives the same answers and the same
sequence of hits, folds and misses (the JAX package's metric events against
the port's ``registry.COUNTS``); the router's "view" strategy and the
optimizer's view leg; an int64 sum folded past 2^63; row concat of frames
with a string column, which stays off pandas.

Tolerance: ints, bools, min, max and counts exactly; float sums and means
to rtol 1e-12 of pandas' (another summation order); a grouped float sum or
mean to 1e-12 of its group's sum (or mean) of ``|x|``.
"""

import gc
import threading

import numpy as np
import pandas
import pytest

import modin_tpu.pandas as mpd
from modin_tpu.logging.metrics import add_metric_handler, clear_metric_handler
from modin_tpu.utils import to_pandas as jax_to_pandas
from modin_tpu.views import registry as jax_registry

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch.config import DeviceMemoryBudget, ViewsMaxChain, ViewsMaxGroups, ViewsMode
from modin_tpu_torch.core import memory
from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
from modin_tpu_torch.views import incremental, registry

RTOL = 1e-12


@pytest.fixture(autouse=True)
def _cpu_and_clean_registry():
    modin_tpu_torch.set_device("cpu")
    registry.reset()
    yield
    registry.reset()


def _counts():
    return dict(registry.COUNTS)


def _delta(before, name):
    return registry.COUNTS.get(name, 0) - before.get(name, 0)


def _frames(n=400, seed=7):
    rng = np.random.default_rng(seed)
    pdf = pandas.DataFrame({
        "i": rng.integers(-1000, 1000, n),
        "f": np.where(rng.random(n) < 0.2, np.nan, rng.normal(size=n)),
        "b": rng.random(n) < 0.5,
    })
    return tpd.DataFrame(pdf), pdf


def _tails(n=120, seed=8):
    rng = np.random.default_rng(seed)
    return pandas.DataFrame({
        "i": rng.integers(-1000, 1000, n),
        "f": np.where(rng.random(n) < 0.2, np.nan, rng.normal(size=n)),
        "b": rng.random(n) < 0.5,
    })


def _append(tdf, pdf, tail):
    return (tpd.concat([tdf, tpd.DataFrame(tail)], ignore_index=True),
            pandas.concat([pdf, tail], ignore_index=True))


def _column(tdf, label):
    frame = tdf._query_compiler._modin_frame
    return frame.get_column(list(frame.columns).index(label))


def _same(got, want):
    """Port result against pandas: exact where no float is involved, float
    columns to rtol 1e-12."""
    got = tpd.to_pandas(got) if hasattr(got, "_query_compiler") else got
    if isinstance(want, pandas.Series):
        exact = want.dtype.kind != "f" and want.dtype != object
        pandas.testing.assert_series_equal(got, want, check_exact=exact, rtol=RTOL, atol=0)
    else:
        pandas.testing.assert_frame_equal(got, want, check_exact=False, rtol=RTOL, atol=0)
        for c in want.columns:
            if want[c].dtype.kind != "f":
                pandas.testing.assert_series_equal(got[c], want[c], check_exact=True)


def _same_grouped(got, want, pdf, agg):
    """Grouped results: ints exactly, float sums and means to 1e-12 of the
    group's sum (mean) of |x|."""
    got = tpd.to_pandas(got)
    pandas.testing.assert_index_equal(got.index, want.index)
    want_frame = want.to_frame() if isinstance(want, pandas.Series) else want
    got_frame = got.to_frame() if isinstance(got, pandas.Series) else got
    for c in want_frame.columns:
        w, g = want_frame[c].to_numpy(), got_frame[c].to_numpy()
        assert g.dtype == w.dtype, (c, g.dtype, w.dtype)
        if w.dtype.kind != "f":
            assert (g == w).all(), c
            continue
        scale = pdf[c].abs().groupby(pdf["k"]).agg("sum" if agg == "sum" else "mean")
        scale = scale.reindex(want_frame.index).to_numpy()
        both_nan = np.isnan(g) & np.isnan(w)
        assert (both_nan | (np.abs(g - w) <= RTOL * scale)).all(), c


# ---------------------------------------------------------------------- #
# whole-result reuse
# ---------------------------------------------------------------------- #


class TestWholeResultReuse:
    def test_second_query_is_artifact_hit(self):
        tdf, pdf = _frames()
        c0 = _counts()
        _same(tdf.sum(), pdf.sum())
        assert _delta(c0, "view.build") == 3  # one artifact per column
        c1 = _counts()
        _same(tdf.sum(), pdf.sum())
        assert _delta(c1, "view.hit") == 3
        assert _delta(c1, "view.build") == 0  # nothing computed again

    @pytest.mark.parametrize(
        "op", ["sum", "mean", "min", "max", "count", "prod", "var", "std", "median", "any", "all"]
    )
    def test_scalar_ops_cached_and_correct(self, op):
        tdf, pdf = _frames()
        _same(getattr(tdf, op)(), getattr(pdf, op)())
        c0 = _counts()
        _same(getattr(tdf, op)(), getattr(pdf, op)())  # warm
        assert _delta(c0, "view.hit") == 3

    def test_nunique_mode_cached(self):
        tdf, pdf = _frames()
        _same(tdf.nunique(), pdf.nunique())
        _same(tdf.mode(), pdf.mode())
        c0 = _counts()
        _same(tdf.nunique(), pdf.nunique())
        _same(tdf.mode(), pdf.mode())
        assert _delta(c0, "view.hit") == 6

    def test_hit_launches_nothing(self):
        # the bincount wrapper counts every call on the CPU route too here:
        # a hit must not reach it (nor any reduction)
        from modin_tpu_torch.ops.cuda import groupby_kernels

        tdf, pdf = _frames()
        _same(tdf[["i"]].nunique(), pdf[["i"]].nunique())
        calls = []
        plain = groupby_kernels.bincount_plain
        groupby_kernels.bincount_plain = lambda *a, **k: calls.append(1) or plain(*a, **k)
        try:
            _same(tdf[["i"]].nunique(), pdf[["i"]].nunique())
        finally:
            groupby_kernels.bincount_plain = plain
        assert not calls

    def test_groupby_result_cached(self):
        tdf, pdf = _frames()
        _same(tdf.groupby("b").sum(), pdf.groupby("b").sum())
        c0 = _counts()
        _same(tdf.groupby("b").sum(), pdf.groupby("b").sum())
        assert _delta(c0, "view.hit") == 1

    def test_cross_thread_sharing(self):
        tdf, pdf = _frames()
        _same(tdf.sum(), pdf.sum())  # the artifacts built on this thread
        results = {}
        c0 = _counts()
        t = threading.Thread(target=lambda: results.setdefault("sum", tdf.sum()))
        t.start()
        t.join()
        _same(results["sum"], pdf.sum())
        assert _delta(c0, "view.hit") == 3


# ---------------------------------------------------------------------- #
# append-only folds
# ---------------------------------------------------------------------- #


class TestIncrementalFolds:
    @pytest.mark.parametrize("op", ["sum", "count", "min", "max", "prod"])
    def test_fold_bit_exact_int(self, op):
        tdf, pdf = _frames()
        getattr(tdf, op)()
        tdf2, pdf2 = _append(tdf, pdf, _tails())
        c0 = _counts()
        got = tpd.to_pandas(getattr(tdf2, op)())
        assert _delta(c0, "view.fold") == 3
        want = getattr(pdf2, op)()
        assert got["i"] == want["i"] and got["b"] == want["b"]
        _same(got, want)

    @pytest.mark.parametrize("op", ["mean", "sum", "min", "max", "count"])
    def test_fold_float_matches_pandas(self, op):
        tdf, pdf = _frames()
        getattr(tdf, op)()
        tdf2, pdf2 = _append(tdf, pdf, _tails())
        c0 = _counts()
        _same(getattr(tdf2, op)(), getattr(pdf2, op)())
        assert _delta(c0, "view.fold") == 3

    def test_fold_matches_views_off(self):
        """The cache is invisible: Auto after an append equals Off."""
        tdf, pdf = _frames()
        for op in ("sum", "mean", "min"):
            getattr(tdf, op)()
        tdf2, pdf2 = _append(tdf, pdf, _tails())
        auto = {op: tpd.to_pandas(getattr(tdf2, op)()) for op in ("sum", "mean", "min")}
        with ViewsMode.context("Off"):
            t_off = tpd.DataFrame(pdf2)
            off = {op: tpd.to_pandas(getattr(t_off, op)()) for op in ("sum", "mean", "min")}
        for op in auto:
            if op != "mean":
                assert auto[op]["i"] == off[op]["i"], op  # ints fold bit for bit
            pandas.testing.assert_series_equal(auto[op], off[op], check_exact=False, rtol=RTOL, atol=0)

    def test_ten_chained_appends(self):
        """Ten appends, each folded into the last: ints and bools bit for
        bit, float sums and means within rtol 1e-12 of pandas and of Off."""
        tdf, pdf = _frames()
        ops = ("sum", "mean", "min", "max", "count", "prod")
        for op in ops:
            getattr(tdf, op)()
        for step in range(10):
            tdf, pdf = _append(tdf, pdf, _tails(seed=40 + step))
            c0 = _counts()
            got = {op: tpd.to_pandas(getattr(tdf, op)()) for op in ops}
            assert _delta(c0, "view.fold") == 3 * len(ops), step
            assert _delta(c0, "view.miss") == 0, step
            for op in ops:
                _same(got[op], getattr(pdf, op)())
        with ViewsMode.context("Off"):
            t_off = tpd.DataFrame(pdf)
            for op in ops:
                off = tpd.to_pandas(getattr(t_off, op)())
                assert off["i"] == got[op]["i"] and off["b"] == got[op]["b"], op
                np.testing.assert_allclose(got[op]["f"], off["f"], rtol=RTOL, atol=0)

    def test_branching_appends_never_cross(self):
        """Two appends onto one parent, folded on two threads at once: each
        branch answers for its own tail."""
        tdf, pdf = _frames()
        tdf.sum()
        tdf_a, pdf_a = _append(tdf, pdf, _tails(seed=31))
        tdf_b, pdf_b = _append(tdf, pdf, _tails(seed=32))
        barrier = threading.Barrier(2, timeout=30)
        results = {}

        def run(name, frame):
            barrier.wait()
            results[name] = tpd.to_pandas(frame.sum())

        ts = [threading.Thread(target=run, args=("a", tdf_a)), threading.Thread(target=run, args=("b", tdf_b))]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert results["a"]["i"] == pdf_a.sum()["i"]
        assert results["b"]["i"] == pdf_b.sum()["i"]
        _same(results["a"], pdf_a.sum())
        _same(results["b"], pdf_b.sum())

    def test_non_incremental_keeps_live_parent_warm(self):
        tdf, pdf = _frames()
        _same(tdf.median(), pdf.median())
        tdf2, pdf2 = _append(tdf, pdf, _tails())
        c0 = _counts()
        _same(tdf2.median(), pdf2.median())
        assert _delta(c0, "view.invalidate.not_incremental") == 0
        c1 = _counts()
        _same(tdf.median(), pdf.median())  # the parent is still warm
        assert _delta(c1, "view.hit") == 3

    def test_non_incremental_invalidates_once_parent_dies(self):
        tdf, pdf = _frames()
        _same(tdf.var(), pdf.var())
        tdf2, pdf2 = _append(tdf, pdf, _tails())
        del tdf  # the frame before the append is gone: its artifacts are dead weight
        gc.collect()
        c0 = _counts()
        _same(tdf2.var(), pdf2.var())
        assert _delta(c0, "view.invalidate.not_incremental") == 3

    def test_groupby_folds(self):
        tdf, pdf = _frames()
        aggs = ("sum", "count", "mean", "min", "max")
        for agg in aggs:
            getattr(tdf.groupby("b"), agg)()
        tdf2, pdf2 = _append(tdf, pdf, _tails())
        c0 = _counts()
        for agg in aggs:
            _same(getattr(tdf2.groupby("b"), agg)(), getattr(pdf2.groupby("b"), agg)())
        assert _delta(c0, "view.fold") == len(aggs)

    def test_groupby_ten_chained_appends(self):
        """A grouped sum and mean folded over ten appends, held to pandas
        within 1e-12 of each group's magnitude and the int column exactly."""
        rng = np.random.default_rng(3)

        def part(n):
            return pandas.DataFrame({
                "k": rng.integers(0, 12, n),
                "i": rng.integers(-1000, 1000, n),
                "f": np.where(rng.random(n) < 0.2, np.nan, rng.normal(size=n) * 1e3),
            })

        pdf = part(400)
        tdf = tpd.DataFrame(pdf)
        for agg in ("sum", "mean"):
            getattr(tdf.groupby("k"), agg)()
        for step in range(10):
            tdf, pdf = _append(tdf, pdf, part(120))
            c0 = _counts()
            for agg in ("sum", "mean"):
                _same_grouped(getattr(tdf.groupby("k"), agg)(), getattr(pdf.groupby("k"), agg)(), pdf, agg)
            assert _delta(c0, "view.fold") == 2, step

    def test_groupby_size_and_selection(self):
        tdf, pdf = _frames()
        _same(tdf.groupby("b").size(), pdf.groupby("b").size())
        _same(tdf.groupby("b")["i"].sum(), pdf.groupby("b")["i"].sum())
        tdf2, pdf2 = _append(tdf, pdf, _tails())
        c0 = _counts()
        _same(tdf2.groupby("b").size(), pdf2.groupby("b").size())
        _same(tdf2.groupby("b")["i"].sum(), pdf2.groupby("b")["i"].sum())
        assert _delta(c0, "view.fold") == 2

    def test_groupby_bound_declines_large_cardinality(self):
        rng = np.random.default_rng(5)
        pdf = pandas.DataFrame({"k": rng.integers(0, 64, 500), "v": rng.integers(0, 9, 500)})
        tdf = tpd.DataFrame(pdf)
        with ViewsMaxGroups.context(8):
            _same(tdf.groupby("k").sum(), pdf.groupby("k").sum())
            # 64 groups past the bound of 8: no groupby artifact
            assert not any(art.kind == "groupby" for art in registry.live_artifacts())

    def test_dictionary_code_table_extension(self):
        pdf = pandas.DataFrame({
            "city": ["lima", "oslo", None, "lima", "oslo", "lima"],
            "n": np.arange(6, dtype=np.int64),
        })
        tdf = tpd.DataFrame(pdf)
        _same(tdf.nunique(), pdf.nunique())  # the encoding is built
        tail = pandas.DataFrame({"city": ["pune", "lima", None], "n": np.arange(3, dtype=np.int64)})
        c0 = _counts()
        d0 = tqc.DEFAULTS_TO_PANDAS
        tdf2 = tpd.concat([tdf, tpd.DataFrame(tail)], ignore_index=True)
        pdf2 = pandas.concat([pdf, tail], ignore_index=True)
        assert tqc.DEFAULTS_TO_PANDAS == d0
        assert _delta(c0, "view.fold") == 1
        # the extended encoding answers exactly as a fresh factorization
        enc = tdf2._query_compiler._modin_frame.get_column(0)._dict_cache
        assert list(enc.categories) == ["lima", "oslo", "pune"]
        assert enc.has_nan
        codes = np.asarray(enc.codes.to_numpy(), dtype=np.float64)
        want_codes, _ = pandas.factorize(np.asarray(pdf2["city"], dtype=object), sort=True, use_na_sentinel=True)
        np.testing.assert_array_equal(np.where(np.isnan(codes), -1, codes).astype(np.int64), want_codes)
        _same(tdf2.nunique(), pdf2.nunique())
        _same(tdf2.groupby("city").sum(), pdf2.groupby("city").sum())
        assert tqc.DEFAULTS_TO_PANDAS == d0

    def test_int64_sum_folded_past_2_63(self):
        """The fold adds in int64 and wraps as pandas' sum does: a Python
        int fold would not wrap."""
        big = np.int64(2**62)
        pdf = pandas.DataFrame({"i": np.full(400, big // 200, dtype=np.int64) + np.arange(400)})
        tdf = tpd.DataFrame(pdf)
        _same(tdf.sum(), pdf.sum())
        tail = pandas.DataFrame({"i": np.full(120, big // 50, dtype=np.int64)})
        tdf2, pdf2 = _append(tdf, pdf, tail)
        c0 = _counts()
        got = tpd.to_pandas(tdf2.sum())
        assert _delta(c0, "view.fold") == 1
        with np.errstate(over="ignore"):
            exact = int(pdf2["i"].to_numpy().astype(object).sum())
        assert exact >= 2**63  # the true sum passes the int64 range
        assert got["i"] == pdf2.sum()["i"]
        assert got.dtype == pdf2.sum().dtype

    def test_unsigned_sum_folds_as_pandas(self):
        rng = np.random.default_rng(9)
        pdf = pandas.DataFrame({"u": rng.integers(0, 256, 400).astype(np.uint8)})
        tdf = tpd.DataFrame(pdf)
        _same(tdf.sum(), pdf.sum())
        tail = pandas.DataFrame({"u": rng.integers(0, 256, 120).astype(np.uint8)})
        tdf2, pdf2 = _append(tdf, pdf, tail)
        c0 = _counts()
        got = tpd.to_pandas(tdf2.sum())
        assert _delta(c0, "view.fold") == 1
        assert got["u"] == pdf2.sum()["u"] and got.dtype == pdf2.sum().dtype

    def test_long_chains_compact(self):
        """Past ``ViewsMaxChain`` appends a column's link re-anchors past the
        ancestors that hold nothing: the fold still finds the artifact and
        the walk stays short."""
        tdf, pdf = _frames(n=50)
        tdf.sum()
        with ViewsMaxChain.context(4):
            for step in range(12):
                tdf, pdf = _append(tdf, pdf, _tails(n=5, seed=60 + step))
            w0 = registry.walk_stats()
            c0 = _counts()
            _same(tdf.sum(), pdf.sum())
            w1 = registry.walk_stats()
        assert _delta(c0, "view.fold") == 3
        assert w1["compactions"] > 0
        assert (w1["hops"] - w0["hops"]) / max(w1["lookups"] - w0["lookups"], 1) <= 4


# ---------------------------------------------------------------------- #
# invalidation
# ---------------------------------------------------------------------- #


class TestInvalidation:
    def test_setitem_misses_cleanly(self):
        tdf, pdf = _frames()
        _same(tdf.sum(), pdf.sum())
        old = _column(tdf, "i")
        tdf["i"] = tdf["i"] * 2
        pdf["i"] = pdf["i"] * 2
        assert old._view_token not in registry._by_token  # its artifacts went
        _same(tdf.sum(), pdf.sum())
        _same(tdf.mean(), pdf.mean())

    def test_spill_restore_invalidates(self):
        tdf, pdf = _frames()
        _same(tdf.sum(), pdf.sum())
        col = _column(tdf, "i")
        c0 = _counts()
        assert col.spill() > 0
        assert _delta(c0, "view.invalidate.buffer") >= 1
        assert col.raw is not None  # restores on read
        c1 = _counts()
        _same(tdf.sum(), pdf.sum())
        assert _delta(c1, "view.miss") == 1 and _delta(c1, "view.hit") == 2

    def test_inplace_write_turns_hit_into_miss(self):
        """The port writes no column in place; if a tensor is written all the
        same, its ``_version`` moves and the artifact stops answering."""
        tdf, pdf = _frames()
        _same(tdf.sum(), pdf.sum())
        col = _column(tdf, "i")
        col.data.add_(1)  # in place: the same tensor, a new version
        col.host_cache = None  # the host copy no longer holds its values
        pdf["i"] = pdf["i"] + 1
        c0 = _counts()
        _same(tdf.sum(), pdf.sum())
        assert _delta(c0, "view.miss") == 1
        assert _delta(c0, "view.invalidate.buffer") == 1

    def test_inplace_write_of_a_parent_stops_the_fold(self):
        tdf, pdf = _frames()
        tdf.sum()
        _column(tdf, "i").data.add_(1)  # after the artifact, before the append
        _column(tdf, "i").host_cache = None
        pdf["i"] = pdf["i"] + 1
        tdf2, pdf2 = _append(tdf, pdf, _tails())
        c0 = _counts()
        _same(tdf2.sum(), pdf2.sum())
        assert _delta(c0, "view.fold") == 2  # f and b fold, i misses
        assert _delta(c0, "view.miss") == 1

    def test_pressure_drops_artifacts_before_columns(self):
        tdf, pdf = _frames(n=1024)
        _same(tdf.median(), pdf.median())  # sorted representations
        cols = [_column(tdf, c) for c in ("i", "f", "b")]
        assert all(c._sorted_rep is not None for c in cols)
        c0 = _counts()
        freed = memory.device_ledger.spill_lru(1)  # a tiny target: one entry
        assert freed > 0
        assert _delta(c0, "view.spill") == 1
        # a derived cache paid for the pressure; every column is resident
        assert not any(c.is_spilled for c in cols)
        assert _delta(c0, "view.invalidate.pressure") >= 1
        _same(tdf.median(), pdf.median())

    def test_budget_pressure_keeps_columns_resident(self):
        tdf, pdf = _frames(n=2048)
        _same(tdf.median(), pdf.median())
        cols = [_column(tdf, c) for c in ("i", "f", "b")]
        with DeviceMemoryBudget.context(memory.device_resident_bytes()):
            memory.device_ledger.admit(64)
        assert not any(c.is_spilled for c in cols)
        assert sum(c._sorted_rep is not None for c in cols) < 3
        _same(tdf.median(), pdf.median())


# ---------------------------------------------------------------------- #
# the stale-write guard
# ---------------------------------------------------------------------- #


class TestChaos:
    """The views' device epoch (``recovery.current_epoch``) and the chaos
    cases of ``tests/test_views.py``: a re-seat pass and a loss in the middle
    of a fold, through the port and the JAX package with one schedule."""

    @pytest.fixture(autouse=True)
    def _recovery_on(self):
        from modin_tpu.config import RecoveryMode as JaxRecoveryMode
        from modin_tpu.config import ResilienceBackoffS as JaxBackoff
        from modin_tpu.core.execution import recovery as jax_recovery

        from modin_tpu_torch.config import RecoveryMode, ResilienceBackoffS
        from modin_tpu_torch.core.execution import recovery, resilience

        saved = [(p, p.get()) for p in (JaxRecoveryMode, JaxBackoff, RecoveryMode, ResilienceBackoffS)]
        for p in (JaxRecoveryMode, RecoveryMode):
            p.put("Enable")
        for p in (JaxBackoff, ResilienceBackoffS):
            p.put(0.0)
        recovery.reset_for_tests()
        jax_recovery.reset_for_tests()
        resilience.reset_counts()
        yield
        for p, v in saved:
            p.put(v)
        recovery.reset_for_tests()
        jax_recovery.reset_for_tests()

    def test_reseat_invalidates(self):
        tdf, pdf = _frames()
        _same(tdf.max(), pdf.max())
        col = _column(tdf, "i")
        token = col._view_token
        assert token in registry._by_token
        col.reseat_from_host()
        assert token not in registry._by_token  # the new tensor's artifacts are gone
        c0 = _counts()
        _same(tdf.max(), pdf.max())
        assert _delta(c0, "view.miss") >= 1

    def test_artifacts_of_an_earlier_epoch_never_answer(self, monkeypatch):
        from modin_tpu_torch.core.execution import recovery

        tdf, pdf = _frames()
        _same(tdf.sum(), pdf.sum())
        assert all(a.epoch == 0 for a in registry.live_artifacts())
        # the epoch moves without the columns' tensors changing
        monkeypatch.setattr(recovery, "_device_epoch", recovery.current_epoch() + 1)
        c0 = _counts()
        _same(tdf.sum(), pdf.sum())
        assert _delta(c0, "view.invalidate.device_epoch") >= 1
        assert _delta(c0, "view.hit") == 0

    def test_recovery_pass_drops_artifacts(self):
        from modin_tpu.core.execution import recovery as jax_recovery
        from modin_tpu.views import registry as jreg

        from modin_tpu_torch.core.execution import recovery, resilience

        tdf, pdf = _frames()
        jdf = mpd.DataFrame(pdf)
        _same(tdf.sum(), pdf.sum())
        _same(jax_to_pandas(jdf.sum()), pdf.sum())
        assert len(registry.live_artifacts()) >= 3 and len(jreg.live_artifacts()) >= 3
        recovery.reseat_all("test-views-epoch-bump")
        jax_recovery.reseat_all("test-views-epoch-bump")
        c0 = _counts()
        _same(tdf.sum(), pdf.sum())
        _same(jax_to_pandas(jdf.sum()), pdf.sum())
        assert _delta(c0, "view.hit") == 0 and _delta(c0, "view.miss") == 3
        assert all(a.epoch == recovery.current_epoch() == 1 for a in registry.live_artifacts())
        assert resilience.COUNTS.get("recovery.unrecoverable", 0) == 0

    def test_device_lost_mid_fold_recovers_bit_exact(self):
        from modin_tpu.logging.metrics import add_metric_handler, clear_metric_handler
        from modin_tpu.testing.faults import midquery_device_loss as jax_midquery

        from modin_tpu_torch.core.execution import resilience
        from modin_tpu_torch.testing import midquery_device_loss

        seen = []
        add_metric_handler(lambda name, value: seen.append(name))
        try:
            tdf, pdf = _frames()
            jdf = mpd.DataFrame(pdf)
            tdf.sum()
            jdf.sum()
            tail = _tails()
            tdf2 = tpd.concat([tdf, tpd.DataFrame(tail)], ignore_index=True)
            jdf2 = mpd.concat([jdf, mpd.DataFrame(tail)], ignore_index=True)
            pdf2 = pandas.concat([pdf, tail], ignore_index=True)
            # the fold's first seam call dies (the JAX package's tail gather,
            # the port's fetch: it reduces a concrete tail without a
            # dispatch); the re-seat and the retry answer
            ops = ("deploy", "materialize")
            with midquery_device_loss(after_deploys=0, times=1, ops=ops) as inj:
                got = tdf2.sum()
            with jax_midquery(after_deploys=0, times=1, ops=ops) as jinj:
                jgot = jax_to_pandas(jdf2.sum())
            assert inj.injected == jinj.injected == 1
            assert tpd.to_pandas(got)["i"] == jgot["i"] == pdf2.sum()["i"]
            _same(got, pdf2.sum())
            assert resilience.COUNTS["recovery.device_lost"] == 1
            assert resilience.COUNTS.get("recovery.unrecoverable", 0) == 0
            assert "modin_tpu.recovery.unrecoverable" not in seen
            # nothing of the dead epoch answers afterwards
            c0 = _counts()
            _same(tdf2.mean(), pdf2.mean())
            assert _delta(c0, "view.hit") == 0
        finally:
            clear_metric_handler(seen.append)


class TestStaleWriteGuard:
    def test_store_declines_on_spilled_buffer(self):
        tdf, pdf = _frames()
        _same(tdf.sum(), pdf.sum())
        col = _column(tdf, "i")
        params = ("sum", True, 1, True)
        outcome, state, _ = registry.lookup(col, "reduce", params)
        assert outcome == "hit"
        source = col.data
        assert col.spill() > 0  # the buffer changes between lookup and commit
        assert registry.store(col, "reduce", params, dict(state), source=source) is False
        col.data  # restored: a new tensor
        assert registry.store(col, "reduce", params, dict(state), source=source) is False

    def test_concurrent_append_and_spill_stress(self):
        """One thread folds over an appended child while another spills the
        child's tensor: every answer equals pandas, and no artifact claims
        a tensor its column no longer holds."""
        for round_ in range(6):
            registry.reset()
            tdf, pdf = _frames(seed=100 + round_)
            tdf.sum()
            tdf2, pdf2 = _append(tdf, pdf, _tails(seed=200 + round_))
            col = _column(tdf2, "i")
            barrier = threading.Barrier(2, timeout=30)
            out = {}

            def fold():
                barrier.wait()
                out["sum"] = tpd.to_pandas(tdf2.sum())

            def spill():
                barrier.wait()
                col.spill()

            ts = [threading.Thread(target=fold), threading.Thread(target=spill)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            assert out["sum"]["i"] == pdf2.sum()["i"]
            _same(out["sum"], pdf2.sum())
            for art in registry.live_artifacts():
                if art.token == col._view_token and art.kind == "reduce":
                    assert art.answers_for(col._data)


# ---------------------------------------------------------------------- #
# Off
# ---------------------------------------------------------------------- #


class TestOffMode:
    def test_off_is_inert_and_identical(self):
        tdf_auto, pdf = _frames()
        auto = {
            "sum": tpd.to_pandas(tdf_auto.sum()),
            "gmean": tpd.to_pandas(tdf_auto.groupby("b").mean()),
            "median": tpd.to_pandas(tdf_auto.median()),
        }
        registry.reset()
        with ViewsMode.context("Off"):
            tdf, pdf = _frames()
            c0 = _counts()
            off = {
                "sum": tpd.to_pandas(tdf.sum()),
                "gmean": tpd.to_pandas(tdf.groupby("b").mean()),
                "median": tpd.to_pandas(tdf.median()),
            }
            tdf2, pdf2 = _append(tdf, pdf, _tails())
            _same(tdf2.sum(), pdf2.sum())
            _same(tdf2.sum(), pdf2.sum())
            frames = [tdf, tdf2]
            assert all(
                c._view_token is None and c._view_parent is None
                for f in frames for c in f._query_compiler._modin_frame._columns
            )
            assert registry.stats()["entries"] == 0
            assert all(_delta(c0, k) == 0 for k in registry.COUNTS)
        for name in auto:  # the first computation is the same code either way
            pandas.testing.assert_frame_equal(
                auto[name].to_frame() if isinstance(auto[name], pandas.Series) else auto[name],
                off[name].to_frame() if isinstance(off[name], pandas.Series) else off[name],
                check_exact=True,
            )


# ---------------------------------------------------------------------- #
# against the JAX package
# ---------------------------------------------------------------------- #


VIEW_EVENTS = ("view.hit", "view.fold", "view.miss")


def _diff_frame(n, seed):
    rng = np.random.default_rng(seed)
    return pandas.DataFrame({
        "i": rng.integers(-1000, 1000, n),
        "f": np.where(rng.random(n) < 0.2, np.nan, rng.normal(size=n)),
        "b": rng.random(n) < 0.5,
        "k": rng.integers(0, 10, n),
    })


DIFF_QUERIES = {
    "sum": lambda d: d.sum(),
    "mean": lambda d: d.mean(),
    "count": lambda d: d.count(),
    "min": lambda d: d.min(),
    "max": lambda d: d.max(),
    "prod": lambda d: d[["b"]].prod(),
    "any": lambda d: d.any(),
    "all": lambda d: d.all(),
    "var": lambda d: d.var(),
    "median": lambda d: d.median(),
    "nunique": lambda d: d.nunique(),
    "mode": lambda d: d.mode(),
    "groupby_sum": lambda d: d.groupby("k").sum(),
    "groupby_mean": lambda d: d.groupby("k").mean(),
    "groupby_size": lambda d: d.groupby("k").size(),
    "groupby_count": lambda d: d.groupby("k").count(),
    "groupby_min": lambda d: d.groupby("k")[["i", "f"]].min(),
}


def test_differential_against_jax_views():
    """The same queries and appends through ``modin_tpu.pandas`` and the
    port: the same answers, and the same hits, folds and misses in the same
    order."""
    jax_registry.reset()
    events = []

    def handler(name, value):
        events.append(name)

    add_metric_handler(handler)
    try:
        base = _diff_frame(400, 7)
        tails = [_diff_frame(120, 8 + s) for s in range(2)]
        jax = {"base": mpd.DataFrame(base)}
        port = {"base": tpd.DataFrame(base)}
        jax["child"] = mpd.concat([jax["base"], mpd.DataFrame(tails[0])], ignore_index=True)
        port["child"] = tpd.concat([port["base"], tpd.DataFrame(tails[0])], ignore_index=True)
        jax["grandchild"] = mpd.concat([jax["child"], mpd.DataFrame(tails[1])], ignore_index=True)
        port["grandchild"] = tpd.concat([port["child"], tpd.DataFrame(tails[1])], ignore_index=True)
        jax_seq, port_seq = [], []
        for name, query in DIFF_QUERIES.items():
            for which in ("base", "base", "child", "child", "grandchild"):
                e0, c0 = len(events), _counts()
                want = jax_to_pandas(query(jax[which]))
                got = tpd.to_pandas(query(port[which]))
                jax_seq.append((name, which) + tuple(events[e0:].count(f"modin_tpu.{k}") for k in VIEW_EVENTS))
                port_seq.append((name, which) + tuple(_delta(c0, k) for k in VIEW_EVENTS))
                if isinstance(want, pandas.Series):
                    pandas.testing.assert_series_equal(got, want, check_exact=False, rtol=RTOL, atol=0)
                else:
                    pandas.testing.assert_frame_equal(got, want, check_exact=False, rtol=RTOL, atol=0)
        assert port_seq == jax_seq
        assert sum(s[3] for s in port_seq) > 0 and sum(s[4] for s in port_seq) > 0  # folds and misses
    finally:
        clear_metric_handler(handler)
        jax_registry.reset()


@pytest.mark.parametrize("op", ["median", "nunique", "mode", "quantile"])
def test_router_view_strategy_matches_jax(op):
    """A column answered by a cached result plans as "view" at no device
    cost: the port's verdicts and costs equal the JAX router's."""
    from modin_tpu.ops import router as jax_router

    from modin_tpu_torch.ops import router

    table = {
        "rows": 1 << 18,
        "device_sort_s": 4e-3, "device_consume_s": 1e-3, "device_hist_s": 5e-4,
        **{f"host_{o}_{r}_s": v for o in ("median", "quantile", "nunique", "mode")
           for r, v in (("low", 2e-3), ("high", 3e-2))},
    }
    for strategies in (["view"], ["view", "sort"], ["view", "hist", "cached"], ["view", "view"]):
        for n in (1 << 16, 1 << 22, 1 << 26):
            got = router.predicted_costs(op, n, strategies, table)
            want = jax_router.predicted_costs(op, n, strategies, table)
            assert got["device_s"] == pytest.approx(want["device_s"], rel=1e-12)
            assert got["host_s"] == pytest.approx(want["host_s"], rel=1e-12)
    only_view = router.predicted_costs(op, 1 << 26, ["view"], table)
    assert only_view["device_s"] == 0.0


def test_median_site_plans_view_strategies():
    """The live median site passes "view" for a column a cached result
    answers (the router's strategy list)."""
    from modin_tpu_torch.ops import router

    tdf, pdf = _frames()
    _same(tdf.median(), pdf.median())
    seen = []
    decide = router.decide
    router.decide = lambda op, n, strategies: seen.append((op, list(strategies))) or decide(op, n, strategies)
    try:
        _same(tdf.median(), pdf.median())
        _same(tdf.nunique(), pdf.nunique())
        _same(tdf.nunique(), pdf.nunique())
    finally:
        router.decide = decide
    assert seen[0] == ("median", ["view"] * 3)
    assert seen[1][0] == "nunique" and "view" not in seen[1][1]
    assert seen[2] == ("nunique", ["view"] * 3)


def test_optimizer_view_leg_is_live():
    """A sort-shaped reduction over an in-memory frame whose artifact is live
    plans the "view" kernel leg, EXPLAIN shows it, and the probe counts
    nothing; under Off the leg is the router's."""
    from modin_tpu_torch.plan import explain, optimizer
    from modin_tpu_torch.plan.ir import Reduce, Source

    tdf, pdf = _frames()
    root = Reduce(Source(tdf._query_compiler), "median", {})
    assert optimizer.choose(root).by_node[id(root)].legs["kernel"] in ("device", "host")
    _same(tdf.median(), pdf.median())
    c0 = _counts()
    strategies = optimizer.choose(root)
    assert strategies.by_node[id(root)].legs["kernel"] == "view"
    assert "kernel=view" in explain.render(root, strategies=strategies)
    assert all(_delta(c0, k) == 0 for k in registry.COUNTS)
    with ViewsMode.context("Off"):
        assert optimizer.choose(root).by_node[id(root)].legs["kernel"] in ("device", "host")


# ---------------------------------------------------------------------- #
# row concat of frames with a host column (the repair this slice needs)
# ---------------------------------------------------------------------- #


def _ikfs(n, seed):
    rng = np.random.default_rng(seed)
    return pandas.DataFrame({
        "i": rng.integers(-100, 100, n),
        "k": rng.integers(0, 5, n),
        "f": np.where(rng.random(n) < 0.2, np.nan, rng.normal(size=n)),
        "s": rng.choice(np.array(["alpha", "beta", None], dtype=object), n),
    }).astype({"s": "str"})


@pytest.mark.parametrize("ignore_index", [True, False])
def test_row_concat_keeps_host_columns_off_pandas(ignore_index):
    """Row concat of frames with a string column stays on the port's own
    path (device columns by ``torch.cat``, the string column by numpy in its
    exact dtype): no default to pandas, the answer pandas' and the JAX
    package's."""
    a, b = _ikfs(50, 1), _ikfs(30, 2)
    d0 = tqc.DEFAULTS_TO_PANDAS
    got = tpd.concat([tpd.DataFrame(a), tpd.DataFrame(b)], ignore_index=ignore_index)
    assert tqc.DEFAULTS_TO_PANDAS == d0
    want = pandas.concat([a, b], ignore_index=ignore_index)
    got_pd = tpd.to_pandas(got)
    pandas.testing.assert_frame_equal(got_pd, want, check_exact=True)
    jax = jax_to_pandas(mpd.concat([mpd.DataFrame(a), mpd.DataFrame(b)], ignore_index=ignore_index))
    pandas.testing.assert_frame_equal(got_pd, jax, check_exact=True)
    frame = got._query_compiler._modin_frame
    assert [c.is_device for c in frame._columns] == [True, True, True, False]
    # every part had a host copy: the concatenated one is kept
    assert all(c.host_cache is not None for c in frame._columns[:3])
    # a chained concat keeps the dtype and stays off pandas
    again = tpd.concat([got, tpd.DataFrame(a)], ignore_index=ignore_index)
    assert tqc.DEFAULTS_TO_PANDAS == d0
    pandas.testing.assert_frame_equal(
        tpd.to_pandas(again), pandas.concat([want, a], ignore_index=ignore_index), check_exact=True
    )


def test_concat_of_unlike_device_dtypes_matches_pandas():
    a = pandas.DataFrame({"x": np.arange(5, dtype=np.int32), "s": list("abcde")})
    b = pandas.DataFrame({"x": np.arange(3, dtype=np.int32), "s": list("xyz")})
    got = tpd.to_pandas(tpd.concat([tpd.DataFrame(a), tpd.DataFrame(b)]))
    pandas.testing.assert_frame_equal(got, pandas.concat([a, b]), check_exact=True)


def test_incremental_combines():
    assert incremental.combine_scalar("min", True, np.float64(np.nan), np.float64(2.0)) == 2.0
    assert np.isnan(incremental.combine_scalar("min", False, np.float64(np.nan), np.float64(2.0)))
    m, k = incremental.combine_mean(np.float64(np.nan), 0, np.float64(3.0), 4)
    assert m == 3.0 and k == 4
    big = np.asarray(np.int64(2**62))
    assert incremental.combine_scalar("sum", True, big, big) == np.int64(-(2**63))
