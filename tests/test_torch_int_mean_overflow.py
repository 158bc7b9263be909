"""Grouped int means add in float64, as pandas does, and do not wrap.

pandas adds an int column's values in float64 for a grouped mean, so a
group whose int64 sum passes 2^63 still gives its mean: ``DataFrame({"k":
[0, 0, 0, 1, 1], "v": [2**62] * 3 + [5, 7]}).groupby("k").mean()`` is
``[4.611686018427388e18, 6.0]``.  The port's eager groupby (the staged
segment sum and the ``groupagg`` route), its resample and its fused plan
groupby are held to pandas on that case, on its resample and on its
``read_csv(...).query(...).groupby(...)`` pipeline, and on a case where no
sum overflows.  Int sums and products keep wrapping, as pandas' do.  The
JAX package wraps here (ROADMAP Queue 3 item 4), so pandas is the
reference.  Values to rtol 1e-12.
"""

import numpy as np
import pandas
import pytest

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch.config import FuseMode, PlanMode
from modin_tpu_torch.plan import fuse

BIG = 2**62


@pytest.fixture(autouse=True)
def _cpu_device():
    modin_tpu_torch.set_device("cpu")


def _to_pandas(obj):
    return obj._to_pandas() if hasattr(obj, "_to_pandas") else obj


def _same(got, want):
    got = _to_pandas(got)
    if isinstance(want, pandas.DataFrame):
        pandas.testing.assert_frame_equal(got, want, check_exact=False, rtol=1e-12)
    else:
        pandas.testing.assert_series_equal(got, want, check_exact=False, rtol=1e-12)


FRAMES = {
    # the group sum 3 * 2^62 passes 2^63
    "overflow": pandas.DataFrame({"k": [0, 0, 0, 1, 1], "v": [BIG] * 3 + [5, 7]}),
    # sums of both signs past +/-2^63, beside a small group
    "both_signs": pandas.DataFrame({"k": [2, 2, 0, 0, 1], "v": [-BIG, -BIG - 7, BIG, BIG - 3, 11]}),
    # no sum overflows
    "no_overflow": pandas.DataFrame({"k": [0, 1, 0, 1, 2], "v": [2**40, -(2**40) + 3, 5, 7, -9]}),
}


@pytest.mark.parametrize("mode", ["Staged", "Fused"])
@pytest.mark.parametrize("case", list(FRAMES))
def test_eager_grouped_mean_follows_pandas(case, mode):
    df = FRAMES[case]
    with FuseMode.context(mode):
        _same(tpd.DataFrame(df).groupby("k").mean(), df.groupby("k").mean())
        _same(tpd.DataFrame(df).groupby("k")["v"].mean(), df.groupby("k")["v"].mean())


def test_the_repro_gives_pandas_values():
    got = _to_pandas(tpd.DataFrame(FRAMES["overflow"]).groupby("k").mean())
    assert got["v"].tolist() == [4.611686018427388e18, 6.0]


@pytest.mark.parametrize("mode", ["Staged", "Fused"])
@pytest.mark.parametrize("agg", ["sum", "prod"])
def test_int_sums_and_products_still_wrap_as_pandas(agg, mode):
    df = FRAMES["overflow"]
    with FuseMode.context(mode):
        got = _to_pandas(getattr(tpd.DataFrame(df).groupby("k"), agg)())
    want = getattr(df.groupby("k"), agg)()
    pandas.testing.assert_frame_equal(got, want)


@pytest.mark.parametrize("mode", ["Staged", "Fused"])
@pytest.mark.parametrize("case", list(FRAMES))
def test_resampled_mean_follows_pandas(case, mode):
    v = FRAMES[case]["v"].to_numpy()
    # the first three rows share a day, the last two the next
    s = pandas.Series(v, index=pandas.date_range("2020-01-01", periods=5, freq="8h"))
    with FuseMode.context(mode):
        _same(tpd.Series(s).resample("D").mean(), s.resample("D").mean())
        _same(tpd.DataFrame({"v": s}).resample("D").mean(), pandas.DataFrame({"v": s}).resample("D").mean())


@pytest.mark.parametrize("mode", ["Fused", "Staged"])
@pytest.mark.parametrize("case", list(FRAMES))
def test_fused_plan_mean_follows_pandas(tmp_path, case, mode):
    """``read_csv(p).query("k >= 0").groupby("k").mean()``: under Fused the
    planner's masked groupby (``groupagg``) answers, under Staged the eager
    one."""
    path = str(tmp_path / "ints.csv")
    FRAMES[case].to_csv(path, index=False)
    dispatches = fuse.DISPATCHES
    with PlanMode.context("Auto"), FuseMode.context(mode):
        got = _to_pandas(tpd.read_csv(path).query("k >= 0").groupby("k").mean())
    assert fuse.DISPATCHES - dispatches == int(mode == "Fused")
    _same(got, pandas.read_csv(path).query("k >= 0").groupby("k").mean())


def test_mean_of_bool_and_narrow_ints_is_unchanged():
    rng = np.random.default_rng(7)
    df = pandas.DataFrame({"k": rng.integers(0, 4, 600), "b": rng.integers(0, 2, 600).astype(bool),
                           "i8": rng.integers(-128, 128, 600).astype(np.int8)})
    for mode in ("Staged", "Fused"):
        with FuseMode.context(mode):
            _same(tpd.DataFrame(df).groupby("k").mean(), df.groupby("k").mean())
