"""Datetimes in the torch port: ``.dt`` fields, ``resample``, bool sort and
merge keys, and ``read_csv(parse_dates=...)``.

``ops/datetime_parts.dt_component``/``td_component`` are held bit for bit
against the JAX package's functions of the same names on the same int64
ticks (padded JAX columns on the CPU mesh, the first ``n`` entries compared),
for every field and every unit (s, ms, us, ns): random ticks from 1900 to
2100, pre-1970 days, the 1900/2000/2024 leap rules, month and quarter
ends, and NaT.  Then the compiler's paths run through
``modin_tpu_torch.pandas``, ``modin_tpu.pandas`` and pandas: pandas' result
exactly (float aggregates of resample to rtol 1e-12, the sums taken in
another order), and no more defaults to pandas than the JAX package counts
(none where it has none).  The resample matrix is ``tests/test_resample.py``'s.
"""

import threading
import warnings

import numpy as np
import pandas
import pytest
import torch

import modin_tpu.pandas as mpd
from modin_tpu.ops import datetime_parts as jax_datetime_parts
from modin_tpu.ops import structural as jax_structural
from modin_tpu.parallel.engine import JaxWrapper
from modin_tpu.utils import to_pandas as jax_to_pandas

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch.core.dataframe.torch.dataframe import DeviceColumn
from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
from modin_tpu_torch.ops import datetime_parts

N = 2003  # not a multiple of the JAX mesh: its columns carry pad rows
NAT = np.iinfo(np.int64).min
TPS = {"s": 1, "ms": 10**3, "us": 10**6, "ns": 10**9}


@pytest.fixture(autouse=True)
def _cpu_device():
    modin_tpu_torch.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _join_jax_watchdog_threads():
    """Let the JAX package's per-fetch watchdog threads end before the next
    test file runs in this worker (``tests/test_watch.py`` counts threads)."""
    yield
    for t in threading.enumerate():
        if t.name.startswith("modin-tpu-watchdog"):
            t.join(timeout=5)


# days that decide the calendar rules: leap days and their neighbours (1900
# is no leap year, 2000 and 2024 are), month and quarter ends, the epoch
SPECIAL_DAYS = [
    "1900-01-01", "1900-02-28", "1900-03-01", "1900-12-31", "1904-02-29", "1969-12-31",
    "1970-01-01", "1999-12-31", "2000-02-28", "2000-02-29", "2000-03-01", "2000-03-31",
    "2000-06-30", "2000-09-30", "2000-12-31", "2023-02-28", "2024-02-29", "2024-04-30",
    "2024-07-01", "2100-02-28", "2100-03-01",
]


def _ticks(unit: str, nat: bool, n: int = N, seed: int = 0) -> np.ndarray:
    """int64 ticks of ``unit``: random instants from 1900 to 2100 (half of
    them before 1970), then every special day at a random time of day, and
    NaT in every 17th row when ``nat``."""
    rng = np.random.default_rng(seed)
    tps = TPS[unit]
    lo = -2208988800 * tps  # 1900-01-01
    hi = 4102444800 * tps  # 2100-01-01
    t = rng.integers(lo, hi, n)
    days = np.array([np.datetime64(d, "D").astype(np.int64) for d in SPECIAL_DAYS])
    tod = rng.integers(0, 86400 * tps, len(days))
    tod[:3] = [0, 86400 * tps - 1, 1]  # midnight, the day's last tick, its first after midnight
    t[: len(days)] = days * 86400 * tps + tod
    if nat:
        t[5::17] = NAT
    return t


def _jax(values: np.ndarray):
    return JaxWrapper.put(jax_structural.pad_host(np.asarray(values)))


def _assert_bitwise(got, dtype, want, want_dtype) -> None:
    got = got.numpy()
    want = np.asarray(want)[: len(got)]
    assert np.dtype(dtype) == np.dtype(want_dtype) == got.dtype, (dtype, want_dtype, got.dtype)
    if got.dtype.kind == "f":
        np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
    else:
        np.testing.assert_array_equal(got, want)


def _assert_within_ulps(got, dtype, want, want_dtype, ulps: int) -> None:
    got = got.numpy()
    want = np.asarray(want)[: len(got)]
    assert np.dtype(dtype) == np.dtype(want_dtype) == got.dtype == np.float64
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(got)
    assert np.abs(got[ok].view(np.int64) - want[ok].view(np.int64)).max(initial=0) <= ulps


# ---------------------------------------------------------------------- #
# the field functions against the JAX package's
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("unit", datetime_parts.UNITS)
@pytest.mark.parametrize("name", datetime_parts.COMPONENT_NAMES)
def test_dt_component_bitwise(name, unit):
    """Every calendar field, with and without NaT (float64 with NaN, and
    int32), bit for bit the JAX package's and equal to pandas'."""
    for nat in (False, True):
        t = _ticks(unit, nat)
        got, dtype = datetime_parts.dt_component(name, torch.as_tensor(t), unit)
        want, want_dtype = jax_datetime_parts.dt_component(name, _jax(t), unit, N)
        _assert_bitwise(got, dtype, want, want_dtype)
        expected = getattr(pandas.Series(t.view(f"datetime64[{unit}]")).dt, name)
        np.testing.assert_array_equal(got.numpy(), expected.to_numpy())
        assert got.numpy().dtype == expected.dtype


@pytest.mark.parametrize("unit", datetime_parts.UNITS)
@pytest.mark.parametrize("name", datetime_parts.TIMEDELTA_COMPONENT_NAMES)
def test_td_component_bitwise(name, unit):
    """Every timedelta field of differences of both signs, with and without
    NaT, bit for bit the JAX package's and equal to pandas'."""
    for nat in (False, True):
        t = _ticks(unit, nat)
        d = np.where(t == NAT, NAT, t - np.int64(10**9) * TPS[unit])  # ~31 years back
        got, dtype = datetime_parts.td_component(name, torch.as_tensor(d), unit)
        want, want_dtype = jax_datetime_parts.td_component(name, _jax(d), unit, N)
        s = pandas.Series(d.view(f"timedelta64[{unit}]"))
        expected = s.dt.total_seconds() if name == "total_seconds" else getattr(s.dt, name)
        np.testing.assert_array_equal(got.numpy(), expected.to_numpy())
        assert got.numpy().dtype == expected.dtype
        if name == "total_seconds":
            # pandas divides the ticks by the ticks per second, as the port
            # does; XLA's division in the JAX package is one unit in the
            # last place off it in some values
            _assert_within_ulps(got, dtype, want, want_dtype, 1)
        else:
            _assert_bitwise(got, dtype, want, want_dtype)


def test_unknown_field_raises():
    with pytest.raises(ValueError):
        datetime_parts.dt_component("week", torch.zeros(3, dtype=torch.int64), "ns")
    with pytest.raises(ValueError):
        datetime_parts.td_component("hours", torch.zeros(3, dtype=torch.int64), "ns")


# ---------------------------------------------------------------------- #
# through the three packages
# ---------------------------------------------------------------------- #


def _run(fn, make_args):
    """(pandas' result or error, the JAX package's count of defaults, the
    port's result or error, the port's count of defaults); ``make_args(pd)``
    builds the inputs in one package."""
    def attempt(pd, convert):
        try:
            return convert(fn(*make_args(pd)))
        except Exception as err:  # the reference's own error is the answer
            return err

    def unwrap(to_pandas):
        return lambda r: to_pandas(r) if hasattr(r, "_query_compiler") else r

    want = attempt(pandas, lambda r: r)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        attempt(mpd, unwrap(jax_to_pandas))
    jax_defaults = sum("defaulting to in-process pandas" in str(w.message) for w in caught)
    before = tqc.DEFAULTS_TO_PANDAS
    got = attempt(tpd, unwrap(tpd.to_pandas))
    return want, jax_defaults, got, tqc.DEFAULTS_TO_PANDAS - before


def _assert_same(got, want, exact: bool = True):
    if isinstance(want, Exception):
        assert type(got) is type(want), (got, want)
    elif isinstance(want, pandas.DataFrame):
        pandas.testing.assert_frame_equal(got, want, check_exact=exact, rtol=1e-12)
    else:
        pandas.testing.assert_series_equal(got, want, check_exact=exact, rtol=1e-12)


def _check(fn, make_args, exact: bool = True):
    """pandas' result, and no more defaults than the JAX package (none
    where it has none)."""
    want, jax_defaults, got, defaults = _run(fn, make_args)
    _assert_same(got, want, exact)
    assert defaults <= jax_defaults, (defaults, jax_defaults)
    return defaults, jax_defaults


def _dt_series(unit: str, nat: bool = True):
    t = _ticks(unit, nat, seed=3)
    return lambda pd: (pd.Series(t.view(f"datetime64[{unit}]"), name="ts"),)


@pytest.mark.parametrize("name", datetime_parts.COMPONENT_NAMES)
def test_dt_fields_through_the_packages(name):
    for unit in datetime_parts.UNITS:
        for nat in (False, True):
            assert _check(lambda s: getattr(s.dt, name), _dt_series(unit, nat)) == (0, 0)


@pytest.mark.parametrize("name", datetime_parts.TIMEDELTA_COMPONENT_NAMES)
def test_td_fields_through_the_packages(name):
    t = _ticks("us", True, seed=3)
    d = np.where(t == NAT, NAT, t - np.datetime64("2000-01-01", "us").astype(np.int64))

    def make(pd):
        return (pd.Series(d.view("timedelta64[us]"), name="td"),)

    field = (lambda d: d.dt.total_seconds()) if name == "total_seconds" else (lambda d: getattr(d.dt, name))
    assert _check(field, make) == (0, 0)


def test_tz_aware_fields_stay_with_pandas():
    t = pandas.DatetimeIndex(_ticks("ns", False, seed=3).view("datetime64[ns]")).tz_localize("UTC")

    def make(pd):
        return (pd.Series(t, name="ts"),)

    defaults, jax_defaults = _check(lambda s: s.dt.hour, make)
    assert defaults == jax_defaults == 1


def _dated_frame(pd):
    rng = np.random.default_rng(11)
    t = _ticks("us", True, seed=4)
    return (pd.DataFrame({
        "ts": t.view("datetime64[us]"),
        "v": np.where(rng.random(N) < 0.1, np.nan, rng.normal(size=N)),
        "q": rng.integers(0, 100, N),
    }),)


DT_GROUPBY = {
    "year_sum": lambda d: d.groupby(d.ts.dt.year)[["v", "q"]].sum(),
    "month_mean": lambda d: d[["v", "q"]].groupby(d.ts.dt.month).mean(),
    "quarter_count": lambda d: d.groupby(d.ts.dt.quarter)["v"].count(),
    "year_dropna_false": lambda d: d.groupby(d.ts.dt.year, dropna=False)[["q"]].sum(),
    "year_month_sum": lambda d: d.groupby([d.ts.dt.year, d.ts.dt.month])[["v", "q"]].sum(),
    "year_month_mean": lambda d: d.groupby([d.ts.dt.year, d.ts.dt.month])[["v", "q"]].mean(),
    "year_month_count": lambda d: d.groupby([d.ts.dt.year, d.ts.dt.month])["v"].count(),
}


@pytest.mark.parametrize("query", sorted(DT_GROUPBY))
def test_groupby_on_dt_keys(query):
    """Keys made by ``.dt`` fields, one Series or a list of them (which the
    port runs on the device and the JAX package sends to pandas)."""
    assert _check(DT_GROUPBY[query], _dated_frame, exact=False)[0] == 0


# ---------------------------------------------------------------------- #
# resample
# ---------------------------------------------------------------------- #


def _tick_frames(pd):
    rng = np.random.default_rng(41)
    n = 1500
    idx = pd.DatetimeIndex(
        pandas.Timestamp("2024-03-01 06:30") + pandas.to_timedelta(np.sort(rng.integers(0, 86400 * 3, n)), unit="s")
    )
    data = {"v": np.where(rng.random(n) < 0.15, np.nan, rng.normal(size=n)), "q": rng.integers(0, 100, n)}
    return (pd.DataFrame(data, index=idx),)


def _calendar_frames(pd):
    rng = np.random.default_rng(43)
    idx = pd.date_range("2023-11-07", periods=400, freq="31h")
    data = {"v": np.where(rng.random(400) < 0.1, np.nan, rng.normal(size=400)), "q": rng.integers(0, 50, 400)}
    return (pd.DataFrame(data, index=idx),)


@pytest.mark.parametrize("rule", ["5min", "h", "1D", "90s", "2h"])
@pytest.mark.parametrize("agg", ["sum", "mean", "count", "min", "max", "var", "std", "size"])
def test_resample_device_matrix(rule, agg):
    assert _check(lambda d: getattr(d.resample(rule), agg)(), _tick_frames, exact=False) == (0, 0)


@pytest.mark.parametrize("rule", ["ME", "MS", "W", "W-TUE", "QE", "YE", "B", "2W"])
@pytest.mark.parametrize("agg", ["sum", "mean", "count", "min", "max", "var", "std", "size"])
def test_resample_calendar_rules(rule, agg):
    assert _check(lambda d: getattr(d.resample(rule), agg)(), _calendar_frames, exact=False) == (0, 0)


@pytest.mark.parametrize(
    "kwargs",
    [{"closed": "left"}, {"label": "left"}, {"closed": "right", "label": "right"},
     {"closed": "left", "label": "left"}],
)
def test_resample_closed_label(kwargs):
    for agg in ("sum", "mean", "max"):
        query = lambda d: getattr(d.resample("ME", **kwargs), agg)()  # noqa: E731
        assert _check(query, _calendar_frames, exact=False) == (0, 0)
        query = lambda d: getattr(d.resample("h", **kwargs), agg)()  # noqa: E731
        assert _check(query, _tick_frames, exact=False) == (0, 0)


@pytest.mark.parametrize("kwargs", [{"origin": "epoch"}, {"offset": "17min"}, {"ddof": 0}])
def test_resample_origin_offset_ddof(kwargs):
    if "ddof" in kwargs:
        query = lambda d: d.resample("3h").var(**kwargs)  # noqa: E731
    else:
        query = lambda d: d.resample("3h", **kwargs).mean()  # noqa: E731
    assert _check(query, _calendar_frames, exact=False) == (0, 0)


@pytest.mark.parametrize("agg", ["mean", "size", "max", "var"])
def test_resample_series(agg):
    query = lambda d: getattr(d["v"].resample("QE"), agg)()  # noqa: E731
    assert _check(query, _calendar_frames, exact=False) == (0, 0)


@pytest.mark.parametrize("agg", ["sum", "min", "max", "count", "mean", "var"])
def test_resample_empty_buckets_promote_ints(agg):
    def make(pd):
        idx = pd.DatetimeIndex(["2024-01-01", "2024-01-02 13:00", "2024-01-05"])
        return (pd.DataFrame({"q": np.array([1, 2, 3], np.int32), "r": [4, 5, 6]}, index=idx),)

    assert _check(lambda d: getattr(d.resample("1D"), agg)(), make, exact=False) == (0, 0)


@pytest.mark.parametrize("agg", ["sum", "mean", "count", "min", "max", "std"])
def test_resample_bool_column(agg):
    """Bools sum and average as ints; min/max over empty buckets would give
    object, so both packages decline there."""
    def make(pd):
        (d,) = _tick_frames(pd)
        return (d.assign(b=d["q"] > 50),)

    for rule in ("h", "5min"):
        defaults, jax_defaults = _check(lambda d: getattr(d.resample(rule), agg)(), make, exact=False)
        assert defaults == jax_defaults


@pytest.mark.parametrize(
    "query",
    [
        lambda d: d.iloc[::-1].resample("ME").sum(),  # an unsorted index declines
        lambda d: d.resample("ME").median(),  # not among the device ops
        lambda d: d.resample("ME").sum(numeric_only=True),
        lambda d: d["v"].resample("6h").ohlc(),
        lambda d: d.resample("6h").agg({"v": "mean", "q": "sum"}),
    ],
    ids=["unsorted", "median", "numeric_only", "ohlc", "agg_dict"],
)
def test_resample_declines_where_the_jax_package_does(query):
    defaults, jax_defaults = _check(query, _calendar_frames, exact=False)
    assert defaults == jax_defaults >= 1


def test_resample_tz_aware_index():
    def make(pd):
        (d,) = _calendar_frames(pandas)
        return (pd.DataFrame(d.tz_localize("US/Pacific")),)

    assert _check(lambda d: d.resample("ME").sum(), make, exact=False)[0] == 0


def test_resample_runs_on_the_device():
    (p,) = _calendar_frames(pandas)
    before = tqc.DEFAULTS_TO_PANDAS
    result = tpd.DataFrame(p).resample("W").mean()
    assert tqc.DEFAULTS_TO_PANDAS == before
    assert all(isinstance(c, DeviceColumn) for c in result._query_compiler._modin_frame._columns)


# ---------------------------------------------------------------------- #
# bool sort and merge keys
# ---------------------------------------------------------------------- #


def _bool_frames(pd):
    rng = np.random.default_rng(17)
    left = pd.DataFrame({
        "b": rng.random(N) < 0.3,
        "q": rng.integers(0, 5, N),
        "v": rng.normal(size=N),
    })
    right = pd.DataFrame({"b": [True, False, True], "w": [1.5, 2.5, 3.5], "c": [False, False, True]})
    return left, right


BOOL_KEY_QUERIES = {
    "sort_one": lambda l, r: l.sort_values("b", kind="stable"),
    "sort_one_descending": lambda l, r: l.sort_values("b", ascending=False, kind="stable"),
    "sort_bool_int": lambda l, r: l.sort_values(["b", "q"]),
    "sort_int_bool_mixed": lambda l, r: l.sort_values(["q", "b"], ascending=[False, True]),
    "sort_ignore_index": lambda l, r: l.sort_values(["b", "q"], ignore_index=True),
    "series_sort": lambda l, r: l["b"].sort_values(kind="stable"),
    "merge_inner": lambda l, r: l.merge(r, on="b"),
    # pandas makes a bool payload with missing matches object: w only
    "merge_left": lambda l, r: l.merge(r[["b", "w"]], on="b", how="left"),
    "merge_left_with_misses": lambda l, r: l.merge(r[r["b"]][["b", "w"]], on="b", how="left"),
    "merge_right": lambda l, r: l.merge(r, on="b", how="right"),
    "merge_outer": lambda l, r: l.merge(r[["b", "w"]], on="b", how="outer"),
    "merge_two_keys": lambda l, r: l.assign(c=l["q"] > 2).merge(r, on=["b", "c"]),
    "merge_left_on_right_on": lambda l, r: l.merge(r, left_on="b", right_on="c"),
}


@pytest.mark.parametrize("query", sorted(BOOL_KEY_QUERIES))
def test_bool_sort_and_merge_keys(query):
    """Ties keep pandas' stable order; both packages run these on the
    device."""
    assert _check(BOOL_KEY_QUERIES[query], _bool_frames) == (0, 0)


def test_datetime_sort_keys_stay_with_pandas():
    def make(pd):
        (d,) = _dated_frame(pd)
        return (d,)

    defaults, jax_defaults = _check(lambda d: d.sort_values("ts", kind="stable"), make)
    assert defaults == jax_defaults == 1


# ---------------------------------------------------------------------- #
# read_csv(parse_dates=...)
# ---------------------------------------------------------------------- #


def test_read_csv_parse_dates_lands_on_the_device(tmp_path):
    """The parsed column is a device column of int64 ticks, equal to the JAX
    package's and to pandas' values."""
    rng = np.random.default_rng(5)
    ts = pandas.Series(_ticks("s", False, seed=6).view("datetime64[s]")).astype("datetime64[us]")
    ts[rng.random(N) < 0.05] = pandas.NaT
    path = tmp_path / "dated.csv"
    pandas.DataFrame({"ts": ts, "v": rng.normal(size=N)}).to_csv(path, index=False)
    want = pandas.read_csv(path, parse_dates=["ts"])
    got = tpd.read_csv(path, parse_dates=["ts"])
    col = got._query_compiler._modin_frame.get_column(0)
    assert isinstance(col, DeviceColumn) and col.data.dtype == torch.int64
    assert col.pandas_dtype == want["ts"].dtype
    jax_col = mpd.read_csv(path, parse_dates=["ts"])._query_compiler._modin_frame.get_column(0)
    np.testing.assert_array_equal(col.data.numpy(), np.asarray(jax_col.data)[:N])
    pandas.testing.assert_frame_equal(tpd.to_pandas(got), want)
    assert _check(lambda s: s.dt.month, lambda pd: (pd.read_csv(path, parse_dates=["ts"])["ts"],)) == (0, 0)
