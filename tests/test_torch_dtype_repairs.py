"""Result dtypes of the torch port held to pandas where they once differed.

- grouped ``cumsum``/``cumprod``/``cummax``/``cummin`` of int8-uint32
  columns, through ``DataFrameGroupBy`` and ``SeriesGroupBy``, with results
  inside and past the narrow range (pandas keeps the dtype where every value
  fits, else widens to int64, uint64 for unsigned columns);
- the name of ``size()``: a ``SeriesGroupBy`` names it after its column (or
  the grouped Series), a ``DataFrameGroupBy`` leaves it unnamed;
- grouped and resampled sums of narrow ints: pandas picks the dtype per
  block, so same-dtype columns that shared a block in the frame
  ``from_pandas`` was given widen together, while a ``read_csv`` frame (one
  block a column) keeps each column's own;
- float16 and float32 corners: grouped float16 sums, means, products,
  cumulative sums and variances in float32 and medians in float64,
  ``value_counts`` of float16, and the scalar type of ``Series.quantile``
  of a float32 column with a NaN.

Ints and dtypes exactly; float16/float32 values to rtol 1e-6 of pandas'
(pandas sums float32 with its own order).
"""

import io

import numpy as np
import pandas
import pytest

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc

NARROW = ["int8", "int16", "int32", "uint8", "uint16", "uint32"]
CUM_OPS = ["cumsum", "cumprod", "cummax", "cummin"]


@pytest.fixture(autouse=True)
def _cpu():
    modin_tpu_torch.set_device("cpu")


def _pd(obj):
    return obj._to_pandas() if hasattr(obj, "_to_pandas") else obj


def _assert_same(got, want):
    got = _pd(got)
    if isinstance(want, pandas.Series):
        pandas.testing.assert_series_equal(got, want)
    else:
        pandas.testing.assert_frame_equal(got, want)


def _cum_values(kind):
    # small: every result fits the narrow dtype; wide: the sums and
    # products pass it (300 rows in three groups)
    n = 300
    if kind == "small":
        return np.where(np.arange(n) % 50 == 0, 2, 1)
    return np.arange(n) % 7 + 1


@pytest.mark.parametrize("values", ["small", "wide"])
@pytest.mark.parametrize("op", CUM_OPS)
@pytest.mark.parametrize("dtype", NARROW)
def test_grouped_cumulative_of_narrow_ints(dtype, op, values):
    k = np.tile([0, 1, 2], 100)
    x = _cum_values(values).astype(dtype)
    p = pandas.DataFrame({"k": k, "x": x, "y": x[::-1].copy()})
    t = tpd.DataFrame(p)
    _assert_same(getattr(t.groupby("k")["x"], op)(), getattr(p.groupby("k")["x"], op)())
    _assert_same(getattr(t.groupby("k"), op)(), getattr(p.groupby("k"), op)())


def test_grouped_cumulative_past_the_range_example():
    # the case that used to wrap: int8 cumsum 401 (int64), cumprod past 2^62
    k = np.tile([0, 1, 2], 100)
    x = (np.arange(300) % 7 + 1).astype(np.int8)
    p = pandas.DataFrame({"k": k, "x": x})
    t = tpd.DataFrame(p)
    got = _pd(t.groupby("k")["x"].cumsum())
    assert got.dtype == np.int64 and got.iloc[-1] == 401
    got = _pd(t.groupby("k")["x"].cumprod())
    assert got.dtype == np.int64 and got.iloc[-1] == p.groupby("k")["x"].cumprod().iloc[-1]


@pytest.mark.parametrize("as_index", [True, False])
def test_series_groupby_size_keeps_the_name(as_index):
    p = pandas.DataFrame({"k": [1, 1, 2, 3, 3, 3], "x": [1.0, 2, 3, 4, 5, 6]})
    t = tpd.DataFrame(p)
    want = p.groupby("k", as_index=as_index)["x"].size()
    got = _pd(t.groupby("k", as_index=as_index)["x"].size())
    _assert_same(got, want)
    if as_index:
        assert got.name == "x"


def test_other_size_names_follow_pandas():
    p = pandas.DataFrame({"k": [1, 1, 2, 3, 3, 3], "x": [1.0, 2, 3, 4, 5, 6]})
    t = tpd.DataFrame(p)
    _assert_same(t.groupby("k").size(), p.groupby("k").size())
    assert p.groupby("k").size().name is None
    _assert_same(t["x"].groupby(t["k"]).size(), p["x"].groupby(p["k"]).size())
    _assert_same(t.groupby("k", as_index=False).size(), p.groupby("k", as_index=False).size())


_K = np.repeat([0, 1], 100)
_X = np.ones(200, np.int8)  # sums of 100: fit int8
_Y = np.full(200, 100, np.int8)  # sums of 10000: past int8
_F = np.ones(200)

BLOCK_LAYOUTS = [
    {"k": _K, "x": _X, "y": _Y},
    {"k": _K, "x": _X, "y": _Y, "f": _F},
    {"k": _K, "x": _X, "f": _F, "y": _Y},
    {"x": _X, "k": _K, "y": _Y},
    {"k": _K, "x": _X, "f": _F, "w": _X, "y": _Y},
    {"k": _K, "x": _X, "y": _Y, "z": np.ones(200, np.int16), "w": np.full(200, 1000, np.int16)},
    {"k": _K, "x": _X.astype(np.uint8), "y": np.full(200, 200, np.uint8)},
]


@pytest.mark.parametrize("layout", range(len(BLOCK_LAYOUTS)))
def test_grouped_sum_widens_by_block(layout):
    data = BLOCK_LAYOUTS[layout]
    p = pandas.DataFrame(data)
    t = tpd.DataFrame(data)
    _assert_same(t.groupby("k").sum(), p.groupby("k").sum())
    _assert_same(t.groupby("k").cumsum(), p.groupby("k").cumsum())
    _assert_same(t.groupby("k")[["x", "y"]].sum(), p.groupby("k")[["x", "y"]].sum())
    sel = [c for c in data if c != "f"]
    _assert_same(t[sel].groupby("k").sum(), p[sel].groupby("k").sum())


@pytest.mark.parametrize("cols", [["x", "y"], ["x", "f", "y"], ["x", "y", "f"]])
def test_resampled_sum_widens_by_block(cols):
    idx = pandas.date_range("2024-01-01", periods=200, freq="h")
    data = {c: {"x": _X, "y": _Y, "f": _F}[c] for c in cols}
    p = pandas.DataFrame(data, index=idx)
    t = tpd.DataFrame(p)
    _assert_same(t.resample("D").sum(), p.resample("D").sum())


def test_read_csv_keeps_per_column_dtypes():
    p = pandas.DataFrame({"k": _K, "x": _X, "f": _F, "y": _Y})
    buf = io.StringIO()
    p.to_csv(buf, index=False)
    dtypes = {"x": "int8", "y": "int8"}
    want = pandas.read_csv(io.StringIO(buf.getvalue()), dtype=dtypes)
    got = tpd.read_csv(io.StringIO(buf.getvalue()), dtype=dtypes)
    assert [str(b.dtype) for b in want._mgr.blocks].count("int8") == 2  # one block a column
    _assert_same(got.groupby("k").sum(), want.groupby("k").sum())
    assert list(_pd(got.groupby("k").sum()).dtypes) == [np.int8, np.float64, np.int64]


@pytest.mark.parametrize(
    "op", ["sum", "mean", "prod", "cumsum", "cumprod", "var", "std", "sem", "median", "min", "max"]
)
@pytest.mark.parametrize("with_nan", [False, True])
def test_grouped_float16(op, with_nan):
    rng = np.random.default_rng(4)
    x = rng.normal(size=60).astype(np.float16)
    if with_nan:
        x[5] = np.nan
    p = pandas.DataFrame({"k": np.tile([0, 1, 2], 20), "x": x})
    t = tpd.DataFrame(p)
    defaults = tqc.DEFAULTS_TO_PANDAS
    got = _pd(getattr(t.groupby("k")["x"], op)())
    want = getattr(p.groupby("k")["x"], op)()
    assert tqc.DEFAULTS_TO_PANDAS == defaults
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got.to_numpy(np.float64), want.to_numpy(np.float64), rtol=1e-6)


@pytest.mark.parametrize("kwargs", [{}, {"dropna": False}, {"normalize": True}])
def test_value_counts_of_float16(kwargs):
    x = np.array([1.5, 1.5, 2.0, np.nan, 2.0, 2.0, 0.25], dtype=np.float16)
    _assert_same(tpd.Series(x).value_counts(**kwargs), pandas.Series(x).value_counts(**kwargs))


@pytest.mark.parametrize("dtype", ["float32", "float16", "float64"])
@pytest.mark.parametrize("with_nan", [False, True])
def test_quantile_scalar_type(dtype, with_nan):
    x = np.array([1.5, 3.0, 2.0, 7.25, 4.0], dtype=dtype)
    if with_nan:
        x[1] = np.nan
    want = pandas.Series(x).quantile(0.3)
    got = tpd.Series(x).quantile(0.3)
    assert type(got) is type(want)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_frame_quantile_dtype_follows_the_block():
    data = {
        "x": np.array([1.5, np.nan, 2, 4], dtype=np.float32),
        "y": np.array([1.5, 3, 2, 5], dtype=np.float32),
    }
    p = pandas.DataFrame(data)
    t = tpd.DataFrame(data)
    for cols in (["x", "y"], ["y"], ["x"]):
        want = p[cols].quantile(0.3)
        got = _pd(t[cols].quantile(0.3))
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got.to_numpy(np.float64), want.to_numpy(np.float64), rtol=1e-6)
