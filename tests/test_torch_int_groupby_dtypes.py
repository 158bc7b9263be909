"""Narrow-int grouped sums and the column reductions' dtypes, held to pandas.

The port's grouped and resampled ``sum``/``mean``/``prod`` of narrow ints
add and multiply in int64 (uint64 bits for unsigned) and give pandas'
dtype: the column's own where every group's result fits it, else int64 or
uint64.  Column reductions give pandas' result dtype per op and column
dtype, and the frame's common dtype across columns (object where bools meet
numbers).  Values: ints exactly; a float32 sum, which pandas adds in
float32 and the port in float64, to rtol 1e-6; every other float to rtol
1e-12.  The JAX package wraps such sums (ROADMAP Queue 3 item 4), so these
cases are held to pandas alone.
"""

import numpy as np
import pandas
import pytest

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch.config import PlanMode

INT_DTYPES = ["int8", "uint8", "int16", "uint16", "int32"]


@pytest.fixture(autouse=True)
def _cpu_device():
    modin_tpu_torch.set_device("cpu")


def _to_pandas(obj):
    return obj._to_pandas() if hasattr(obj, "_to_pandas") else obj


def _same(got, want, rtol=1e-12):
    got = _to_pandas(got)
    if isinstance(want, pandas.DataFrame):
        pandas.testing.assert_frame_equal(got, want, check_exact=False, rtol=rtol)
    else:
        pandas.testing.assert_series_equal(got, want, check_exact=False, rtol=rtol)


def _frame(dtype, n=3000, groups=3, big=True):
    info = np.iinfo(dtype)
    v = (np.arange(n) % 120 + 100) if big else (np.arange(n) % 2)
    return pandas.DataFrame({"k": np.arange(n) % groups, "v": v.astype(dtype)})


def test_the_repro_gives_pandas_values_and_dtype():
    df = _frame("int8")
    got = _to_pandas(tpd.DataFrame(df).groupby("k").sum())
    assert got["v"].tolist() == [-33500, -38900, -37900]
    assert got["v"].dtype == np.int64
    _same(got, df.groupby("k").sum())


@pytest.mark.parametrize("dtype", INT_DTYPES)
@pytest.mark.parametrize("agg", ["sum", "mean", "prod"])
@pytest.mark.parametrize("big", [True, False])
def test_grouped_narrow_ints_follow_pandas(dtype, agg, big):
    df = _frame(dtype, big=big)
    _same(getattr(tpd.DataFrame(df).groupby("k"), agg)(), getattr(df.groupby("k"), agg)())
    _same(getattr(tpd.DataFrame(df).groupby("k")["v"], agg)(), getattr(df.groupby("k")["v"], agg)())


@pytest.mark.parametrize("dtype", INT_DTYPES)
@pytest.mark.parametrize("agg", ["sum", "mean", "prod"])
def test_grouped_transform_of_narrow_ints_follows_pandas(dtype, agg):
    df = _frame(dtype, n=300)
    _same(tpd.DataFrame(df).groupby("k")["v"].transform(agg), df.groupby("k")["v"].transform(agg))


@pytest.mark.parametrize("dtype", INT_DTYPES)
@pytest.mark.parametrize("agg", ["sum", "mean", "prod"])
@pytest.mark.parametrize("freq", ["12h", "2D"])  # full bins / empty bins between values
def test_resampled_narrow_ints_follow_pandas(dtype, agg, freq):
    n = 40
    values = (np.arange(n) % 120 + 100).astype(dtype)
    s = pandas.Series(values, index=pandas.date_range("2020-01-01", periods=n, freq=freq))
    _same(getattr(tpd.Series(s).resample("D"), agg)(), getattr(s.resample("D"), agg)())


def test_fused_groupby_of_a_narrow_int_follows_pandas(tmp_path):
    df = _frame("int8")
    df["a"] = np.arange(len(df)) % 7
    path = str(tmp_path / "n.csv")
    df.to_csv(path, index=False)
    with PlanMode.context("Auto"):
        from modin_tpu_torch.config import FuseMode

        with FuseMode.context("Fused"):
            got = tpd.read_csv(path, dtype={"v": "int8"}).query("a > 0").groupby("k").sum()
    want = pandas.read_csv(path, dtype={"v": "int8"}).query("a > 0").groupby("k").sum()
    _same(got, want)


REDUCTION_CASES = [
    (["f32"], "sum"), (["f32"], "prod"), (["f32"], "mean"), (["f32"], "min"), (["f32"], "max"), (["f32"], "var"),
    (["f16"], "sum"), (["f16"], "mean"), (["f16"], "min"), (["f16"], "max"), (["f16"], "var"), (["f16"], "prod"),
    (["i8"], "min"), (["i8"], "max"), (["i16"], "min"), (["i32"], "max"), (["u8"], "min"),
    (["u8"], "sum"), (["u8"], "prod"), (["i8", "u8"], "prod"), (["i8", "u8"], "sum"), (["i8", "u8"], "max"),
    (["f32", "i8"], "sum"), (["f32", "i8"], "max"), (["f32", "f64"], "mean"), (["i8", "b"], "max"),
    (["i8", "b"], "sum"), (["b"], "min"), (["i8"], "count"), (["f32"], "std"), (["u8"], "mean"),
]


def _reduction_frame():
    rng = np.random.default_rng(4)
    n = 500
    return pandas.DataFrame({
        "f32": rng.normal(size=n).astype(np.float32),
        "f16": rng.normal(size=n).astype(np.float16),
        "f64": rng.normal(size=n),
        "i8": rng.integers(-100, 100, n).astype(np.int8),
        "i16": rng.integers(-1000, 1000, n).astype(np.int16),
        "i32": rng.integers(-10**6, 10**6, n).astype(np.int32),
        "u8": rng.integers(0, 250, n).astype(np.uint8),
        "b": rng.integers(0, 2, n).astype(bool),
    })


@pytest.mark.parametrize("cols,op", REDUCTION_CASES, ids=[f"{'+'.join(c)}-{op}" for c, op in REDUCTION_CASES])
def test_column_reductions_give_pandas_dtypes(cols, op):
    df = _reduction_frame()
    got = _to_pandas(getattr(tpd.DataFrame(df)[cols], op)())
    want = getattr(df[cols], op)()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    # pandas adds a float32 column in float32, the port in float64
    rtol = 1e-6 if "f32" in cols else 1e-12
    if "f16" in cols:
        rtol = 1e-3  # pandas adds float16 in float16
    if want.dtype == object:
        assert [type(v) for v in got] == [type(v) for v in want]
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64), rtol=rtol)


@pytest.mark.parametrize("op", ["mean", "sum", "max", "var"])
def test_row_reductions_of_float32_keep_float32(op):
    df = _reduction_frame()[["f32", "i8"]]
    got = _to_pandas(getattr(tpd.DataFrame(df), op)(axis=1))
    want = getattr(df, op)(axis=1)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got.to_numpy(np.float64), want.to_numpy(np.float64), rtol=1e-5)


def test_series_reductions_give_pandas_scalars():
    df = _reduction_frame()
    for col, op in (("f32", "sum"), ("u8", "sum"), ("i8", "max"), ("f32", "mean")):
        got = getattr(tpd.Series(df[col]), op)()
        want = getattr(df[col], op)()
        assert np.asarray(got).dtype == np.asarray(want).dtype, (col, op)
