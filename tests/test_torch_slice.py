"""The whole slice: the asv main-path queries through ``modin_tpu.pandas``
(JAX on the CPU mesh) and ``modin_tpu_torch.pandas`` (torch on the CPU).

Frames come from the asv recipe (``asv_bench/benchmarks/utils.py::
make_frame``, copied here so that the benchmark module's import-time setup
stays out of the tests).  Both packages must give pandas' answer: ints and
labels exactly, floats to ``rtol=1e-12`` (sums in another order).  The port
must take its device paths for all of them (``DEFAULTS_TO_PANDAS`` does not
move), and a frame built with ``from_numpy_columns`` from the JAX frame's
own columns must answer the same.
"""

import numpy as np
import pandas
import pytest

import modin_tpu.pandas as mpd
from modin_tpu.utils import to_pandas as jax_to_pandas

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
from modin_tpu_torch.core.storage_formats.torch.query_compiler import (
    TorchQueryCompiler,
)


@pytest.fixture(autouse=True)
def _cpu_device():
    modin_tpu_torch.set_device("cpu")


def make_data(shape, seed=0, ngroups=None):
    rng = np.random.default_rng(seed)
    rows, cols = shape
    data = {f"col{i}": rng.integers(0, 100, rows) for i in range(cols)}
    if ngroups is not None:
        data["groupby_col"] = rng.integers(0, ngroups, rows)
    return data


QUERIES = {
    "add": lambda df, df2: df.add(2),
    "mul": lambda df, df2: df.mul(2),
    "mod": lambda df, df2: df.mod(2),
    "abs": lambda df, df2: df.abs(),
    "df_plus_df": lambda df, df2: df + df2,
    "gt": lambda df, df2: df > 50,
    "sum": lambda df, df2: df.sum(),
    "mean": lambda df, df2: df.mean(),
    "count": lambda df, df2: df.count(),
    "groupby_count": lambda df, df2: df.groupby("groupby_col").count(),
    "groupby_size": lambda df, df2: df.groupby("groupby_col").size(),
    "groupby_sum": lambda df, df2: df.groupby("groupby_col").sum(),
    "groupby_mean": lambda df, df2: df.groupby("groupby_col").mean(),
}


def _assert_equal(got, want):
    if isinstance(want, pandas.DataFrame):
        pandas.testing.assert_frame_equal(got, want, rtol=1e-12)
    else:
        pandas.testing.assert_series_equal(got, want, rtol=1e-12)


@pytest.mark.parametrize("query", sorted(QUERIES))
@pytest.mark.parametrize("ngroups", [10, 100])
def test_main_path_query(query, ngroups):
    d1 = make_data((2000, 10), ngroups=ngroups)
    d2 = make_data((2000, 10), seed=1, ngroups=ngroups)
    fn = QUERIES[query]
    want = fn(pandas.DataFrame(d1), pandas.DataFrame(d2))
    from_jax = jax_to_pandas(fn(mpd.DataFrame(d1), mpd.DataFrame(d2)))
    defaults = tqc.DEFAULTS_TO_PANDAS
    from_torch = tpd.to_pandas(fn(tpd.DataFrame(d1), tpd.DataFrame(d2)))
    assert tqc.DEFAULTS_TO_PANDAS == defaults, "a main-path query left the device"
    _assert_equal(from_jax, want)
    _assert_equal(from_torch, want)
    _assert_equal(from_torch, from_jax)


def _from_jax_columns(mdf) -> tpd.DataFrame:
    frame = mdf._query_compiler._modin_frame
    columns = {
        label: frame.get_column(i).to_numpy()
        for i, label in enumerate(frame.columns)
    }
    return tpd.DataFrame(query_compiler=TorchQueryCompiler.from_numpy_columns(columns))


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_from_numpy_columns_of_jax_frame(query):
    d1 = make_data((2000, 10), ngroups=100)
    d2 = make_data((2000, 10), seed=1, ngroups=100)
    fn = QUERIES[query]
    m1, m2 = mpd.DataFrame(d1), mpd.DataFrame(d2)
    want = jax_to_pandas(fn(m1, m2))
    defaults = tqc.DEFAULTS_TO_PANDAS
    got = tpd.to_pandas(fn(_from_jax_columns(m1), _from_jax_columns(m2)))
    assert tqc.DEFAULTS_TO_PANDAS == defaults
    _assert_equal(got, want)


def _float_frame(seed: int) -> pandas.DataFrame:
    rng = np.random.default_rng(seed)
    n = 5000
    key = rng.integers(0, 40, n) / 8.0
    key[rng.random(n) < 0.03] = np.nan
    val = rng.normal(0, 100, n)
    val[rng.random(n) < 0.01] = np.nan
    return pandas.DataFrame({"key": key, "val": val, "ival": rng.integers(0, 9, n)})


FLOAT_QUERIES = {
    f"groupby_{agg}_dropna{dropna}": (
        lambda df, agg=agg, dropna=dropna: getattr(df.groupby("key", dropna=dropna), agg)()
    )
    for agg in ("sum", "mean", "count", "min", "max", "size")
    for dropna in (True, False)
}
FLOAT_QUERIES.update({
    f"{op}_skipna{skipna}": (lambda df, op=op, skipna=skipna: getattr(df, op)(skipna=skipna))
    for op in ("sum", "mean", "min", "max")
    for skipna in (True, False)
})


@pytest.mark.parametrize("query", sorted(FLOAT_QUERIES))
def test_float_keys_and_nan(query):
    pdf = _float_frame(3)
    fn = FLOAT_QUERIES[query]
    want = fn(pdf)
    from_jax = jax_to_pandas(fn(mpd.DataFrame(pdf)))
    defaults = tqc.DEFAULTS_TO_PANDAS
    from_torch = tpd.to_pandas(fn(tpd.DataFrame(pdf)))
    assert tqc.DEFAULTS_TO_PANDAS == defaults
    _assert_equal(from_torch, want)
    _assert_equal(from_torch, from_jax)


def test_series_reductions_and_arithmetic():
    d = make_data((500, 2))
    pdf, tdf = pandas.DataFrame(d), tpd.DataFrame(d)
    assert tdf["col0"].sum() == pdf["col0"].sum()
    assert tdf["col0"].max() == pdf["col0"].max()
    _assert_equal(tpd.to_pandas(tdf["col0"] * 3 - tdf["col1"]), pdf["col0"] * 3 - pdf["col1"])


@pytest.mark.parametrize(
    "query",
    [
        lambda df: df.floordiv(0),  # int // 0 promotes to float in pandas 3
        lambda df: df.groupby("groupby_col", as_index=False).sum(),
        lambda df: df.sum(axis=1),
    ],
    ids=["int_floordiv_zero", "as_index_false", "sum_axis1"],
)
def test_declined_queries_default_to_pandas(query):
    d = make_data((300, 3), ngroups=7)
    defaults = tqc.DEFAULTS_TO_PANDAS
    got = tpd.to_pandas(query(tpd.DataFrame(d)))
    assert tqc.DEFAULTS_TO_PANDAS == defaults + 1
    _assert_equal(got, query(pandas.DataFrame(d)))
