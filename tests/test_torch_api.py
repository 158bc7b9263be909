"""The third slice as a whole: the pandas API surface of the port and the rest
of asv ``TimeArithmetic`` through ``modin_tpu.pandas`` (JAX on the CPU
mesh), ``modin_tpu_torch.pandas`` (torch on the CPU) and pandas.

Frames come from the asv recipe (``asv_bench/benchmarks/utils.py::
make_frame``, copied here).  Every query must give pandas' answer through
both packages: ints and labels exactly, floats to ``rtol=1e-12`` (sums and
means in another order).  The port takes its device path for all of them
(``DEFAULTS_TO_PANDAS`` does not move) except ``apply``, ``aggregate`` with
a callable and ``transpose``, which default to pandas once each, as they do
in the JAX package.
"""

import inspect
import threading
import types

import numpy as np
import pandas
import pytest

import modin_tpu.pandas as mpd
from modin_tpu.utils import to_pandas as jax_to_pandas

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch.core.storage_formats.native.query_compiler import (
    NativeQueryCompiler,
)
from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
from modin_tpu_torch.core.storage_formats.torch.query_compiler import (
    TorchQueryCompiler,
)

FLOAT_RTOL = 1e-12


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


def make_data(shape, seed=0):
    rng = np.random.default_rng(seed)
    rows, cols = shape
    return {f"col{i}": rng.integers(0, 100, rows) for i in range(cols)}


def float_data(rows, seed=1):
    """Float columns with NaN, a bool column and a narrow int column: the
    dtypes and missing values the asv recipe does not have."""
    rng = np.random.default_rng(seed)
    f0 = rng.integers(0, 20, rows) / 4.0
    f0[rng.random(rows) < 0.1] = np.nan
    f1 = rng.normal(0, 10, rows)
    f1[rng.random(rows) < 0.05] = np.nan
    return {
        "f0": f0,
        "f1": f1,
        "i32": rng.integers(-5, 5, rows).astype(np.int32),
        "b": rng.random(rows) < 0.3,
    }


def _assert_equal(got, want):
    if isinstance(want, pandas.DataFrame):
        pandas.testing.assert_frame_equal(got, want, rtol=FLOAT_RTOL)
    elif isinstance(want, pandas.Series):
        pandas.testing.assert_series_equal(got, want, rtol=FLOAT_RTOL)
    else:
        assert got == want or (np.isnan(got) and np.isnan(want)), (got, want)


# (query, defaults the port counts): asv TimeArithmetic, every query at the
# axis it is given, plus quantile and describe
ARITHMETIC = {
    "sum": (lambda df, axis: df.sum(axis=axis), 0),
    "count": (lambda df, axis: df.count(axis=axis), 0),
    "median": (lambda df, axis: df.median(axis=axis), 0),
    "nunique": (lambda df, axis: df.nunique(axis=axis), 0),
    "apply": (lambda df, axis: df.apply(lambda d: d.sum(), axis=axis), 1),
    "mean": (lambda df, axis: df.mean(axis=axis), 0),
    "mode": (lambda df, axis: df.mode(axis=axis), 0),
    "add": (lambda df, axis: df.add(2, axis=axis), 0),
    "mul": (lambda df, axis: df.mul(2, axis=axis), 0),
    "mod": (lambda df, axis: df.mod(2, axis=axis), 0),
    "abs": (lambda df, axis: df.abs(), 0),
    "aggregate": (lambda df, axis: df.aggregate(lambda d: d.sum(), axis=axis), 1),
    "is_in": (lambda df, axis: df.isin([0, 2]), 0),
    "transpose": (lambda df, axis: df.transpose(), 1),
}
ARITHMETIC_CASES = [(name, axis) for name in sorted(ARITHMETIC) for axis in (0, 1)]
ARITHMETIC_CASES += [("quantile", 0), ("describe", 0)]
ARITHMETIC["quantile"] = (lambda df, axis: df.quantile([0.1, 0.5, 0.9]), 0)
ARITHMETIC["describe"] = (lambda df, axis: df.describe(), 0)


def _run_three(fn, data):
    want = fn(pandas.DataFrame(data))
    from_jax = jax_to_pandas(fn(mpd.DataFrame(data)))
    defaults = tqc.DEFAULTS_TO_PANDAS
    from_torch = tpd.to_pandas(fn(tpd.DataFrame(data)))
    return want, from_jax, from_torch, tqc.DEFAULTS_TO_PANDAS - defaults


@pytest.mark.parametrize("query,axis", ARITHMETIC_CASES)
def test_time_arithmetic(query, axis):
    fn, defaults = ARITHMETIC[query]
    want, from_jax, from_torch, counted = _run_three(
        lambda df: fn(df, axis), make_data((2000, 10))
    )
    assert counted == defaults, f"{query}(axis={axis}) counted {counted} defaults"
    _assert_equal(from_torch, want)
    _assert_equal(from_jax, want)


# the sort-shaped family and the row-wise reductions on NaN floats, bools
# and a narrow int dtype (pandas' own answers through the port's device
# paths; skipna both ways)
def _numeric(df):
    # pandas interleaves bool with numbers as object rows: the row-wise
    # reductions of such a frame default (test_bool_mixed_rows_default)
    return df[["f0", "f1", "i32"]]


FLOAT_QUERIES = {
    **{f"median_axis{a}": (lambda df, a=a: _numeric(df).median(axis=a)) for a in (0, 1)},
    **{f"median_noskip_axis{a}": (lambda df, a=a: _numeric(df).median(axis=a, skipna=False)) for a in (0, 1)},
    **{f"nunique_axis{a}": (lambda df, a=a: df.nunique(axis=a)) for a in (0, 1)},
    **{f"nunique_keepna_axis{a}": (lambda df, a=a: df.nunique(axis=a, dropna=False)) for a in (0, 1)},
    **{f"{op}_axis1": (lambda df, op=op: getattr(_numeric(df), op)(axis=1)) for op in ("sum", "mean", "min", "max", "count", "var", "std")},
    "sum_bools_axis1": lambda df: df[["b", "b"]].sum(axis=1),
    **{f"{op}_axis0": (lambda df, op=op: getattr(df, op)()) for op in ("var", "std", "sem", "prod", "any", "all")},
    "var_ddof0": lambda df: df.var(ddof=0),
    "std_noskip": lambda df: df.std(skipna=False),
    "mode_axis0": lambda df: df[["i32", "b"]].mode(),
    "mode_keepna_ints": lambda df: df[["i32"]].mode(dropna=False),
    "mode_axis1": lambda df: df[["f0", "i32"]].mode(axis=1),
    "quantile_lower": lambda df: df[["f0", "f1", "i32"]].quantile([0.2, 0.7], interpolation="lower"),
    "quantile_higher": lambda df: df[["f0", "f1", "i32"]].quantile([0.2, 0.7], interpolation="higher"),
    "quantile_midpoint": lambda df: df[["f0", "f1", "i32"]].quantile(0.3, interpolation="midpoint"),
    "describe_percentiles": lambda df: df[["f0", "f1", "i32"]].describe(percentiles=[0.05, 0.95]),
}


@pytest.mark.parametrize("query", sorted(FLOAT_QUERIES))
def test_float_nan_and_bool_columns(query):
    fn = FLOAT_QUERIES[query]
    want = fn(pandas.DataFrame(float_data(700)))
    defaults = tqc.DEFAULTS_TO_PANDAS
    got = tpd.to_pandas(fn(tpd.DataFrame(float_data(700))))
    assert tqc.DEFAULTS_TO_PANDAS == defaults, f"{query} left the device"
    _assert_equal(got, want)


def test_bool_mixed_rows_default():
    d = float_data(100)
    defaults = tqc.DEFAULTS_TO_PANDAS
    got = tpd.to_pandas(tpd.DataFrame(d).sum(axis=1))
    assert tqc.DEFAULTS_TO_PANDAS == defaults + 1
    _assert_equal(got, pandas.DataFrame(d).sum(axis=1))


def test_series_sort_shaped_reductions():
    d = float_data(500)
    ps, ts = pandas.Series(d["f1"], name="x"), tpd.Series(d["f1"], name="x")
    defaults = tqc.DEFAULTS_TO_PANDAS
    assert ts.median() == ps.median()
    assert ts.nunique() == ps.nunique()
    assert ts.quantile(0.25) == ps.quantile(0.25)
    _assert_equal(tpd.to_pandas(ts.quantile([0.25, 0.5])), ps.quantile([0.25, 0.5]))
    _assert_equal(tpd.to_pandas(ts.describe()), ps.describe())
    assert tqc.DEFAULTS_TO_PANDAS == defaults
    _assert_equal(tpd.to_pandas(tpd.Series(d["i32"]).mode()), pandas.Series(d["i32"]).mode())


# ---------------------------------------------------------------------- #
# the defaults: counted once each, and a wide transpose on the host
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize(
    "query",
    [
        lambda df: df.skew(axis=1),
        lambda df: df.cumsum(axis=1),
        # rank, round, nlargest and clip run on the device in their plain
        # forms; these forms of them still default
        lambda df: df.rank(axis=1),
        lambda df: df.round({"col0": 1}),
        lambda df: df.agg(["sum", "max"]),
        lambda df: df.shift(2, fill_value=0),
        lambda df: df.diff(axis=1),
        lambda df: df.pct_change(),
        lambda df: df.nlargest(3, ["col0", "col1"]),
        lambda df: df.melt(),
        lambda df: df.set_index("col0"),
        lambda df: df.clip(df["col0"] // 2, 20, axis=0),
    ],
    ids=[
        "skew", "cumsum", "rank", "round", "agg_list", "shift", "diff",
        "pct_change", "nlargest", "melt", "set_index", "clip",
    ],
)
def test_long_tail_defaults_once(query):
    d = make_data((300, 4), seed=5)
    defaults = tqc.DEFAULTS_TO_PANDAS
    got = tpd.to_pandas(query(tpd.DataFrame(d)))
    assert tqc.DEFAULTS_TO_PANDAS == defaults + 1
    _assert_equal(got, query(pandas.DataFrame(d)))


def test_wide_transpose_leaves_the_device():
    rows = TorchQueryCompiler._TRANSPOSE_WIDE_COLS + 10
    d = make_data((rows, 3), seed=2)
    tdf = tpd.DataFrame(d)
    defaults = tqc.DEFAULTS_TO_PANDAS
    t = tdf.T
    assert tqc.DEFAULTS_TO_PANDAS == defaults + 1
    assert isinstance(t._query_compiler, NativeQueryCompiler)
    assert t.shape == (3, rows)
    _assert_equal(tpd.to_pandas(t), pandas.DataFrame(d).T)
    # narrow: back on the device
    small = tpd.DataFrame(make_data((50, 3))).T
    assert isinstance(small._query_compiler, TorchQueryCompiler)


def test_setitem_row_defaults_instead_of_raising():
    d = make_data((20, 3), seed=3)
    qc = tpd.DataFrame(d)._query_compiler
    defaults = tqc.DEFAULTS_TO_PANDAS
    got = qc.setitem(1, 4, 7).to_pandas()
    assert tqc.DEFAULTS_TO_PANDAS == defaults + 1
    want = pandas.DataFrame(d)
    want.loc[4] = 7
    _assert_equal(got, want)


def test_column_attributes_yield_to_methods():
    df = tpd.DataFrame({"mode": [1, 2, 2], "median": [3.0, 4.0, 5.0], "x": [1, 1, 2]})
    assert callable(df.mode) and callable(df.median)
    _assert_equal(tpd.to_pandas(df.x), pandas.Series([1, 1, 2], name="x"))
    _assert_equal(tpd.to_pandas(df["mode"]), pandas.Series([1, 2, 2], name="mode"))


# ---------------------------------------------------------------------- #
# the surface: everything the JAX package's API has, the port has
# ---------------------------------------------------------------------- #

# the JAX package's engine setting and the `from __future__` name in its
# namespace; its submodules (`api`, the extension registry, a later slice of
# the port, among them) are not compared either
MODULE_NOT_API = {"Engine", "annotations"}


def _public(obj):
    return {n for n in dir(obj) if not n.startswith("_")}


@pytest.mark.parametrize("cls", ["DataFrame", "Series"])
def test_class_surface_matches_the_jax_package(cls):
    missing = sorted(_public(getattr(mpd, cls)) - _public(getattr(tpd, cls)))
    assert not missing, f"{cls} lacks {missing}"


# the IO functions: each one the port's own, not pandas' passed through
IO_FUNCTIONS = [
    "ExcelFile", "HDFStore", "read_clipboard", "read_csv", "read_excel",
    "read_feather", "read_fwf", "read_hdf", "read_html", "read_json",
    "read_orc", "read_parquet", "read_pickle", "read_sas", "read_spss",
    "read_sql", "read_sql_query", "read_sql_table", "read_stata",
    "read_table", "read_xml", "to_pickle",
]


def test_module_surface_matches_the_jax_package():
    missing = sorted(
        n for n in _public(mpd) - MODULE_NOT_API
        if not isinstance(getattr(mpd, n), types.ModuleType) and not hasattr(tpd, n)
    )
    assert not missing, f"modin_tpu_torch.pandas lacks {missing}"
    for name in IO_FUNCTIONS:
        assert hasattr(mpd, name)
        port = getattr(tpd, name)
        assert callable(port) and port is not getattr(pandas, name), name
        assert port.__module__ == "modin_tpu_torch.pandas.io", name


def test_every_pandas_method_is_callable_on_the_port():
    for cls, pcls in ((tpd.DataFrame, pandas.DataFrame), (tpd.Series, pandas.Series)):
        for name in _public(pcls):
            attr = inspect.getattr_static(pcls, name)
            if callable(attr) and not isinstance(attr, (property, type)):
                assert hasattr(cls, name), f"{cls.__name__}.{name}"


# ---------------------------------------------------------------------- #
# loc / iloc reads: positional and boolean reads stay on the device
# ---------------------------------------------------------------------- #

READS = {
    "iloc_step_cols": lambda df: df.iloc[::7, [0, 3]],
    "iloc_rows_list": lambda df: df.iloc[[5, 0, -1, 7]],
    "iloc_scalar_row": lambda df: df.iloc[3],
    "iloc_cell": lambda df: df.iloc[4, 2],
    "iloc_col": lambda df: df.iloc[:, 1],
    "iloc_negative_slice": lambda df: df.iloc[-20:-3],
    "loc_mask_cols": lambda df: df.loc[df.col0 > 50, ["col1", "col2"]],
    "loc_mask": lambda df: df.loc[df["col3"] < 10],
    "loc_label_slice": lambda df: df.loc[10:40, "col1":"col4"],
    "loc_labels": lambda df: df.loc[[3, 1, 99], ["col4", "col0"]],
    "loc_scalar": lambda df: df.loc[17, "col2"],
    "head": lambda df: df.head(),
    "tail": lambda df: df.tail(3),
    "filtered_then_iloc": lambda df: df[df.col0 > 30].iloc[2:9],
    "series_iloc": lambda df: df["col5"].iloc[10:20],
    "series_loc": lambda df: df["col5"].loc[[4, 8]],
}


@pytest.mark.parametrize("case", sorted(READS))
def test_indexing_reads(case):
    fn = READS[case]
    d = make_data((300, 6), seed=9)
    want = fn(pandas.DataFrame(d))
    defaults = tqc.DEFAULTS_TO_PANDAS
    got = tpd.to_pandas(fn(tpd.DataFrame(d)))
    assert tqc.DEFAULTS_TO_PANDAS == defaults, f"{case} left the device"
    if isinstance(want, (pandas.DataFrame, pandas.Series)):
        _assert_equal(got, want)
    else:
        assert got == want


def test_indexing_writes_default_and_match():
    d = make_data((50, 3), seed=4)
    pdf, tdf = pandas.DataFrame(d), tpd.DataFrame(d)
    for df in (pdf, tdf):
        df.iloc[3, 1] = -1
        df.loc[df["col0"] > 90, "col2"] = 0
        df.loc[7] = 5
    _assert_equal(tpd.to_pandas(tdf), pdf)


# ---------------------------------------------------------------------- #
# column drop and reset_index on the device; the groupby object's pandas
# fallback
# ---------------------------------------------------------------------- #

METADATA_QUERIES = {
    "drop_columns": lambda df: df.drop(columns=["col1", "col3"]),
    "reset_index": lambda df: df.set_axis(list(range(100, 400)), axis=0).reset_index(),
    "reset_index_drop": lambda df: df[df.col0 > 50].reset_index(drop=True),
}


@pytest.mark.parametrize("query", sorted(METADATA_QUERIES))
def test_metadata_ops_stay_on_the_device(query):
    fn = METADATA_QUERIES[query]
    want, from_jax, from_torch, counted = _run_three(fn, make_data((300, 4), seed=8))
    assert counted == 0
    _assert_equal(from_torch, want)
    _assert_equal(from_jax, want)


def test_delitem_keeps_the_other_columns():
    d = make_data((50, 3), seed=9)
    tdf, pdf = tpd.DataFrame(d), pandas.DataFrame(d)
    kept = tdf._query_compiler._modin_frame.get_column(2)
    defaults = tqc.DEFAULTS_TO_PANDAS
    del tdf["col1"], pdf["col1"]
    assert tqc.DEFAULTS_TO_PANDAS == defaults
    assert tdf._query_compiler._modin_frame.get_column(1) is kept  # no data moved
    _assert_equal(tpd.to_pandas(tdf), pdf)


def test_groupby_methods_without_a_device_path_use_pandas_once():
    d = make_data((200, 3), seed=10)
    tdf, pdf = tpd.DataFrame(d), pandas.DataFrame(d)
    defaults = tqc.DEFAULTS_TO_PANDAS
    gb = tdf.groupby("col0")
    assert hasattr(gb, "skew") and hasattr(gb["col1"], "rank")
    assert tqc.DEFAULTS_TO_PANDAS == defaults  # looking a method up runs nothing
    got = gb["col1"].rank()
    assert tqc.DEFAULTS_TO_PANDAS == defaults + 1
    assert isinstance(got, tpd.Series)
    _assert_equal(tpd.to_pandas(got), pdf.groupby("col0")["col1"].rank())
    got = gb.skew()
    assert tqc.DEFAULTS_TO_PANDAS == defaults + 2
    assert isinstance(got, tpd.DataFrame)
    _assert_equal(tpd.to_pandas(got), pdf.groupby("col0").skew())
    got = gb.agg({"col1": "sum", "col2": "skew"})
    assert tqc.DEFAULTS_TO_PANDAS == defaults + 3
    assert isinstance(got, tpd.DataFrame)
    _assert_equal(tpd.to_pandas(got), pdf.groupby("col0").agg({"col1": "sum", "col2": "skew"}))
    assert gb.ngroups == pdf.groupby("col0").ngroups
    assert tqc.DEFAULTS_TO_PANDAS == defaults + 4
    with pytest.raises(AttributeError):
        gb.no_such_method
