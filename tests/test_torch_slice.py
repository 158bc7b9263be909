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
        # row sums run on the device; min_count is not ported
        lambda df: df.sum(axis=1, min_count=1),
    ],
    ids=["int_floordiv_zero", "as_index_false", "sum_axis1"],
)
def test_declined_queries_default_to_pandas(query):
    d = make_data((300, 3), ngroups=7)
    defaults = tqc.DEFAULTS_TO_PANDAS
    got = tpd.to_pandas(query(tpd.DataFrame(d)))
    assert tqc.DEFAULTS_TO_PANDAS == defaults + 1
    _assert_equal(got, query(pandas.DataFrame(d)))


# ---------------------------------------------------------------------- #
# The asv relational suite: filter and query, sort_values, merge, concat,
# __setitem__ + multi-key groupby, isin (asv_bench/benchmarks/
# benchmarks.py: TimeQuery, TimeSortValues, TimeMerge, TimeConcat,
# TimeGroupByMultiColumn, TimeArithmetic.time_is_in).  These only move or
# compare values, so every frame must equal pandas exactly, index included.
# ---------------------------------------------------------------------- #

THRESHOLD = 40  # read by the "@THRESHOLD" query through the caller's namespace


def _setitem_groupby_multi(pd, df, df2):
    df["groupby_col2"] = df["col0"] % 5
    return df.groupby(["groupby_col", "groupby_col2"]).sum()


def _setitem_replace_and_scalar(pd, df, df2):
    df["col1"] = df["col2"] * 3
    df["flag"] = True
    df["const"] = 7
    return df


def _insert(pd, df, df2):
    df.insert(1, "twice", df["col0"] * 2)
    df.insert(0, "lit", list(range(len(df))))
    return df


RELATIONAL_QUERIES = {
    "query": lambda pd, df, df2: df.query("col0 > 50 & col1 < 30"),
    "query_chained_not": lambda pd, df, df2: df.query("10 < col0 <= 60 and not col1 > 50"),
    "query_local": lambda pd, df, df2: df.query("col3 > @THRESHOLD | col4 == 0"),
    "query_index": lambda pd, df, df2: df.query("index % 3 == 0"),
    "filter_and": lambda pd, df, df2: df[(df.col0 > 50) & (df.col1 < 30)],
    "filter_or_invert": lambda pd, df, df2: df[~(df.col0 > 50) | (df["col2"] == 3)],
    "filter_xor": lambda pd, df, df2: df[(df.col0 > 50) ^ (df.col1 < 30)],
    "filter_numpy_mask": lambda pd, df, df2: df[(df2["col0"] > 50).to_numpy()],
    "filter_twice": lambda pd, df, df2: (lambda f: f[f.col2 < 40])(df[df.col0 > 20]),
    "row_slice": lambda pd, df, df2: df[5:1500:7],
    "invert_int": lambda pd, df, df2: ~df,
    "sort_one": lambda pd, df, df2: df.sort_values("col0", kind="stable"),
    "sort_two": lambda pd, df, df2: df.sort_values(["col0", "col1"], ascending=[True, False]),
    "sort_desc_ignore_index": lambda pd, df, df2: df.sort_values(
        "col3", ascending=False, kind="stable", ignore_index=True
    ),
    "sort_after_filter": lambda pd, df, df2: df[df.col5 > 30].sort_values(["col1", "col0"]),
    "concat_axis0": lambda pd, df, df2: pd.concat([df, df2]),
    "concat_axis0_ignore_index": lambda pd, df, df2: pd.concat([df, df2, df], ignore_index=True),
    "concat_axis1": lambda pd, df, df2: pd.concat([df, df2], axis=1),
    "setitem_groupby_multi": _setitem_groupby_multi,
    "setitem_replace_and_scalar": _setitem_replace_and_scalar,
    "insert": _insert,
    "isin": lambda pd, df, df2: df.isin([0, 2]),
    "isin_series": lambda pd, df, df2: df["col0"].isin([5, 7, 1000]),
    "isin_query": lambda pd, df, df2: df.query("col0 in [1, 2, 3] & col1 not in [4]"),
}


@pytest.mark.parametrize("query", sorted(RELATIONAL_QUERIES))
def test_relational_query(query):
    d1 = make_data((2000, 10), seed=8, ngroups=20)
    d2 = make_data((2000, 10), seed=9, ngroups=20)
    fn = RELATIONAL_QUERIES[query]
    want = fn(pandas, pandas.DataFrame(d1), pandas.DataFrame(d2))
    from_jax = jax_to_pandas(fn(mpd, mpd.DataFrame(d1), mpd.DataFrame(d2)))
    defaults = tqc.DEFAULTS_TO_PANDAS
    from_torch = tpd.to_pandas(fn(tpd, tpd.DataFrame(d1), tpd.DataFrame(d2)))
    assert tqc.DEFAULTS_TO_PANDAS == defaults, "a relational query left the device"
    _assert_exact(from_torch, want)
    _assert_exact(from_jax, want)


def _assert_exact(got, want):
    if isinstance(want, pandas.DataFrame):
        pandas.testing.assert_frame_equal(got, want, check_exact=True)
    else:
        pandas.testing.assert_series_equal(got, want, check_exact=True)


def _float_keys(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    k = rng.integers(-6, 6, n) / 2.0
    k[rng.random(n) < 0.08] = np.nan
    k[rng.random(n) < 0.05] = -0.0
    return k


def _merge_frames(case: str):
    """(left, right, merge kwargs) as dicts of numpy columns."""
    if case == "asv":  # TimeMerge at the Small size: many-to-many on col0
        return make_data((2000, 10), seed=3), make_data((1000, 3), seed=4), {"on": "col0"}
    rng = np.random.default_rng(11)
    if case == "misses":  # unique right keys over part of the range
        left = make_data((2000, 4), seed=5)
        right = {"col0": rng.permutation(np.arange(30, 130)), "w": rng.integers(0, 9, 100)}
        return left, right, {"on": "col0"}
    if case == "multi_key":
        left = make_data((2000, 4), seed=6)
        right = {"col0": rng.integers(0, 100, 700), "col1": rng.integers(0, 100, 700) // 10 * 10,
                 "col3": rng.integers(0, 9, 700)}
        return left, right, {"on": ["col0", "col1"]}
    if case == "float_keys":
        left = {"k": _float_keys(800, 1), "a": rng.integers(0, 100, 800), "b": rng.normal(size=800)}
        right = {"k": _float_keys(300, 2), "c": rng.integers(0, 100, 300)}
        return left, right, {"on": "k"}
    if case == "left_on_right_on":
        left = make_data((2000, 3), seed=7)
        right = {"key": rng.permutation(np.arange(20, 120)), "col1": rng.integers(0, 9, 100)}
        return left, right, {"left_on": "col0", "right_on": "key", "suffixes": ("_l", "_r")}
    raise ValueError(case)


# an outer merge with distinct key labels goes to pandas (declined below)
MERGE_CASES = [
    (case, how)
    for case in ["asv", "misses", "multi_key", "float_keys", "left_on_right_on"]
    for how in ["inner", "left", "right", "outer"]
    if (case, how) != ("left_on_right_on", "outer")
]


@pytest.mark.parametrize("case,how", MERGE_CASES)
def test_merge(case, how):
    left, right, kwargs = _merge_frames(case)
    want = pandas.DataFrame(left).merge(pandas.DataFrame(right), how=how, **kwargs)
    from_jax = jax_to_pandas(mpd.DataFrame(left).merge(mpd.DataFrame(right), how=how, **kwargs))
    defaults = tqc.DEFAULTS_TO_PANDAS
    got = tpd.merge(tpd.DataFrame(left), tpd.DataFrame(right), how=how, **kwargs)
    from_torch = tpd.to_pandas(got)
    assert tqc.DEFAULTS_TO_PANDAS == defaults, "a merge left the device"
    _assert_exact(from_torch, want)
    _assert_exact(from_jax, want)


def _uint64_frame(pd):
    df = pd.DataFrame({"u": np.arange(50, dtype=np.uint64)[::-1], "v": np.arange(50)})
    return df.sort_values("u")


@pytest.mark.parametrize(
    "query",
    [
        lambda pd: pd.DataFrame(make_data((300, 3))).merge(
            pd.DataFrame(make_data((100, 2), seed=1)), on="col0", indicator=True
        ),
        _uint64_frame,
        lambda pd: pd.DataFrame(make_data((300, 3))).merge(
            pd.DataFrame({"key": np.arange(50), "w": np.arange(50)}), left_on="col0",
            right_on="key", how="outer",
        ),
        lambda pd: pd.DataFrame(make_data((300, 3))).sort_values("col1", key=lambda s: -s),
        lambda pd: pd.DataFrame(make_data((300, 3))).query("col0 ** 2 > 400"),
        lambda pd: pd.concat([pd.DataFrame(make_data((30, 3))), pd.DataFrame(make_data((20, 3)))], keys=["a", "b"]),
        lambda pd: (pd.DataFrame(make_data((30, 3)))["col0"] > 50) & 1,
    ],
    ids=[
        "merge_indicator", "sort_uint64_key", "merge_outer_distinct_keys", "sort_with_key",
        "query_pow", "concat_keys", "bool_and_int_scalar",
    ],
)
def test_declined_relational_queries_default_to_pandas(query):
    defaults = tqc.DEFAULTS_TO_PANDAS
    got = tpd.to_pandas(query(tpd))
    assert tqc.DEFAULTS_TO_PANDAS == defaults + 1
    _assert_exact(got, query(pandas))


def test_filter_keeps_host_columns_in_step():
    pdf = pandas.DataFrame({"a": np.arange(100), "s": [f"r{i}" for i in range(100)]})
    tdf = tpd.DataFrame(pdf)
    defaults = tqc.DEFAULTS_TO_PANDAS
    got = tpd.to_pandas(tdf[tdf["a"] % 3 == 1])
    assert tqc.DEFAULTS_TO_PANDAS == defaults
    _assert_exact(got, pdf[pdf["a"] % 3 == 1])


def test_relational_results_stay_on_the_device():
    d = make_data((500, 4), ngroups=5)
    tdf = tpd.DataFrame(d)
    results = [
        tdf.query("col0 > 50"), tdf.sort_values("col1"), tpd.concat([tdf, tdf]),
        tdf.merge(tdf, on="groupby_col"), tdf.isin([1]),
    ]
    for r in results:
        assert all(c.is_device for c in r._query_compiler._modin_frame._columns)


# ---------------------------------------------------------------------- #
# Edge cases of the relational paths: empty results, NaN placement and
# matching, signed zeros, narrow dtypes, lazy row labels feeding the next
# query.  Port against pandas exactly, on the device throughout.
# ---------------------------------------------------------------------- #

_EDGE_A = {
    "k": np.array([1, 2, 3, 4]),
    "v": np.array([1.5, -0.0, np.nan, 2.0]),
    "i": np.array([5, 6, 7, 8], dtype=np.int32),
}
_EDGE_B = {"k": np.array([9, 9]), "w": np.array([1, 2])}
_EDGE_F = {"k": np.array([np.nan, 1.0, -0.0, 3.0, np.nan]), "x": np.arange(5)}
_EDGE_G = {"k": np.array([0.0, np.nan, 1.0]), "y": np.array([10, 20, 30], dtype=np.uint8)}


def _with(df, fn):
    fn(df)
    return df


EDGE_QUERIES = {
    **{
        f"merge_no_match_{how}": (
            lambda pd, how=how: pd.DataFrame(_EDGE_A).merge(pd.DataFrame(_EDGE_B), on="k", how=how)
        )
        for how in ("inner", "left", "right", "outer")
    },
    **{
        f"merge_float_nan_{how}": (
            lambda pd, how=how: pd.DataFrame(_EDGE_F).merge(pd.DataFrame(_EDGE_G), on="k", how=how)
        )
        for how in ("inner", "left", "right", "outer")
    },
    "merge_after_filter": lambda pd: (lambda d: d[d.k > 1])(pd.DataFrame(_EDGE_A)).merge(
        pd.DataFrame(_EDGE_A), on="k", how="left"
    ),
    "sort_nan_first": lambda pd: pd.DataFrame(_EDGE_A).sort_values("v", na_position="first"),
    "sort_nan_first_desc": lambda pd: pd.DataFrame(_EDGE_F).sort_values(
        ["k", "x"], ascending=[False, True], na_position="first"
    ),
    "sort_int32_desc": lambda pd: pd.DataFrame(_EDGE_A).sort_values("i", ascending=False),
    "sort_string_payload": lambda pd: pd.DataFrame(
        {"k": [3, 1, 2, 1], "s": ["c", "a", "b", "d"], "o": np.array([1, "x", None, 2.5], dtype=object)}
    ).sort_values("k", kind="stable"),
    "isin_nan": lambda pd: pd.DataFrame(_EDGE_A).isin([np.nan, 2, 1.5]),
    "isin_float_values_int_columns": lambda pd: pd.DataFrame(_EDGE_A)[["k", "i"]].isin([2.0, 7.5]),
    "isin_out_of_range_int": lambda pd: pd.DataFrame(_EDGE_A).isin([2**40, 3]),
    "concat_filtered": lambda pd: pd.concat(
        [(lambda d: d[d.k > 2])(pd.DataFrame(_EDGE_A)), pd.DataFrame(_EDGE_A)]
    ),
    "concat_single": lambda pd: pd.concat([pd.DataFrame(_EDGE_A)]),
    "setitem_float_scalar": lambda pd: _with(pd.DataFrame(_EDGE_A), lambda d: d.__setitem__("z", 2.5)),
    "setitem_int32_scalar": lambda pd: _with(
        pd.DataFrame(_EDGE_A), lambda d: d.__setitem__("k", np.int32(3))
    ),
    "setitem_array": lambda pd: _with(pd.DataFrame(_EDGE_A), lambda d: d.__setitem__("z", np.arange(4.0))),
    "filter_to_empty": lambda pd: (lambda d: d[d.k > 100])(pd.DataFrame(_EDGE_A)),
    "query_float_or": lambda pd: pd.DataFrame(_EDGE_A).query("v > 0 or i == 7"),
    "slice_negative": lambda pd: pd.DataFrame(_EDGE_A)[-3:],
    "invert_bool_frame": lambda pd: ~(pd.DataFrame(_EDGE_A) > 2),
    "bool_scalar_rand": lambda pd: True & (pd.DataFrame(_EDGE_A)["k"] > 2),
    "bool_scalar_xor": lambda pd: (pd.DataFrame(_EDGE_A)["k"] > 2) ^ True,
}


@pytest.mark.parametrize("query", sorted(EDGE_QUERIES))
def test_relational_edge_case(query):
    fn = EDGE_QUERIES[query]
    want = fn(pandas)
    defaults = tqc.DEFAULTS_TO_PANDAS
    got = tpd.to_pandas(fn(tpd))
    assert tqc.DEFAULTS_TO_PANDAS == defaults, "an edge case left the device"
    _assert_exact(got, want)


POSITIONAL = {
    "row_array": (lambda qc: qc.getitem_row_array([5, 0, -1, 7, 7]), lambda df: df.iloc[[5, 0, -1, 7, 7]]),
    "row_slice": (lambda qc: qc.row_slice(3, 90, 4), lambda df: df.iloc[3:90:4]),
    "take_2d": (
        lambda qc: qc.take_2d_positional(index=np.array([9, 2, 4]), columns=[3, 0]),
        lambda df: df.iloc[[9, 2, 4], [3, 0]],
    ),
    "take_2d_slices": (
        lambda qc: qc.take_2d_positional(index=slice(None, None, -3), columns=slice(1, 4)),
        lambda df: df.iloc[::-3, 1:4],
    ),
}


@pytest.mark.parametrize("case", sorted(POSITIONAL))
def test_positional_selection_in_the_compiler(case):
    # the compiler methods behind iloc, on a filtered frame (lazy labels)
    qc_fn, pandas_fn = POSITIONAL[case]
    pdf = pandas.DataFrame(make_data((300, 5), seed=4))
    pdf = pdf[pdf.col1 > 20]
    tdf = tpd.DataFrame(make_data((300, 5), seed=4))
    tdf = tdf[tdf.col1 > 20]
    mdf = mpd.DataFrame(make_data((300, 5), seed=4))
    mdf = mdf[mdf.col1 > 20]
    want = pandas_fn(pdf)
    from_jax = mpd.DataFrame(query_compiler=qc_fn(mdf._query_compiler))
    _assert_exact(jax_to_pandas(from_jax), want)
    defaults = tqc.DEFAULTS_TO_PANDAS
    got = tpd.to_pandas(tpd.DataFrame(query_compiler=qc_fn(tdf._query_compiler)))
    assert tqc.DEFAULTS_TO_PANDAS == defaults
    _assert_exact(got, want)


def test_positions_out_of_bounds_raise():
    qc = tpd.DataFrame(make_data((10, 2)))._query_compiler
    with pytest.raises(IndexError):
        qc.getitem_row_array([3, 10])
