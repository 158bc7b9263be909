"""Statistics and encodings in the torch port: ``corr``/``cov``,
``get_dummies``, ``Series.map`` and the numpy math maps (``unary_math``).

``ops/stats.corr_cov_matrix`` is held against the JAX package's function of
the same name on centred data (rtol 1e-12: the Gram sums are taken in
another order), with and without missing values, under ``min_periods`` and
``ddof``.  Then the compiler's paths run through ``modin_tpu_torch.pandas``,
``modin_tpu.pandas`` and pandas: pandas' result (exactly, or to rtol 1e-12
where sums reorder), and no more defaults to pandas than the JAX package
counts (none where it has none).

One case where pandas and the JAX package disagree, and the port follows
pandas (ROADMAP Queue 3, item 3): ``corr``/``cov`` of a column whose mean is
large against its spread.  The JAX package forms ``P - S Sᵀ / N`` from raw
products and cancels (``1e8 + N(0, 1)`` gives a negative variance); the
port shifts each column by its mean first.
"""

import threading
import warnings

import numpy as np
import pandas
import pytest
import torch

import modin_tpu.pandas as mpd
from modin_tpu.ops import stats as jax_stats
from modin_tpu.ops import structural as jax_structural
from modin_tpu.parallel.engine import JaxWrapper
from modin_tpu.utils import to_pandas as jax_to_pandas

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch.core.dataframe.torch.dataframe import DeviceColumn
from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
from modin_tpu_torch.ops import elementwise, stats

N = 2003  # not a multiple of the JAX mesh: its columns carry pad rows


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


def _jax(values: np.ndarray):
    return JaxWrapper.put(jax_structural.pad_host(np.asarray(values)))


def _columns(with_nan: bool, seed: int = 0):
    """Centred columns: correlated normals, a narrow int column, a bool
    column and a wide float column, missing values in two of them."""
    rng = np.random.default_rng(seed)
    a, b = rng.normal(size=N), rng.normal(size=N)
    cols = [a, a + 0.5 * b, rng.integers(-50, 50, N), rng.random(N) < 0.3, rng.normal(size=N) * 1e3]
    if with_nan:
        cols[0] = np.where(rng.random(N) < 0.1, np.nan, cols[0])
        cols[4] = np.where(rng.random(N) < 0.3, np.nan, cols[4])
    return cols


@pytest.mark.parametrize("with_nan", [False, True])
@pytest.mark.parametrize("method,ddof", [("corr", 1), ("cov", 1), ("cov", 0), ("cov", 3)])
@pytest.mark.parametrize("min_periods", [1, 1500, N + 1])
def test_corr_cov_matrix_against_the_jax_package(method, ddof, min_periods, with_nan):
    cols = _columns(with_nan)
    got, counts = stats.corr_cov_matrix([torch.as_tensor(c) for c in cols], method, ddof, min_periods)
    want, want_counts = jax_stats.corr_cov_matrix([_jax(c) for c in cols], N, method, ddof, min_periods)
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_corr_cov_with_large_offset_follows_pandas():
    """``x = 1e8 + a`` and ``y = 1e8 + a + 0.5 b`` with a, b ~ N(0, 1): the
    JAX package's raw products cancel (a negative variance); the port gives
    pandas' ``cov`` to rtol 1e-12, and the correlation of pandas' two-pass
    ``cov`` to rtol 1e-12.  pandas' own ``corr`` (a Welford loop at the
    offset) is itself some 1e-8 off that value; the port is held to it
    within 1e-7."""
    rng = np.random.default_rng(7)
    a, b = rng.normal(size=N), rng.normal(size=N)
    data = {"x": 1e8 + a, "y": 1e8 + a + 0.5 * b}
    p = pandas.DataFrame(data)
    port = tpd.DataFrame(data)
    before = tqc.DEFAULTS_TO_PANDAS
    cov, corr = tpd.to_pandas(port.cov()), tpd.to_pandas(port.corr())
    assert tqc.DEFAULTS_TO_PANDAS == before
    want_cov = p.cov()
    pandas.testing.assert_frame_equal(cov, want_cov, check_exact=False, rtol=1e-12)
    sd = np.sqrt(np.diag(want_cov.to_numpy()))
    np.testing.assert_allclose(corr.to_numpy(), want_cov.to_numpy() / np.outer(sd, sd), rtol=1e-12)
    pandas.testing.assert_frame_equal(corr, p.corr(), check_exact=False, rtol=1e-7)
    # the reference's fault, which the port does not share
    jax_cov, _ = jax_stats.corr_cov_matrix([_jax(data["x"]), _jax(data["y"])], N, "cov")
    assert np.abs(jax_cov - want_cov.to_numpy()).max() > 0.5


# ---------------------------------------------------------------------- #
# through the three packages
# ---------------------------------------------------------------------- #


def _run(fn, make_args):
    """(pandas' result or error, the JAX package's count of defaults, the
    port's result or error, the port's count of defaults)."""
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


def _check(fn, make_args, exact: bool = True):
    want, jax_defaults, got, defaults = _run(fn, make_args)
    if isinstance(want, Exception):
        assert type(got) is type(want), (got, want)
    elif isinstance(want, pandas.DataFrame):
        pandas.testing.assert_frame_equal(got, want, check_exact=exact, rtol=1e-12)
    else:
        pandas.testing.assert_series_equal(got, want, check_exact=exact, rtol=1e-12)
    assert defaults <= jax_defaults, (defaults, jax_defaults)
    return defaults, jax_defaults


def _frame(name: str):
    rng = np.random.default_rng(3)
    base = {
        "i": rng.integers(0, 100, N),
        "f": np.where(rng.random(N) < 0.05, np.nan, rng.normal(size=N)),
        "g": rng.normal(size=N).astype(np.float32),
    }
    if name == "clean":
        base["f"] = rng.normal(size=N)
    elif name == "bool":
        base["b"] = rng.random(N) < 0.5
    elif name == "mixed":
        base["s"] = rng.choice(np.array(["x", "y", "z"], dtype=object), N)
    elif name == "datetime":
        base["t"] = pandas.date_range("2000-01-01", periods=N, freq="h")
    return lambda pd: (pd.DataFrame(base),)


CORR_COV = {
    "corr": lambda d: d.corr(),
    "corr_min_periods": lambda d: d.corr(min_periods=1950),
    "cov": lambda d: d.cov(),
    "cov_ddof0": lambda d: d.cov(ddof=0),
    "cov_min_periods": lambda d: d.cov(min_periods=1950),
    "corr_numeric_only": lambda d: d.corr(numeric_only=True),
    "cov_numeric_only": lambda d: d.cov(numeric_only=True),
    "subset_corr": lambda d: d[["i", "f"]].corr(),
}


@pytest.mark.parametrize("frame", ["clean", "nan", "bool", "mixed", "datetime"])
@pytest.mark.parametrize("query", sorted(CORR_COV))
def test_corr_cov_through_the_packages(frame, query):
    if frame == "datetime" and query == "cov_numeric_only":
        # pandas refuses a frame with a datetime column in cov even under
        # numeric_only; the JAX package leaves the column out, the port
        # goes to pandas and raises its error
        want, jax_defaults, got, defaults = _run(CORR_COV[query], _frame(frame))
        assert isinstance(want, TypeError) and isinstance(got, TypeError)
        assert (defaults, jax_defaults) == (1, 0)
        return
    defaults, jax_defaults = _check(CORR_COV[query], _frame(frame), exact=False)
    if frame in ("clean", "nan", "bool") or query.endswith("numeric_only") or query == "subset_corr":
        assert defaults == jax_defaults == 0


def test_corr_cov_spearman_stays_with_pandas():
    defaults, jax_defaults = _check(lambda d: d.corr(method="spearman"), _frame("nan"), exact=False)
    assert defaults == jax_defaults == 1


# ---------------------------------------------------------------------- #
# get_dummies
# ---------------------------------------------------------------------- #


def _strings(pd, missing: bool = True):
    rng = np.random.default_rng(9)
    values = rng.choice(np.array(["beta", "alpha", "gamma-delta"], dtype=object), N)
    if missing:
        values[rng.random(N) < 0.05] = None
    return pd.Series(values, name="s")


def _categorical(pd):
    rng = np.random.default_rng(10)
    values = pandas.Categorical(
        rng.choice(np.array(["b", "a", None], dtype=object), N), categories=["c", "b", "a"]
    )
    return pd.Series(values, name="c")  # "c" is an unobserved category


DUMMIES = {
    "plain": lambda pd: pd.get_dummies(_strings(pd)),
    "no_missing": lambda pd: pd.get_dummies(_strings(pd, missing=False)),
    "prefix": lambda pd: pd.get_dummies(_strings(pd), prefix="p", prefix_sep="/"),
    "dummy_na": lambda pd: pd.get_dummies(_strings(pd), dummy_na=True),
    "drop_first": lambda pd: pd.get_dummies(_strings(pd), drop_first=True),
    "dtype_float": lambda pd: pd.get_dummies(_strings(pd), dtype=np.float64),
    "dtype_uint8": lambda pd: pd.get_dummies(_strings(pd), dtype=np.uint8),
    "categorical": lambda pd: pd.get_dummies(_categorical(pd)),
    "categorical_dummy_na": lambda pd: pd.get_dummies(_categorical(pd), dummy_na=True),
    "categorical_prefix": lambda pd: pd.get_dummies(_categorical(pd), prefix="c"),
}


@pytest.mark.parametrize("query", sorted(DUMMIES))
def test_get_dummies(query):
    assert _check(lambda pd: DUMMIES[query](pd), lambda pd: (pd,)) == (0, 0)


def test_get_dummies_columns_are_on_the_device():
    result = tpd.get_dummies(_strings(tpd))
    assert all(isinstance(c, DeviceColumn) for c in result._query_compiler._modin_frame._columns)


# ---------------------------------------------------------------------- #
# Series.map
# ---------------------------------------------------------------------- #


def _ints(pd):
    return pd.Series(np.random.default_rng(12).integers(0, 5, N), name="k")


MAPS = {
    "str_full_int": lambda pd: _strings(pd, False).map({"alpha": 1, "beta": 2, "gamma-delta": 3}),
    "str_partial": lambda pd: _strings(pd, False).map({"alpha": 1, "beta": 2}),
    "str_missing_rows": lambda pd: _strings(pd).map({"alpha": 1, "beta": 2, "gamma-delta": 3}),
    "str_floats": lambda pd: _strings(pd).map({"alpha": 0.5, "beta": -1.25}),
    "str_bool_full": lambda pd: _strings(pd, False).map({"alpha": True, "beta": False, "gamma-delta": True}),
    "str_none_value": lambda pd: _strings(pd, False).map({"alpha": 1, "beta": None, "gamma-delta": 3}),
    "int_full": lambda pd: _ints(pd).map({0: 10, 1: 11, 2: 12, 3: 13, 4: 14}),
    "int_partial": lambda pd: _ints(pd).map({0: 10, 3: 13}),
    "int_floats": lambda pd: _ints(pd).map({0: 0.5, 1: 1.5, 2: 2.5, 3: 3.5, 4: 4.5}),
    "int_bool_full": lambda pd: _ints(pd).map({0: True, 1: False, 2: True, 3: True, 4: False}),
    "float_keys": lambda pd: (_ints(pd) / 2).map({0.0: 1, 0.5: 2, 1.5: 3}),
    "series_arg": lambda pd: _ints(pd).map(pandas.Series([5, 6, 7, 8, 9])),
    # pandas gives object here, or the argument is not a dict: pandas maps
    "str_bool_partial": lambda pd: _strings(pd, False).map({"alpha": True}),
    "nan_key": lambda pd: (_ints(pd) / 2).map({np.nan: 1.0, 0.5: 2.0}),
    "callable": lambda pd: _ints(pd).map(lambda v: v * 2),
    "object_values": lambda pd: _ints(pd).map({0: "zero", 1: "one"}),
}


def test_series_map_of_only_none_values_follows_pandas():
    """pandas gives object None/NaN; the JAX package gives float64 NaN."""
    want, jax_defaults, got, defaults = _run(lambda s: s.map({0: None, 1: None}), lambda pd: (_ints(pd),))
    assert want.dtype == object
    pandas.testing.assert_series_equal(got, want)
    assert (defaults, jax_defaults) == (1, 0)


@pytest.mark.parametrize("query", sorted(MAPS))
def test_series_map(query):
    defaults, jax_defaults = _check(lambda pd: MAPS[query](pd), lambda pd: (pd,))
    if query not in ("str_bool_partial", "nan_key", "callable", "object_values"):
        assert defaults == jax_defaults == 0


# ---------------------------------------------------------------------- #
# unary_math
# ---------------------------------------------------------------------- #


def _math_frame(pd, strings: bool = False):
    rng = np.random.default_rng(14)
    x = rng.normal(0, 50, N)
    x[::29] = np.nan
    x[1:4] = [0.0, -0.0, np.inf]
    d = {
        "f": x,
        "g": np.abs(rng.normal(0, 5, N)).astype(np.float32),
        "i": rng.integers(-20, 1000, N),
        "j": rng.integers(1, 100, N).astype(np.int32),
        "k": rng.integers(1, 100, N).astype(np.int8),
    }
    if strings:
        d["s"] = rng.choice(np.array(["x", "y"], dtype=object), N)
    return pd.DataFrame(d)


def _assert_ulps(got: np.ndarray, want: np.ndarray, ulps: int) -> None:
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    ints = f"i{want.dtype.itemsize}"
    diff = np.abs(got[ok].view(ints).astype(np.int64) - want[ok].view(ints).astype(np.int64))
    assert diff.max(initial=0) <= ulps, diff.max()


EXACT_MATH = ("floor", "ceil", "sign")


@pytest.mark.parametrize("name", sorted(elementwise.MATH_UNARY))
def test_unary_math_against_numpy(name):
    """``np.<name>(df)`` through the compiler: numpy's dtypes (int8 gives
    float16); floor/ceil/sign bit for bit, the others within 4 units in
    the last place of numpy's (torch's CPU functions; the card's sqrt is
    correctly rounded)."""
    p = _math_frame(pandas)
    before = tqc.DEFAULTS_TO_PANDAS
    with np.errstate(all="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        result = getattr(np, name)(tpd.DataFrame(p))
        want = getattr(np, name)(p)
    assert tqc.DEFAULTS_TO_PANDAS == before
    assert all(isinstance(c, DeviceColumn) for c in result._query_compiler._modin_frame._columns)
    got = tpd.to_pandas(result)
    pandas.testing.assert_index_equal(got.columns, want.columns)
    for label in want.columns:
        g, w = got[label].to_numpy(), want[label].to_numpy()
        if w.dtype.kind == "f":
            _assert_ulps(g, w, 0 if name in EXACT_MATH else 4)
        else:
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


@pytest.mark.parametrize("name", sorted(elementwise.MATH_UNARY))
def test_unary_math_against_the_jax_package(name):
    """The compiler's ``unary_math`` of both packages on the float64 and
    int64 columns: floor/ceil/sign bit for bit, the others within 8 units
    in the last place (each package's own math library).  floor/ceil of
    ints: the JAX package keeps int64, numpy and the port give float64 of
    the same values."""
    p = _math_frame(pandas)[["f", "i"]]
    got = tpd.DataFrame(p)._query_compiler.unary_math(name).to_pandas()
    want = mpd.DataFrame(p)._query_compiler.unary_math(name).to_pandas()
    for label in ("f", "i"):
        g, w = got[label].to_numpy(), want[label].to_numpy()
        if name in ("floor", "ceil") and label == "i":
            assert (g.dtype, w.dtype) == (np.float64, np.int64)
            w = w.astype(np.float64)
        _assert_ulps(g, w, 0 if name in EXACT_MATH else 8)


def test_unary_math_series_and_mixed_frames():
    """A Series keeps its name; a string column goes through numpy's own
    function, whose error pandas raises too."""
    p = _math_frame(pandas)
    got = tpd.to_pandas(np.sqrt(tpd.DataFrame(p)["j"]))
    pandas.testing.assert_series_equal(got, np.sqrt(p["j"]))
    want, jax_defaults, got, defaults = _run(lambda d: np.floor(d), lambda pd: (_math_frame(pd, strings=True),))
    assert isinstance(want, TypeError) and isinstance(got, TypeError)
    assert defaults == jax_defaults == 0


def test_other_ufuncs_still_apply_in_pandas():
    p = _math_frame(pandas)
    got = tpd.to_pandas(np.add(tpd.DataFrame(p), 1))
    pandas.testing.assert_frame_equal(got, np.add(p, 1))
    got = tpd.to_pandas(np.sqrt(tpd.DataFrame(p), out=None, where=True))
    with np.errstate(all="ignore"):
        pandas.testing.assert_frame_equal(got, np.sqrt(p, out=None, where=True))


def test_unary_math_declines_bools_to_pandas():
    p = pandas.DataFrame({"b": [True, False, True], "f": [1.0, 4.0, 9.0]})
    before = tqc.DEFAULTS_TO_PANDAS
    got = tpd.to_pandas(np.sqrt(tpd.DataFrame(p)))
    assert tqc.DEFAULTS_TO_PANDAS == before + 1
    pandas.testing.assert_frame_equal(got, np.sqrt(p))
