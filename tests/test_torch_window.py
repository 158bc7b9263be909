"""Windows, cumulative ops, shift/diff, pow and skew/kurt of the torch port
against the JAX package and pandas.

``ops/window.py`` must agree with ``modin_tpu.ops.window`` for every rolling
and expanding aggregation x window x ``min_periods``, and every ewm
aggregation x ``adjust`` x ``ignore_na`` x ``min_periods`` x ``bias`` (a slice
of the JAX package's 1920-check grid), over clean, NaN-gapped, all-NaN,
constant, +/-inf and int columns; and with pandas' own windows.  The
elementwise cumulative ops, shift/diff and pow, and the skew/kurt
reductions must agree with ``modin_tpu.ops``; the API calls of
``chip_smoke.py``'s window phase with ``modin_tpu.pandas`` and pandas,
without a default to pandas.

Tolerances: NaN positions, ints and min/max/count exactly; other floats to
``rtol=1e-9, atol=1e-12`` (the JAX grid's tolerance against pandas: prefix
sums and recurrences taken in another order, 400-1000 rows).  On a
constant column the ewm variance is 0 exactly in pandas and in the port
(pandas updates its running mean only where it changes), where the JAX
package's rounding leaves ~1e-13: those cases are held to pandas.
"""

import itertools
import threading

import numpy as np
import pandas
import pytest
import torch

import jax.numpy as jnp

import modin_tpu.pandas as mpd
from modin_tpu.ops import elementwise as jax_elementwise
from modin_tpu.ops import reductions as jax_reductions
from modin_tpu.ops import window as jax_window
from modin_tpu.utils import to_pandas as jax_to_pandas

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
from modin_tpu_torch.ops import elementwise, reductions
from modin_tpu_torch.ops import window as tw
from modin_tpu_torch.ops.lazy import materialize
from modin_tpu_torch.pandas.window import Ewm, Expanding, Rolling

RTOL = 1e-9
ATOL = 1e-12
N = 400


@pytest.fixture(autouse=True, scope="module")
def _join_jax_watchdog_threads():
    """Let the JAX package's per-fetch watchdog threads end before the next
    test file runs in this worker (``tests/test_watch.py`` counts threads)."""
    yield
    for t in threading.enumerate():
        if t.name.startswith("modin-tpu-watchdog"):
            t.join(timeout=5)


@pytest.fixture(autouse=True)
def _cpu_device():
    modin_tpu_torch.set_device("cpu")


def _column(kind: str, n: int = N, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "clean":
        return rng.normal(0, 10, n)
    if kind == "nan":
        return np.where(rng.random(n) < 0.2, np.nan, rng.normal(0, 10, n))
    if kind == "allnan":
        return np.full(n, np.nan)
    if kind == "const":
        return np.full(n, 3.25)
    if kind == "inf":
        x = rng.normal(0, 10, n)
        x[rng.random(n) < 0.03] = np.inf
        x[rng.random(n) < 0.03] = -np.inf
        x[rng.random(n) < 0.05] = np.nan
        return x
    if kind == "int":
        return rng.integers(0, 100, n)
    raise ValueError(kind)


KINDS = ["clean", "nan", "allnan", "const", "inf", "int"]


def _close(got: np.ndarray, want: np.ndarray, what: str, exact: bool = False) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.array_equal(np.isnan(got), np.isnan(want)), f"{what}: NaN positions differ"
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


# ---------------------------------------------------------------------- #
# ops/window.py against modin_tpu.ops.window and pandas
# ---------------------------------------------------------------------- #


def _jax_diverges(op: str, kind: str) -> bool:
    """pandas counts +/-inf in a window's ``count`` (and in the count that
    divides ``sem``); the JAX package takes them as missing there too.  The
    port follows pandas, so those cases are held to pandas alone."""
    return kind == "inf" and op in ("count", "sem")


@pytest.mark.parametrize("op", tw.ROLLING_DEVICE_OPS)
@pytest.mark.parametrize("window", [1, 5, 50])
@pytest.mark.parametrize("min_periods", [None, 0, 3])
def test_rolling_matches_jax_and_pandas(op, window, min_periods):
    mp = window if min_periods is None else min(min_periods, window)
    for kind in KINDS:
        c = _column(kind)
        got = tw.rolling_reduce(op, [torch.as_tensor(c)], N, window, mp)[0].numpy()
        from_jax = np.asarray(jax_window.rolling_reduce(op, [jnp.asarray(c)], N, window, mp)[0])
        want = getattr(pandas.Series(c).rolling(window, min_periods=mp), op)().to_numpy()
        exact = op in ("min", "max", "count")
        _close(got, want, f"rolling {op} {kind} vs pandas", exact)
        if not _jax_diverges(op, kind):
            _close(got, from_jax, f"rolling {op} {kind} vs JAX", exact)


@pytest.mark.parametrize("op", tw.EXPANDING_DEVICE_OPS)
@pytest.mark.parametrize("min_periods", [0, 1, 7])
def test_expanding_matches_jax_and_pandas(op, min_periods):
    for kind in KINDS:
        c = _column(kind, seed=1)
        got = tw.expanding_reduce(op, [torch.as_tensor(c)], N, min_periods)[0].numpy()
        from_jax = np.asarray(jax_window.expanding_reduce(op, [jnp.asarray(c)], N, min_periods)[0])
        want = getattr(pandas.Series(c).expanding(min_periods=min_periods), op)().to_numpy()
        exact = op in ("min", "max", "count")
        _close(got, want, f"expanding {op} {kind} vs pandas", exact)
        if not _jax_diverges(op, kind):
            _close(got, from_jax, f"expanding {op} {kind} vs JAX", exact)


def test_rolling_var_ddof_and_int_dtype():
    c = _column("int", seed=2).astype(np.int32)
    for ddof in (0, 1, 2):
        got = tw.rolling_reduce("var", [torch.as_tensor(c)], N, 6, 6, ddof)[0]
        assert got.dtype == torch.float64
        want = pandas.Series(c).rolling(6).var(ddof=ddof).to_numpy()
        _close(got.numpy(), want, f"var ddof {ddof}")


_EWM_GRID = [
    (op, adjust, ignore_na, mp, bias)
    for op in tw.EWM_DEVICE_OPS
    for adjust, ignore_na, mp in itertools.product([True, False], [True, False], [0, 3])
    for bias in ((False, True) if op in ("var", "std") else (False,))
    if not (op == "sum" and not adjust)
]


def _pandas_ewm(op, c, alpha, adjust, ignore_na, mp, bias):
    ewm = pandas.Series(c).ewm(alpha=alpha, adjust=adjust, ignore_na=ignore_na, min_periods=mp)
    if op in ("var", "std"):
        return getattr(ewm, op)(bias=bias).to_numpy()
    return getattr(ewm, op)().to_numpy()


@pytest.mark.parametrize("op,adjust,ignore_na,mp,bias", _EWM_GRID)
def test_ewm_matches_jax_and_pandas(op, adjust, ignore_na, mp, bias):
    alpha = 0.15
    for kind in KINDS:
        c = _column(kind, seed=3)
        got = tw.ewm_reduce(op, [torch.as_tensor(c)], N, alpha, adjust, ignore_na, mp, bias)[0].numpy()
        want = _pandas_ewm(op, c, alpha, adjust, ignore_na, mp, bias)
        _close(got, want, f"ewm {op} {kind} vs pandas")
        if kind == "const" and op in ("var", "std"):
            continue  # the JAX package's rounding leaves ~1e-13 (see above)
        from_jax = np.asarray(
            jax_window.ewm_reduce(op, [jnp.asarray(c)], N, alpha, adjust, ignore_na, mp, bias)[0]
        )
        _close(got, from_jax, f"ewm {op} {kind} vs JAX")


def test_ewm_alpha_near_one_carries_the_last_observation():
    c = _column("nan", seed=4)
    got = tw.ewm_reduce("mean", [torch.as_tensor(c)], N, 1.0 - 1e-14, True, False, 0)[0].numpy()
    want = pandas.Series(c).ewm(alpha=1.0 - 1e-14).mean().to_numpy()
    _close(got, want, "ewm mean alpha ~ 1")


_PAIR_GRID = [
    (op, adjust, ignore_na, bias)
    for op in ("cov", "corr")
    for adjust, ignore_na in itertools.product([True, False], [True, False])
    for bias in ((False, True) if op == "cov" else (False,))
]


@pytest.mark.parametrize("op,adjust,ignore_na,bias", _PAIR_GRID)
def test_ewm_pair_matches_jax_and_pandas(op, adjust, ignore_na, bias):
    y = _column("nan", seed=5)
    for kind in KINDS:
        x = _column(kind, seed=6)
        got = tw.ewm_pair_reduce(op, [torch.as_tensor(x)], [torch.as_tensor(y)], N, 0.2, adjust,
                                 ignore_na, 2, bias)[0].numpy()
        ewm = pandas.Series(x).ewm(alpha=0.2, adjust=adjust, ignore_na=ignore_na, min_periods=2)
        want = (ewm.cov(pandas.Series(y), bias=bias) if op == "cov" else ewm.corr(pandas.Series(y))).to_numpy()
        _close(got, want, f"ewm {op} {kind} vs pandas")
        if kind == "const":
            continue  # held to pandas (see above)
        from_jax = np.asarray(jax_window.ewm_pair_reduce(
            op, [jnp.asarray(x)], [jnp.asarray(y)], N, 0.2, adjust, ignore_na, 2, bias)[0])
        _close(got, from_jax, f"ewm {op} {kind} vs JAX")


def test_van_herk_blocks_for_every_window():
    c = _column("clean", n=97, seed=8)
    for window in range(1, 100, 7):
        for op in ("min", "max", "sum", "mean", "var", "std"):
            got = tw.rolling_reduce(op, [torch.as_tensor(c)], 97, window, 1)[0].numpy()
            want = getattr(pandas.Series(c).rolling(window, min_periods=1), op)().to_numpy()
            if op in ("min", "max"):
                np.testing.assert_array_equal(got, want)
            else:
                _close(got, want, f"rolling({window}) {op}")


# ---------------------------------------------------------------------- #
# precision: windows whose values differ in scale along the column
# ---------------------------------------------------------------------- #
#
# The port's sums and variances come from block-local partials (van Herk
# over blocks of w rows) shifted by a value inside the window, so their
# rounding scales with the window's own values.  Each case holds the port
# to an exact per-window computation (math.fsum): its error may exceed
# pandas' own error by at most
#   sum:  g * S            mean: g * S / k
#   var:  4 k (g R^2 + eps R M) / (k - ddof)
# for a window of k valid values with S = sum|x|, R = max - min, M = max|x|,
# and g = (ceil(log2 n) + 2) eps: each partial is a scan of depth at most
# ceil(log2 n) over the window's values, then one merge.


def _precision_series(case: str) -> np.ndarray:
    rng = np.random.default_rng(21)
    if case == "spike":
        return np.concatenate([np.full(10, 1e15), rng.normal(0, 1, 2990)])
    if case == "trend":
        t = np.arange(3000, dtype=np.float64)
        return t * 1e3 + rng.normal(0, 1, 3000)
    if case == "const_1e15":
        return np.concatenate([np.full(1200, 1e15), rng.normal(0, 1, 1800)])
    if case == "int":
        return rng.integers(-(10**6), 10**6, 3000)
    if case == "leading_nan":
        x = rng.normal(50, 5, 3000)
        x[:1100] = np.nan
        x[rng.random(3000) < 0.05] = np.nan
        return x
    raise ValueError(case)


def _exact_windows(x: np.ndarray, window) -> dict:
    """Per window: fsum-exact sum, mean and M2 (corrected two-pass about
    the fsum mean), and k, S, R, M of its valid values."""
    import math

    x = np.asarray(x, np.float64)
    out = {key: np.zeros(len(x)) for key in ("sum", "mean", "m2", "k", "S", "R", "M")}
    for i in range(len(x)):
        lo = 0 if window is None else max(0, i - window + 1)
        v = x[lo:i + 1]
        v = v[np.isfinite(v)].tolist()
        k = len(v)
        if k == 0:
            continue
        total = math.fsum(v)
        mean = total / k
        d = [t - mean for t in v]
        m2 = math.fsum(t * t for t in d) - math.fsum(d) ** 2 / k
        out["sum"][i], out["mean"][i], out["m2"][i], out["k"][i] = total, mean, m2, k
        out["S"][i] = math.fsum(abs(t) for t in v)
        out["R"][i] = max(v) - min(v)
        out["M"][i] = max(abs(t) for t in v)
    return out


@pytest.mark.parametrize("window", [10, 1000, None], ids=["rolling10", "rolling1000", "expanding"])
@pytest.mark.parametrize("case", ["spike", "trend", "const_1e15", "int", "leading_nan"])
def test_window_sums_and_variances_keep_their_precision(case, window):
    x = _precision_series(case)
    n = len(x)
    ex = _exact_windows(x, window)
    k = ex["k"]
    eps = np.finfo(np.float64).eps
    g = (int(np.ceil(np.log2(n))) + 2) * eps
    var_bound = 4 * k * (g * ex["R"] ** 2 + eps * ex["R"] * ex["M"])
    ps = pandas.Series(x)
    for op in ("sum", "mean", "var", "std", "sem"):
        if window is None:
            got = tw.expanding_reduce(op, [torch.as_tensor(x)], n, 1)[0].numpy()
            want = getattr(ps.expanding(min_periods=1), op)().to_numpy()
        else:
            got = tw.rolling_reduce(op, [torch.as_tensor(x)], n, window, 1)[0].numpy()
            want = getattr(ps.rolling(window, min_periods=1), op)().to_numpy()
        what = f"{case} {window} {op}"
        assert np.array_equal(np.isnan(got), np.isnan(want)), f"{what}: NaN positions differ"
        m = ~np.isnan(want)
        dof = np.maximum(k - 1, 1)
        if op == "sum":
            exact, bound = ex["sum"], g * ex["S"]
            g_err, p_err = np.abs(got - exact), np.abs(want - exact)
        elif op == "mean":
            exact, bound = ex["mean"], g * ex["S"] / np.maximum(k, 1)
            g_err, p_err = np.abs(got - exact), np.abs(want - exact)
        else:
            # var, and std/sem through their squares (sqrt and the division
            # by the count round a few times more: 8 eps of the variance)
            scale = 1.0 / np.maximum(k, 1) if op == "sem" else 1.0
            exact = ex["m2"] / dof * scale
            bound = (var_bound / dof + 8 * eps * ex["m2"] / dof) * scale
            if op == "var":
                g_err, p_err = np.abs(got - exact), np.abs(want - exact)
            else:
                g_err, p_err = np.abs(got * got - exact), np.abs(want * want - exact)
        bad = m & (g_err > p_err + bound)
        assert not bad.any(), (
            f"{what}: {int(bad.sum())} windows beyond pandas' error + bound, worst excess "
            f"{float(np.max((g_err - p_err - bound)[bad]))}")
        if case == "const_1e15" and op in ("var", "std", "sem"):
            # a window of equal values has variance 0 exactly, as in pandas
            const = m & (np.arange(n) < 1200)
            assert np.all(got[const] == 0) and np.all(want[const] == 0), what


def test_spike_rolling_var_is_pandas_once_the_spike_has_left():
    x = _precision_series("spike")
    got = tw.rolling_reduce("var", [torch.as_tensor(x)], len(x), 10, 10)[0].numpy()
    want = pandas.Series(x).rolling(10).var().to_numpy()
    # windows of N(0, 1) values alone: pandas gives ~1, the port agrees
    np.testing.assert_allclose(got[19:], want[19:], rtol=1e-9)


# ---------------------------------------------------------------------- #
# elementwise cumulative ops, shift/diff, pow; skew/kurt
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("op", ["cumsum", "cumprod", "cummax", "cummin"])
@pytest.mark.parametrize("kind", ["clean", "nan", "int"])
def test_cumulative_matches_jax(op, kind):
    c = _column(kind, seed=9)
    if op == "cumprod":
        c = 1 + c / 1000.0 if kind != "int" else (c % 3) - 1
    got = elementwise.unary_op_columns(op, [torch.as_tensor(c)])[0].numpy()
    from_jax = np.asarray(jax_elementwise.get_op(op)(jnp.asarray(c)))
    assert got.dtype == from_jax.dtype
    _close(got, from_jax, f"{op} {kind}", exact=kind == "int" or op in ("cummax", "cummin"))


@pytest.mark.parametrize("periods", [0, 1, 3, -2, N, -N - 5])
@pytest.mark.parametrize("kind", ["nan", "int"])
def test_shift_and_diff_match_jax(periods, kind):
    c = _column(kind, seed=10)
    for name in ("shift_columns", "diff_columns"):
        got = getattr(elementwise, name)([torch.as_tensor(c)], N, periods)[0].numpy()
        from_jax = np.asarray(getattr(jax_elementwise, name)([jnp.asarray(c)], N, periods)[0])
        assert got.dtype == from_jax.dtype, name
        _close(got, from_jax, f"{name} {periods}", exact=True)


@pytest.mark.parametrize("other", [2, 0.5, -1.5])
@pytest.mark.parametrize("op", ["pow", "rpow"])
def test_pow_matches_jax(op, other):
    c = np.abs(_column("nan", seed=11)) + 0.5
    got = materialize(elementwise.binary_op_columns(op, [torch.as_tensor(c)], other)[0]).numpy()
    from_jax = np.asarray(jax_elementwise.get_op(op)(jnp.asarray(c), other))
    _close(got, from_jax, f"{op} {other}")


@pytest.mark.parametrize("op", ["skew", "kurt"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("skipna", [True, False])
def test_skew_kurt_match_jax(op, kind, skipna):
    c = _column(kind, seed=12)
    if kind == "inf":
        c = np.where(np.isinf(c), 1.0, c)  # the moments of inf are NaN in every package
    got = reductions.reduce_columns(op, [torch.as_tensor(c)], N, skipna=skipna)[0]
    want = getattr(pandas.Series(c), op)(skipna=skipna)
    _close(got, want, f"{op} {kind} vs pandas")
    if kind != "const":
        # a zero variance gives 0 in pandas and the port, NaN in the JAX package
        from_jax = np.asarray(jax_reductions.reduce_columns(op, [jnp.asarray(c)], N, skipna=skipna)[0])
        _close(got, from_jax, f"{op} {kind}")


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_skew_kurt_short_columns_are_nan(n):
    c = torch.arange(n, dtype=torch.float64)
    for op in ("skew", "kurt"):
        got = float(reductions.reduce_columns(op, [c], n)[0])
        want = getattr(pandas.Series(c.numpy()), op)()
        assert np.isnan(got) == np.isnan(want)
        if not np.isnan(want):
            assert abs(got - want) <= 1e-12 * abs(want)


# ---------------------------------------------------------------------- #
# the API: the window phase's calls, against modin_tpu.pandas and pandas
# ---------------------------------------------------------------------- #


def make_data(rows, seed=0, ngroups=100):
    rng = np.random.default_rng(seed)
    data = {f"col{i}": rng.integers(0, 100, rows) for i in range(3)}
    data["groupby_col"] = rng.integers(0, ngroups, rows)
    return data


def float_data(rows, seed=1):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 40, rows) / 8.0
    key[rng.random(rows) < 0.05] = np.nan
    val = rng.uniform(0, 100, rows)
    val[rng.random(rows) < 0.05] = np.nan
    val[rng.random(rows) < 0.01] = np.inf
    return {"key": key, "val": val, "ival": rng.integers(0, 30, rows)}


API_QUERIES = {
    "cumsum": lambda d: d.cumsum(),
    "cummax": lambda d: d.cummax(),
    "cummin": lambda d: d.cummin(),
    "cumprod": lambda d: (d % 2 + 1).cumprod(),
    "shift_1": lambda d: d.shift(1),
    "shift_neg": lambda d: d.shift(-3),
    "diff": lambda d: d.diff(),
    "diff_2": lambda d: d.diff(2),
    "pow_half": lambda d: d ** 0.5,
    "rpow": lambda d: 1.01 ** d,
    "skew": lambda d: d.skew(),
    "kurt": lambda d: d.kurt(),
    "series_cumsum": lambda d: d["col0"].cumsum(),
    **{f"rolling_{w}_{op}": (lambda d, w=w, op=op: getattr(d.rolling(w), op)())
       for w in (10, 100) for op in ("sum", "mean", "std", "var", "min", "max", "count", "sem")},
    "rolling_min_periods": lambda d: d.rolling(20, min_periods=5).mean(),
    "expanding_mean": lambda d: d.expanding().mean(),
    "expanding_std": lambda d: d.expanding().std(),
    "expanding_max": lambda d: d.expanding(min_periods=3).max(),
    "ewm_halflife_mean": lambda d: d.ewm(halflife=10).mean(),
    "ewm_halflife_std": lambda d: d.ewm(halflife=10).std(),
    "ewm_span_var_bias": lambda d: d.ewm(span=5).var(bias=True),
    "ewm_alpha_noadjust": lambda d: d.ewm(alpha=0.1, adjust=False).mean(),
    "ewm_com_sum": lambda d: d.ewm(com=3).sum(),
    "ewm_series_corr": lambda d: d["col0"].ewm(span=20).corr(d["col1"]),
    "ewm_series_cov": lambda d: d["col0"].ewm(span=20).cov(d["col1"]),
    "ewm_frame_corr": lambda d: d[["col0", "col1"]].ewm(span=20).corr(d[["col0", "col1"]] * 2 - d[["col1", "col0"]].rename(columns={"col1": "col0", "col0": "col1"})),
}

FLOAT_QUERIES = {
    "float_cumsum": lambda d: d.cumsum(),
    "float_cumprod": lambda d: (1 + d[["val"]] * 1e-3).cumprod(),
    "float_pow_2": lambda d: d ** 2,
    "float_diff": lambda d: d.diff(),
    "float_rolling_mean": lambda d: d.rolling(10).mean(),
    "float_rolling_std": lambda d: d.rolling(10).std(),
    "float_expanding_min": lambda d: d.expanding().min(),
    "float_ewm_mean": lambda d: d.ewm(halflife=10).mean(),
    "float_ewm_ignore_na": lambda d: d.ewm(alpha=0.3, ignore_na=True).std(),
    "float_skew": lambda d: d.skew(),
}


def _assert_equal(got, want):
    if isinstance(want, pandas.DataFrame):
        pandas.testing.assert_frame_equal(got, want, rtol=RTOL, atol=ATOL)
    elif isinstance(want, pandas.Series):
        pandas.testing.assert_series_equal(got, want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _check_api(fn, data):
    want = fn(pandas.DataFrame(data))
    from_jax = fn(mpd.DataFrame(data))
    from_jax = jax_to_pandas(from_jax) if hasattr(from_jax, "_query_compiler") else from_jax
    defaults = tqc.DEFAULTS_TO_PANDAS
    got = fn(tpd.DataFrame(data))
    assert tqc.DEFAULTS_TO_PANDAS == defaults, "a device query defaulted to pandas"
    got = tpd.to_pandas(got)
    _assert_equal(got, want)
    _assert_equal(got, from_jax)


@pytest.mark.parametrize("query", sorted(API_QUERIES))
def test_window_phase_queries_match_jax_and_pandas(query):
    _check_api(API_QUERIES[query], make_data(1000, seed=3))


@pytest.mark.parametrize("query", sorted(FLOAT_QUERIES))
def test_float_queries_match_jax_and_pandas(query):
    _check_api(FLOAT_QUERIES[query], float_data(1000))


def test_window_objects_are_the_ports():
    df = tpd.DataFrame(make_data(50))
    defaults = tqc.DEFAULTS_TO_PANDAS
    assert isinstance(df.rolling(3), Rolling)
    assert isinstance(df["col0"].rolling(3), Rolling)
    assert isinstance(df.expanding(), Expanding)
    assert isinstance(df.ewm(alpha=0.5), Ewm)
    assert tqc.DEFAULTS_TO_PANDAS == defaults
    assert isinstance(df["col0"].rolling(3).sum(), tpd.Series)
    assert isinstance(df.ewm(alpha=0.5).mean(), tpd.DataFrame)


def _int8_data(rows, seed=0):
    return {k: v.astype(np.int8) for k, v in make_data(rows, seed).items()}


def _float_data(rows, seed=0):
    return {k: v.astype(np.float64) for k, v in make_data(rows, seed).items()}


@pytest.mark.parametrize(
    "query,data",
    [
        (lambda d: d.rolling(3, center=True).sum(), make_data),
        (lambda d: d.rolling(3).median(), make_data),
        (lambda d: d.rolling(3, closed="left").mean(), make_data),
        (lambda d: d.expanding().quantile(0.5), make_data),
        (lambda d: d.ewm(alpha=0.5).corr(), make_data),
        (lambda d: d.cumsum(skipna=False), _float_data),
        (lambda d: d.shift(1, fill_value=0), make_data),
        (lambda d: d.diff(), _int8_data),
        (lambda d: d ** 2, make_data),
    ],
    ids=["center", "median", "closed", "expanding_quantile", "ewm_frame_pairwise",
         "cumsum_noskipna_float", "shift_fill_value", "diff_int8", "int_pow_int"],
)
def test_declined_window_queries_default_to_pandas_once(query, data):
    d = data(200, seed=4)
    want = query(pandas.DataFrame(d))
    defaults = tqc.DEFAULTS_TO_PANDAS
    got = tpd.to_pandas(query(tpd.DataFrame(d)))
    assert tqc.DEFAULTS_TO_PANDAS == defaults + 1
    _assert_equal(got, want)


def test_ewm_sum_without_adjust_raises_as_pandas_does():
    d = make_data(50)
    with pytest.raises(NotImplementedError):
        pandas.DataFrame(d).ewm(alpha=0.5, adjust=False).sum()
    with pytest.raises(NotImplementedError):
        tpd.DataFrame(d).ewm(alpha=0.5, adjust=False).sum()
