"""The sort-shaped breadth of the torch port: ``idxmin``/``idxmax``,
``nlargest``/``nsmallest``, ``rank`` and ``duplicated``/``drop_duplicates``.

``ops/reductions.idx_minmax``, ``ops/sort.top_k_positions``,
``ops/sort.rank_columns`` and ``ops/join.duplicated_mask`` are held against
the JAX package's functions of the same names on the same numpy inputs
(padded JAX columns on the CPU mesh, the first ``n`` entries compared):
positions, masks and float64 ranks exactly.  ``rank_columns`` runs its
scans through ``scan_kernels.scan``, which on the CPU is the kernel's plain
version.  Then the compiler's paths run through ``modin_tpu_torch.pandas``,
``modin_tpu.pandas`` and pandas: pandas' result exactly, and as many
defaults to pandas as the JAX package counts (none on the probe frame).

One case where pandas and the JAX package disagree, and the port follows
pandas (ROADMAP Queue 3, item 3): ties of -0.0 and 0.0 in ``nlargest``/
``nsmallest``.  The JAX package's ``lax.top_k`` orders raw IEEE bits, so
-0.0 sorts below 0.0; pandas ties them and ``keep="first"`` takes the
earlier row.
"""

import threading
import warnings

import numpy as np
import pandas
import pytest
import torch

import modin_tpu.pandas as mpd
from modin_tpu.ops import join as jax_join
from modin_tpu.ops import reductions as jax_reductions
from modin_tpu.ops import sort as jax_sort
from modin_tpu.ops import structural as jax_structural
from modin_tpu.parallel.engine import JaxWrapper
from modin_tpu.utils import to_pandas as jax_to_pandas

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
from modin_tpu_torch.ops import join, reductions, sort

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


def _np(x, n=None) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a if n is None else a[:n]


def _key(kind: str, n: int = N, seed: int = 0, signed_zeros: bool = True) -> np.ndarray:
    """Keys with heavy ties; floats carry NaN, +/-inf and (unless asked
    not to) both signed zeros."""
    rng = np.random.default_rng(seed)
    if kind == "bool":
        return rng.random(n) < 0.5
    if kind in ("int64", "int32", "int8", "uint8"):
        lo = 0 if kind == "uint8" else -20
        return rng.integers(lo, lo + 40, n).astype(kind)
    x = rng.integers(-20, 20, n) / 4.0
    x[rng.random(n) < 0.1] = np.nan
    if signed_zeros:
        x[rng.random(n) < 0.05] = -0.0
    else:
        x[x == 0] = 0.25
    x[rng.random(n) < 0.02] = np.inf
    x[rng.random(n) < 0.02] = -np.inf
    return x.astype(kind)


FLOAT_KINDS = ["float64", "float32"]
INT_KINDS = ["int64", "int32", "int8", "uint8"]


# ---------------------------------------------------------------------- #
# the ops against the JAX package's
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("op", ["idxmin", "idxmax"])
def test_idx_minmax(op):
    cols = [_key(k, seed=i) for i, k in enumerate(FLOAT_KINDS + INT_KINDS)]
    all_nan = np.full(N, np.nan)
    cols.append(all_nan)
    want_pos, want_counts = jax_reductions.idx_minmax(op, [_jax(c) for c in cols], N)
    got_pos, got_counts = reductions.idx_minmax(op, [torch.as_tensor(c) for c in cols], N)
    assert got_counts == want_counts
    assert got_pos[:-1] == want_pos[:-1]  # the all-NaN column has no answer
    assert got_counts[-1] == 0
    for c, pos in zip(cols[:-1], got_pos[:-1]):
        assert pos == getattr(pandas.Series(c), op)()


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("k", [1, 7, 500, 1900])
@pytest.mark.parametrize("kind", FLOAT_KINDS + INT_KINDS + ["bool"])
def test_top_k_positions(kind, k, largest):
    """Ties in row order and NaN rows last (k = 1900 passes the valid
    count of the float keys); equal to the JAX package where no -0.0 ties
    0.0, and to pandas' ``nlargest``/``nsmallest`` always."""
    x = _key(kind, seed=7, signed_zeros=False)
    got = _np(sort.top_k_positions(torch.as_tensor(x), N, k, largest))
    want, _ = jax_sort.top_k_positions(_jax(x), N, k, largest)
    np.testing.assert_array_equal(got, np.asarray(want, np.int64))
    s = pandas.Series(x)
    expect = (s.nlargest(k) if largest else s.nsmallest(k)).index.to_numpy()
    np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize("largest", [True, False])
def test_top_k_signed_zero_ties_follow_pandas(largest):
    x = _key("float64", seed=8)
    got = _np(sort.top_k_positions(torch.as_tensor(x), N, 1500, largest))
    s = pandas.Series(x)
    expect = (s.nlargest(1500) if largest else s.nsmallest(1500)).index.to_numpy()
    np.testing.assert_array_equal(got, expect)
    # the JAX package orders -0.0 below 0.0 and so picks other rows
    want, _ = jax_sort.top_k_positions(_jax(x), N, 1500, largest)
    assert not np.array_equal(got, np.asarray(want, np.int64))


@pytest.mark.parametrize("pct", [False, True])
@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("na_option", ["keep", "top", "bottom"])
@pytest.mark.parametrize("method", ["average", "min", "max", "first", "dense"])
def test_rank_columns(method, na_option, ascending, pct):
    """float64 ranks equal to the JAX package's and to pandas', exactly."""
    cols = [_key(k, seed=9 + i) for i, k in enumerate(["float64", "float32", "int64", "int8", "bool"])]
    want = jax_sort.rank_columns([_jax(c) for c in cols], N, method, ascending, na_option, pct)
    got = sort.rank_columns([torch.as_tensor(c) for c in cols], N, method, ascending, na_option, pct)
    for c, g, w in zip(cols, got, want):
        g = _np(g)
        np.testing.assert_array_equal(g, _np(w, N))
        expect = pandas.Series(c).rank(method=method, na_option=na_option, ascending=ascending, pct=pct)
        np.testing.assert_array_equal(g, expect.to_numpy())


@pytest.mark.parametrize("keep", ["first", "last", False])
@pytest.mark.parametrize("kinds", [("float64",), ("int64",), ("float32", "int8"), ("int32", "float64", "bool")])
def test_duplicated_mask(kinds, keep):
    """NaN equals NaN and -0.0 equals 0.0, as in pandas."""
    cols = [_key(k, seed=20 + i) for i, k in enumerate(kinds)]
    if len(kinds) > 1:
        cols = [c[np.arange(N) % 300] for c in cols]  # whole rows repeat
    want = jax_join.duplicated_mask([_jax(c) for c in cols], N, keep)
    got = _np(join.duplicated_mask([torch.as_tensor(c) for c in cols], N, keep))
    np.testing.assert_array_equal(got, _np(want, N))
    expect = pandas.DataFrame({i: c for i, c in enumerate(cols)}).duplicated(keep=keep)
    np.testing.assert_array_equal(got, expect.to_numpy())


# ---------------------------------------------------------------------- #
# the compiler's paths through the API, against modin_tpu and pandas
# ---------------------------------------------------------------------- #


def _frame(name: str) -> dict:
    rng = np.random.default_rng(31)
    n = N
    f = rng.integers(-30, 30, n) / 8.0
    f[::7] = np.nan
    base = {"a": rng.integers(-5, 5, n), "f": f, "g": rng.normal(size=n)}
    if name == "int":
        return {"a": rng.integers(-50, 50, n), "b": rng.integers(0, 100, n).astype(np.int32)}
    if name == "float":
        return base
    if name == "float32":
        return {"a": rng.integers(-5, 5, n), "f": f.astype(np.float32), "g": base["g"].astype(np.float32)}
    if name == "bool":
        return {"a": rng.integers(-5, 5, n), "b": rng.random(n) < 0.5, "f": f}
    if name == "datetime":
        t = pandas.to_datetime(rng.integers(0, 10**17, n))
        return {"a": rng.integers(-5, 5, n), "f": f, "t": t.where(rng.random(n) > 0.1)}
    assert name == "mixed"
    return dict(base, s=np.array(["x", "y", None, "zz"] * (n // 4) + ["x"] * (n % 4), dtype=object))


FRAMES = ["int", "float", "float32", "bool", "datetime", "mixed"]

QUERIES = {
    "idxmin": lambda d: d.idxmin(),
    "idxmax": lambda d: d.idxmax(),
    "series_idxmax": lambda d: d["a"].idxmax(),
    "series_idxmin_last": lambda d: d[d.columns[-1]].idxmin(),
    "nlargest": lambda d: d.nlargest(5, "a"),
    "nsmallest_last": lambda d: d.nsmallest(1990, d.columns[-1]),
    "series_nlargest": lambda d: d[d.columns[1]].nlargest(7),
    "series_nsmallest": lambda d: d[d.columns[1]].nsmallest(1995),
    "rank": lambda d: d.rank(),
    "rank_numeric_only": lambda d: d.rank(numeric_only=True, method="min"),
    "series_rank": lambda d: d[d.columns[1]].rank(method="dense", pct=True),
    "duplicated_a": lambda d: d.duplicated(["a"]),
    "duplicated_all": lambda d: d.duplicated(keep=False),
    "duplicated_two_last": lambda d: d.duplicated([d.columns[0], d.columns[-1]], keep="last"),
    "drop_duplicates_a": lambda d: d.drop_duplicates(["a"]),
    "drop_duplicates_last_ignore_index": lambda d: d.drop_duplicates(
        [d.columns[0], d.columns[-1]], keep="last", ignore_index=True),
    "series_duplicated": lambda d: d[d.columns[-1]].duplicated(keep=False),
    "series_drop_duplicates": lambda d: d[d.columns[-1]].drop_duplicates(),
}


def _run(fn, data):
    def attempt(make, convert):
        try:
            return convert(fn(make(data)))
        except Exception as err:  # the reference's own error is the answer
            return err

    want = attempt(pandas.DataFrame, lambda r: r)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        attempt(mpd.DataFrame, lambda r: jax_to_pandas(r) if hasattr(r, "_query_compiler") else r)
    jax_defaults = sum("defaulting to in-process pandas" in str(w.message) for w in caught)
    before = tqc.DEFAULTS_TO_PANDAS
    from_torch = attempt(tpd.DataFrame, lambda r: tpd.to_pandas(r) if hasattr(r, "_query_compiler") else r)
    return want, jax_defaults, from_torch, tqc.DEFAULTS_TO_PANDAS - before


def _assert_same(got, want):
    if isinstance(want, Exception):
        assert type(got) is type(want), (got, want)
    elif isinstance(want, pandas.DataFrame):
        pandas.testing.assert_frame_equal(got, want, check_exact=True)
    elif isinstance(want, pandas.Series):
        pandas.testing.assert_series_equal(got, want, check_exact=True)
    else:
        # a Series reduction comes back as a numpy scalar (np.int64 where
        # pandas gives the label as int): equal values
        assert got == want, (got, want)


@pytest.mark.parametrize("query", sorted(QUERIES))
@pytest.mark.parametrize("frame", FRAMES)
def test_queries_against_modin_tpu_and_pandas(frame, query):
    want, jax_defaults, from_torch, defaults = _run(QUERIES[query], _frame(frame))
    _assert_same(from_torch, want)
    assert defaults == jax_defaults, (defaults, jax_defaults)


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_probe_queries_stay_on_the_device(query):
    want, jax_defaults, from_torch, defaults = _run(QUERIES[query], _frame("float"))
    _assert_same(from_torch, want)
    assert (defaults, jax_defaults) == (0, 0)


@pytest.mark.parametrize("pct", [False, True])
@pytest.mark.parametrize("na_option", ["keep", "top", "bottom"])
@pytest.mark.parametrize("method", ["average", "min", "max", "first", "dense"])
def test_rank_every_option(method, na_option, pct):
    for ascending in (True, False):
        fn = lambda d: d.rank(method=method, na_option=na_option, ascending=ascending, pct=pct)  # noqa: E731
        want, jax_defaults, from_torch, defaults = _run(fn, _frame("float32"))
        _assert_same(from_torch, want)
        assert (defaults, jax_defaults) == (0, 0)


# ---------------------------------------------------------------------- #
# pandas' edges
# ---------------------------------------------------------------------- #


def _same_on_device(fn, data, series: bool = False):
    make_p = pandas.Series if series else pandas.DataFrame
    make_t = tpd.Series if series else tpd.DataFrame
    want = fn(make_p(data))
    before = tqc.DEFAULTS_TO_PANDAS
    got = fn(make_t(data))
    got = tpd.to_pandas(got) if hasattr(got, "_query_compiler") else got
    assert tqc.DEFAULTS_TO_PANDAS == before
    _assert_same(got, want)
    return got


@pytest.mark.parametrize("method", ["nlargest", "nsmallest"])
def test_signed_zero_ties_in_nlargest_nsmallest(method):
    data = [-0.0, 0.0, -1.0] if method == "nlargest" else [0.0, -0.0, 1.0]
    got = _same_on_device(lambda s: getattr(s, method)(1), data, series=True)
    assert got.index.tolist() == [0]
    # the JAX package gives [1] here
    assert jax_to_pandas(getattr(mpd.Series(data), method)(1)).index.tolist() == [1]


def test_nsmallest_k_past_the_valid_count():
    got = _same_on_device(lambda s: s.nsmallest(6), [3.0, np.nan, 1.0, np.nan, 2.0, 1.0, np.nan], series=True)
    assert got.index.tolist() == [2, 5, 4, 0, 1, 3]


def test_duplicated_nan_and_signed_zeros():
    got = _same_on_device(lambda s: s.duplicated(), [0.0, -0.0, np.nan, np.nan, 1.0, 1.0], series=True)
    assert got.tolist() == [False, True, False, True, False, True]


def test_rank_signed_zeros_tie():
    got = _same_on_device(lambda s: s.rank(), [0.0, -0.0, 1.0], series=True)
    assert got.tolist() == [1.5, 1.5, 3.0]


def test_idxmax_ties_take_the_first_row():
    assert _same_on_device(lambda s: s.idxmax(), [1.0, 3.0, 3.0, np.nan], series=True) == 1
    # NaN reads as -inf for idxmax, as in pandas: the first of the ties
    assert _same_on_device(lambda s: s.idxmax(), [np.nan, -np.inf], series=True) == 0


def test_idxmax_takes_the_index_labels():
    data = {"a": [3, 9, 9, 1], "f": [0.5, np.nan, 2.5, 2.5]}
    idx = pandas.Index(["w", "x", "y", "z"])
    want = pandas.DataFrame(data, index=idx).idxmax()
    before = tqc.DEFAULTS_TO_PANDAS
    got = tpd.to_pandas(tpd.DataFrame(data, index=idx).idxmax())
    assert tqc.DEFAULTS_TO_PANDAS == before
    pandas.testing.assert_series_equal(got, want)


# ---------------------------------------------------------------------- #
# gates: one default each, pandas' result or pandas' error
# ---------------------------------------------------------------------- #


DECLINED = {
    "idxmax_all_nan": (lambda d: d.assign(f=np.nan).idxmax(), "float"),
    "idxmin_skipna_false": (lambda d: d.idxmin(skipna=False), "float"),
    "nlargest_keep_all": (lambda d: d.nlargest(5, "a", keep="all"), "float"),
    "nlargest_two_columns": (lambda d: d.nlargest(5, ["a", "f"]), "float"),
    "rank_axis1": (lambda d: d.rank(axis=1), "float"),
    "duplicated_missing_label": (lambda d: d.duplicated(["nope"]), "float"),
    "drop_duplicates_datetime_key": (lambda d: d.drop_duplicates(["t"]), "datetime"),
}


@pytest.mark.parametrize("case", sorted(DECLINED))
def test_gates_default_once(case):
    fn, frame = DECLINED[case]
    data = _frame(frame)
    try:
        want = fn(pandas.DataFrame(data))
    except Exception as err:
        want = err
    before = tqc.DEFAULTS_TO_PANDAS
    try:
        got = fn(tpd.DataFrame(data))
        got = tpd.to_pandas(got) if hasattr(got, "_query_compiler") else got
    except Exception as err:
        got = err
    assert tqc.DEFAULTS_TO_PANDAS == before + 1
    _assert_same(got, want)
