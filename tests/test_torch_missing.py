"""Missing data, dtypes and masked assignment in the torch port.

The map kernels of ``modin_tpu_torch/ops/elementwise.py`` (``isna_columns``,
``round_columns``, ``fillna_columns``, ``clip_columns``, ``astype_column``)
are held against the JAX package's (``modin_tpu/ops/elementwise.py``, padded
JAX columns on the CPU mesh, the first ``n`` entries compared) bit for bit.
Then the compiler's device paths (``isna``/``notna``, ``round``, ``fillna``,
``clip``, ``astype``, ``setitem_bool``, ``dropna`` and the host-column half
of ``_map_device_host``) run through ``modin_tpu_torch.pandas``,
``modin_tpu.pandas`` and pandas on int, float-with-NaN, float32, bool,
datetime-with-NaT and mixed string frames: the port gives pandas' result
exactly (values, dtypes, index), and counts as many defaults to pandas as
the JAX package does: none on the queries both run on the device.

Where pandas and the JAX package disagree the port follows pandas (ROADMAP
Queue 3, item 3), and a test here says so: ``round`` with negative decimals
on int columns (the JAX package leaves them as they are; pandas rounds half
to even), and ``clip`` of an int column by a fractional bound that clips
nothing (pandas keeps the int dtype, the JAX package gives float64).
"""

import threading
import warnings

import numpy as np
import pandas
import pytest
import torch

import modin_tpu.pandas as mpd
from modin_tpu.ops import elementwise as jax_elementwise
from modin_tpu.ops import structural as jax_structural
from modin_tpu.ops.lazy import materialize_exprs
from modin_tpu.parallel.engine import JaxWrapper
from modin_tpu.utils import to_pandas as jax_to_pandas

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
from modin_tpu_torch.ops import elementwise
from modin_tpu_torch.ops.lazy import materialize_exprs as materialize

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


def _jax_values(exprs, n: int = N):
    return [np.asarray(a)[:n] for a in materialize_exprs(list(exprs))]


def _assert_bitwise(got, want: np.ndarray) -> None:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    if got.dtype.kind == "f":
        np.testing.assert_array_equal(got.view(f"i{got.itemsize}"), want.view(f"i{want.itemsize}"))
    else:
        np.testing.assert_array_equal(got, want)


def _column(kind: str, n: int = N, seed: int = 0) -> np.ndarray:
    """Columns with NaN, +/-inf, both zeros and halves (floats), ties
    (ints), and the NaT sentinel (datetimes, as int64 ticks)."""
    rng = np.random.default_rng(seed)
    if kind == "bool":
        return rng.random(n) < 0.4
    if kind in ("int64", "int32", "int8", "uint8"):
        lo, hi = {"int64": (-10**6, 10**6), "int32": (-10**5, 10**5), "int8": (-128, 128),
                  "uint8": (0, 256)}[kind]
        return rng.integers(lo, hi, n).astype(kind)
    if kind == "datetime":
        x = rng.integers(0, 10**17, n)
        x[rng.random(n) < 0.1] = np.iinfo(np.int64).min
        return x
    x = rng.normal(0, 100, n)
    halves = rng.random(n) < 0.1
    x[halves] = np.round(x[halves]) + 0.5
    x[rng.random(n) < 0.05] = 0.125
    x[rng.random(n) < 0.05] = 2.675
    x[rng.random(n) < 0.1] = np.nan
    x[rng.random(n) < 0.03] = -0.0
    x[rng.random(n) < 0.02] = np.inf
    x[rng.random(n) < 0.02] = -np.inf
    return x.astype(kind)


# ---------------------------------------------------------------------- #
# the map kernels against the JAX package's
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("negate", [False, True])
def test_isna_columns(negate):
    kinds = ["float64", "float32", "int64", "bool", "datetime"]
    cols = [_column(k, seed=i) for i, k in enumerate(kinds)]
    flags = tuple(k == "datetime" for k in kinds)
    want = _jax_values(jax_elementwise.isna_columns([_jax(c) for c in cols], flags, negate))
    got = materialize(elementwise.isna_columns([torch.as_tensor(c) for c in cols], flags, negate))
    for g, w in zip(got, want):
        _assert_bitwise(g, w)


@pytest.mark.parametrize("kind", ["float64", "float32"])
@pytest.mark.parametrize("decimals", [-2, -1, 0, 1, 2, 3])
def test_round_floats(kind, decimals):
    """Bit for bit numpy's (pandas') round.  The JAX package's agrees bit
    for bit for ``decimals`` <= 0; above, ``jnp.round`` scales otherwise
    and is one unit in the last place off numpy in many values, so it is
    held to one ulp there (the port follows pandas)."""
    x = _column(kind, seed=3)
    (want,) = _jax_values(jax_elementwise.round_columns([_jax(x)], decimals))
    (got,) = materialize(elementwise.round_columns([torch.as_tensor(x)], decimals))
    _assert_bitwise(got, np.round(x, decimals))
    if decimals <= 0:
        _assert_bitwise(got, want)
    else:
        ulps = np.abs(got.numpy().view(f"i{x.itemsize}").astype(np.int64)
                      - want.view(f"i{x.itemsize}").astype(np.int64))
        assert ulps.max() <= 1


@pytest.mark.parametrize("kind", ["int64", "int32", "int8", "uint8"])
@pytest.mark.parametrize("decimals", [-3, -2, -1, 0, 2])
def test_round_ints(kind, decimals):
    """pandas' (numpy's) rounding of ints: half to even, wrapping in the
    column's dtype.  The JAX package returns every int column unchanged, so
    it differs from pandas for ``decimals`` < 0 and the port follows
    pandas."""
    x = _column(kind, seed=4)
    x[:6] = np.array([15, 25, -35, 7, 125, 5]).astype(kind)
    (got,) = materialize(elementwise.round_columns([torch.as_tensor(x)], decimals))
    _assert_bitwise(got, pandas.Series(x).round(decimals).to_numpy())
    (jax_got,) = _jax_values(jax_elementwise.round_columns([_jax(x)], decimals))
    _assert_bitwise(jax_got, x)


@pytest.mark.parametrize("value", [0, 1.5, 0.1, -7])
def test_fillna_columns(value):
    cols = [_column(k, seed=i) for i, k in enumerate(["float64", "float32", "int64", "bool"])]
    want = _jax_values(jax_elementwise.fillna_columns([_jax(c) for c in cols], value))
    got = materialize(elementwise.fillna_columns([torch.as_tensor(c) for c in cols], value))
    for g, w, c in zip(got, want, cols):
        _assert_bitwise(g, w)
        _assert_bitwise(g, pandas.Series(c).fillna(value).to_numpy())


@pytest.mark.parametrize("bounds", [(-1, 1), (-50.5, 20.25), (None, 3), (-3, None)])
@pytest.mark.parametrize("kind", ["float64", "float32", "int64", "int32"])
def test_clip_columns(kind, bounds):
    lower, upper = bounds
    x = _column(kind, seed=5)
    if kind.startswith("int") and any(b is not None and not float(b).is_integer() for b in bounds):
        x = x.astype(np.float64)  # the compiler casts first (pandas' result dtype)
    (want,) = _jax_values(jax_elementwise.clip_columns([_jax(x)], lower, upper))
    (got,) = materialize(elementwise.clip_columns([torch.as_tensor(x)], lower, upper))
    _assert_bitwise(got, want)


@pytest.mark.parametrize(
    "source,target",
    [("int64", "float64"), ("int64", "float32"), ("int64", "int32"), ("int64", "int8"),
     ("int64", "uint8"), ("float64", "float32"), ("float32", "float64"), ("bool", "int64"),
     ("int8", "float64")],
)
def test_astype_column(source, target):
    x = _column(source, seed=6)
    want = np.asarray(jax_elementwise.astype_column(_jax(x), np.dtype(target)))[:N]
    (got,) = materialize([elementwise.astype_column(torch.as_tensor(x), np.dtype(target))])
    _assert_bitwise(got, want)
    _assert_bitwise(got, x.astype(target))


# ---------------------------------------------------------------------- #
# the compiler's paths through the API, against modin_tpu and pandas
# ---------------------------------------------------------------------- #


def _frame(name: str) -> dict:
    rng = np.random.default_rng(11)
    n = N
    # multiples of 1/64: every sum is exact, so ``fillna(df.mean())`` fills
    # the same means whatever order each package sums in
    f = np.round(rng.normal(0, 3, n) * 64) / 64
    f[::7] = np.nan
    g = np.round(rng.normal(size=n) * 64) / 64
    base = {"a": rng.integers(-5, 5, n), "f": f, "g": g}
    if name == "int":
        return {"a": rng.integers(-50, 50, n), "b": rng.integers(0, 100, n).astype(np.int32)}
    if name == "float":
        return base
    if name == "float32":
        return {"a": rng.integers(-5, 5, n), "f": f.astype(np.float32), "g": g.astype(np.float32)}
    if name == "bool":
        return {"a": rng.integers(-5, 5, n), "b": rng.random(n) < 0.5, "f": f}
    if name == "datetime":
        t = pandas.to_datetime(rng.integers(0, 10**17, n))
        t = t.where(rng.random(n) > 0.1)
        return {"a": rng.integers(-5, 5, n), "f": f, "t": t}
    strings = np.array(["x", "y", None, "zz"] * (n // 4) + ["x"] * (n % 4), dtype=object)
    if name == "mixed":
        return dict(base, s=strings)  # pandas 3 makes this a str column
    # an object column stays object only when its Series says so
    assert name == "mixed_object"
    return dict(base, s=pandas.Series(strings, dtype=object))


FRAMES = ["int", "float", "float32", "bool", "datetime", "mixed", "mixed_object"]


def _set_loc(col, value):
    def fn(d):
        d = d.copy()
        d.loc[d["a"] > 0, col] = value
        return d

    return fn


QUERIES = {
    "isna": lambda d: d.isna(),
    "notna": lambda d: d.notna(),
    "series_isna": lambda d: d["a"].isna(),
    "fillna_0": lambda d: d.fillna(0),
    "fillna_dict": lambda d: d.fillna({"f": 1.5, "a": 2}),
    "fillna_mean": lambda d: d.fillna(d.mean(numeric_only=True)),
    "series_fillna": lambda d: d[d.columns[-1]].fillna(-1),
    "dropna": lambda d: d.dropna(),
    "dropna_subset_all": lambda d: d.dropna(subset=[d.columns[-1]], how="all"),
    "astype_float64": lambda d: d.astype("float64"),
    "astype_float32": lambda d: d.astype("float32"),
    "astype_int32": lambda d: d.astype("int32"),
    "round_2": lambda d: d.round(2),
    "round_-1": lambda d: d.round(-1),
    "clip": lambda d: d.clip(-1, 1),
    "clip_float_bounds": lambda d: d.clip(-2.5, 3.25),
    "loc_int": _set_loc("a", 7),
    "loc_float": None,  # per frame: FLOAT_COLUMN
    "abs": lambda d: d.abs(),
    "negative": lambda d: -d,
}


def _run(fn, data):
    """(result or exception) of pandas, the JAX package (with its count of
    defaults) and the port (with its count)."""
    def attempt(make, convert):
        try:
            return convert(fn(make(data)))
        except Exception as err:  # the reference's own error is the answer
            return err

    want = attempt(pandas.DataFrame, lambda r: r)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        from_jax = attempt(mpd.DataFrame, jax_to_pandas)
    jax_defaults = sum("defaulting to in-process pandas" in str(w.message) for w in caught)
    before = tqc.DEFAULTS_TO_PANDAS
    from_torch = attempt(tpd.DataFrame, tpd.to_pandas)
    return want, from_jax, jax_defaults, from_torch, tqc.DEFAULTS_TO_PANDAS - before


def _assert_same(got, want):
    if isinstance(want, Exception):
        assert type(got) is type(want), (got, want)
    elif isinstance(want, pandas.DataFrame):
        pandas.testing.assert_frame_equal(got, want, check_exact=True)
    else:
        pandas.testing.assert_series_equal(got, want, check_exact=True)


# the float column that ``loc_float`` assigns to (the int frame has none)
FLOAT_COLUMN = {"float": "f", "float32": "g", "bool": "f", "datetime": "f", "mixed": "g",
                "mixed_object": "g"}


@pytest.mark.parametrize(
    "frame,query",
    [(f, q) for f in FRAMES for q in sorted(QUERIES) if not (f == "int" and q == "loc_float")],
)
def test_queries_against_modin_tpu_and_pandas(frame, query):
    fn = QUERIES[query] if query != "loc_float" else _set_loc(FLOAT_COLUMN[frame], 0.0)
    want, from_jax, jax_defaults, from_torch, defaults = _run(fn, _frame(frame))
    _assert_same(from_torch, want)
    assert defaults == jax_defaults, (defaults, jax_defaults)


# the probe frame of an int, a float-with-NaN and a normal column: every
# query here runs on the device in both packages
PROBE = [
    "isna", "notna", "fillna_0", "fillna_dict", "fillna_mean", "dropna", "dropna_subset_all",
    "astype_float64", "round_2", "clip", "loc_float",
]


@pytest.mark.parametrize("query", PROBE)
def test_probe_queries_stay_on_the_device(query):
    fn = QUERIES[query] if query != "loc_float" else _set_loc("f", 0.0)
    want, _, jax_defaults, from_torch, defaults = _run(fn, _frame("float"))
    _assert_same(from_torch, want)
    assert (defaults, jax_defaults) == (0, 0)


def test_mixed_frame_maps_keep_the_string_column_on_the_host():
    """``_map_device_host``: the device columns stay on the device, the
    string column goes through pandas' own function; a bool result of a
    host column (``isna``) goes to the device."""
    df = tpd.DataFrame(_frame("mixed"))
    before = tqc.DEFAULTS_TO_PANDAS
    for result, string_on_device in ((df.round(1), False), (df.fillna(0), False), (df.isna(), True),
                                     (df.notna(), True)):
        cols = result._query_compiler._modin_frame._columns
        assert [c.is_device for c in cols] == [True, True, True, string_on_device]
    assert tqc.DEFAULTS_TO_PANDAS == before


# ---------------------------------------------------------------------- #
# edges where the reference and pandas disagree, and pandas' own rules
# ---------------------------------------------------------------------- #


def test_round_negative_decimals_on_ints_follows_pandas():
    data = {"a": [15, 25, -35, 7], "i8": np.array([125, 5, 15, 127], dtype=np.int8)}
    want = pandas.DataFrame(data).round(-1)
    got = tpd.to_pandas(tpd.DataFrame(data).round(-1))
    pandas.testing.assert_frame_equal(got, want, check_exact=True)
    assert got["a"].tolist() == [20, 20, -40, 10]
    # the JAX package leaves int columns unchanged
    assert jax_to_pandas(mpd.DataFrame(data).round(-1))["a"].tolist() == [15, 25, -35, 7]


def test_round_leaves_datetimes():
    data = _frame("datetime")
    want = pandas.DataFrame(data).round(-2)
    got = tpd.to_pandas(tpd.DataFrame(data).round(-2))
    pandas.testing.assert_frame_equal(got, want, check_exact=True)


@pytest.mark.parametrize(
    "bounds",
    [(-1.5, 1.5), (0.5, 1.5), (-1, 1.0), (3, 1), (np.nan, 1), (-10.5, 10.5), (1.5, None)],
    ids=["frac-clips", "frac-lower-clips", "integral-float", "crossed", "nan-bound",
         "frac-clips-nothing", "lower-only"],
)
def test_clip_result_dtype_is_pandas(bounds):
    """An int column becomes float64 only where a fractional bound
    replaces a value (pandas' ``where``); crossed bounds swap and a NaN
    bound is no bound."""
    data = {"a": np.array([0, 1, 2, -3]), "i32": np.array([0, 1, 2, 3], np.int32),
            "f32": np.array([0.0, 1.0, np.nan, 2.0], np.float32)}
    want = pandas.DataFrame(data).clip(*bounds)
    before = tqc.DEFAULTS_TO_PANDAS
    got = tpd.to_pandas(tpd.DataFrame(data).clip(*bounds))
    assert tqc.DEFAULTS_TO_PANDAS == before
    pandas.testing.assert_frame_equal(got, want, check_exact=True)


def test_clip_fractional_bound_that_clips_nothing_keeps_ints():
    data = {"a": np.array([0, 1, 2])}
    assert tpd.to_pandas(tpd.DataFrame(data).clip(-10.5, 10.5))["a"].dtype == np.int64
    # the JAX package gives float64 there
    assert jax_to_pandas(mpd.DataFrame(data).clip(-10.5, 10.5))["a"].dtype == np.float64


@pytest.mark.parametrize("value", [0.1, 1e40, 3])
def test_float32_fill_and_assignment_cast_the_value(value):
    data = {"a": np.array([1, -1, 2]), "f": np.array([np.nan, 1.0, 2.0], np.float32)}
    for fn in (lambda d: d.fillna(value), _set_loc("f", value)):
        want = fn(pandas.DataFrame(data))
        before = tqc.DEFAULTS_TO_PANDAS
        with np.errstate(over="ignore"):
            got = tpd.to_pandas(fn(tpd.DataFrame(data)))
        assert tqc.DEFAULTS_TO_PANDAS == before
        pandas.testing.assert_frame_equal(got, want, check_exact=True)


# ---------------------------------------------------------------------- #
# gates: one default each, pandas' result or pandas' error
# ---------------------------------------------------------------------- #


def _declined(fn, data):
    try:
        want = fn(pandas.DataFrame(data))
    except Exception as err:
        want = err
    before = tqc.DEFAULTS_TO_PANDAS
    try:
        got = tpd.to_pandas(fn(tpd.DataFrame(data)))
    except Exception as err:
        got = err
    assert tqc.DEFAULTS_TO_PANDAS == before + 1
    _assert_same(got, want)


DECLINED = {
    "astype_float_to_int": (lambda d: d.astype("int64"), "float"),
    "loc_int_out_of_range": (_set_loc("b", 2**40), "int"),
    "loc_float_into_int": (_set_loc("a", 0.5), "int"),
    "dropna_thresh": (lambda d: d.dropna(thresh=2), "float"),
    "dropna_with_strings": (lambda d: d.dropna(), "mixed"),
    "round_-19_on_ints": (lambda d: d.round(-19), "int"),
    "clip_bound_past_int8": (lambda d: d.astype("int8").clip(-1, 1000), "int"),
    "fillna_bool_value": (lambda d: d.fillna(True), "float"),
    "fillna_limit": (lambda d: d.fillna(0, limit=1), "float"),
}


@pytest.mark.parametrize("case", sorted(DECLINED))
def test_gates_default_once(case):
    fn, frame = DECLINED[case]
    _declined(fn, _frame(frame))
