"""The port's sort-shaped and row-wise reductions held against the JAX
package's functions on the same inputs (``modin_tpu_torch/ops/sort.py``,
``ops/reductions.py``, ``ops/sorted_cache.py`` against ``modin_tpu/ops/``).

Inputs come from a numpy seed.  Tolerance: ints exactly.  Floats bit for bit
where both packages apply the same formula to the same values — the sorted
representation, and the quantile/median interpolation over it (the JAX
formula, ported as it is), up to the sign of a zero: -0.0 and 0.0 tie,
and each sort places them among their ties its own way.  Where the
summation order differs (var/std/sem
and the row-wise sums and means, whose reductions XLA and torch order their
own way) floats agree to ``rtol=1e-12``, and so does the row-wise median,
which the port takes as numpy does (the mean of the two middle values) and
XLA as a quantile.  The JAX kernel router is pinned to ``Auto`` as
``tests/test_graftsort.py`` does; the port has no router.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pandas
import pytest
import torch

import modin_tpu.pandas as mpd
from modin_tpu.config import KernelRouterHistBound as JaxHistBound
from modin_tpu.config import KernelRouterMode
from modin_tpu.ops import reductions as jred
from modin_tpu.ops import sort as jsort

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch.config import KernelRouterHistBound
from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
from modin_tpu_torch.ops import reductions as tred
from modin_tpu_torch.ops import sort as tsort
from modin_tpu_torch.ops import sorted_cache

FLOAT_RTOL = 1e-12


@pytest.fixture(autouse=True)
def _cpu_and_router():
    modin_tpu_torch.set_device("cpu")
    before = KernelRouterMode.get()
    KernelRouterMode.put("Auto")
    yield
    KernelRouterMode.put(before)


@pytest.fixture(autouse=True, scope="module")
def _join_jax_watchdog_threads():
    """Let the JAX package's per-fetch watchdog threads end before the next
    test file runs in this worker (``tests/test_watch.py`` counts threads)."""
    yield
    for t in threading.enumerate():
        if t.name.startswith("modin-tpu-watchdog"):
            t.join(timeout=5)


@pytest.fixture
def sort_path():
    """Both packages' histogram bound at 1: every int column sorts."""
    jax_before, torch_before = JaxHistBound.get(), KernelRouterHistBound.get()
    JaxHistBound.put(1)
    KernelRouterHistBound.put(1)
    yield
    JaxHistBound.put(jax_before)
    KernelRouterHistBound.put(torch_before)


def _columns(seed: int, n: int = 997) -> dict:
    """int64 in a small range, int64 over a wide range, float64 with NaN
    (and -0.0), int32, bool."""
    rng = np.random.default_rng(seed)
    f = rng.integers(-8, 8, n) / 2.0
    f[rng.random(n) < 0.15] = np.nan
    f[rng.random(n) < 0.05] = -0.0
    return {
        "small": rng.integers(0, 100, n),
        "wide": rng.integers(-(1 << 40), 1 << 40, n),
        "flt": f,
        "i32": rng.integers(-3, 4, n).astype(np.int32),
        "flag": rng.random(n) < 0.4,
    }


def _frames(data: dict):
    """(JAX frame columns, port frame columns) by label, and the length."""
    mdf = mpd.DataFrame(pandas.DataFrame(data))
    tdf = tpd.DataFrame(pandas.DataFrame(data))
    mframe = mdf._query_compiler._modin_frame
    tframe = tdf._query_compiler._modin_frame
    labels = list(data)
    jcols = {lab: mframe.get_column(i) for i, lab in enumerate(labels)}
    tcols = {lab: tframe.get_column(i) for i, lab in enumerate(labels)}
    return jcols, tcols, len(tdf)


def _bitwise(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} != {b.dtype}"
    assert a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}"
    if a.dtype.kind == "f":
        # -0.0 and 0.0 compare equal, so where each lands among its ties is
        # each sort's own choice: the sign of zero is not compared
        a, b = np.where(a == 0, 0.0, a), np.where(b == 0, 0.0, b)
        bits = np.uint64 if a.itemsize == 8 else np.uint32
        assert np.array_equal(a.view(bits), b.view(bits)), what
    else:
        assert np.array_equal(a, b), what


def _close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}"
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64),
                                   rtol=FLOAT_RTOL, atol=0, err_msg=what)
    else:
        assert np.array_equal(a, b), what


# --------------------------------------------------------------------- #
# the sorted representation and the interpolations over it
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("label", ["small", "wide", "flt", "i32", "flag"])
def test_sorted_valid(label):
    values = _columns(1)[label]
    n = len(values)
    jx, jn = jsort.sorted_valid(jnp.asarray(values), n)
    tx, tn = tsort.sorted_valid(torch.as_tensor(values), n)
    _bitwise(tx.numpy(), np.asarray(jx), f"sorted values of {label}")
    assert int(tn) == int(jn)


@pytest.mark.parametrize("interpolation", ["linear", "lower", "higher", "midpoint", "nearest"])
@pytest.mark.parametrize("label", ["small", "wide", "flt", "i32"])
def test_quantile_columns(label, interpolation):
    jcols, tcols, n = _frames(_columns(2))
    qs = [0.0, 0.1, 0.25, 0.5, 0.625, 0.9, 1.0]
    want = jred.quantile_columns([jcols[label]], n, qs, interpolation)[0]
    got = tred.quantile_columns([tcols[label]], n, qs, interpolation)[0]
    _bitwise(got, want, f"{interpolation} quantiles of {label}")


@pytest.mark.parametrize("skipna", [True, False])
def test_median_columns(skipna):
    jcols, tcols, n = _frames(_columns(3))
    labels = ["small", "wide", "flt", "i32", "flag"]
    want = jred.median_columns([jcols[lab] for lab in labels], n, skipna=skipna)
    got = tred.median_columns([tcols[lab] for lab in labels], n, skipna=skipna)
    for lab, g, w in zip(labels, got, want):
        _bitwise(g, w, f"median of {lab}")


def test_median_of_all_nan_column_is_nan():
    n = 10
    col = tpd.DataFrame({"x": np.full(n, np.nan)})._query_compiler._modin_frame.get_column(0)
    assert np.isnan(tred.median_columns([col], n)[0])


# --------------------------------------------------------------------- #
# nunique / mode: the histogram path and the sort path
# --------------------------------------------------------------------- #


def _plans(jcols, tcols, labels, op, n):
    jplans = jred.plan_sort_reduce(op, [{"col": jcols[lab]} for lab in labels], n)
    tplans = tred.plan_sort_reduce(op, [{"col": tcols[lab]} for lab in labels], n)
    assert [p.strategy for p in tplans] == [p.strategy for p in jplans]
    return jplans, tplans


@pytest.mark.parametrize("path", ["hist", "sort"])
@pytest.mark.parametrize("dropna", [True, False])
def test_nunique_planned(path, dropna, request):
    if path == "sort":
        request.getfixturevalue("sort_path")
    jcols, tcols, n = _frames(_columns(4))
    labels = ["small", "wide", "flt", "i32", "flag"]
    jplans, tplans = _plans(jcols, tcols, labels, "nunique", n)
    if path == "hist":
        assert tplans[0].strategy == "hist" and tplans[1].strategy == "sort"
    else:
        assert all(p.strategy == "sort" for p in tplans)
    assert tred.nunique_planned(tplans, n, dropna) == jred.nunique_planned(jplans, n, dropna)


@pytest.mark.parametrize("path", ["hist", "sort"])
@pytest.mark.parametrize("dropna", [True, False])
def test_mode_planned(path, dropna, request):
    if path == "sort":
        request.getfixturevalue("sort_path")
    jcols, tcols, n = _frames(_columns(5))
    labels = ["small", "i32", "flag"] if not dropna else ["small", "wide", "flt", "i32", "flag"]
    jplans, tplans = _plans(jcols, tcols, labels, "mode", n)
    want = jred.mode_planned(jplans, n, dropna)
    got = tred.mode_planned(tplans, n, dropna)
    for lab, g, w in zip(labels, got, want):
        assert (g is None) == (w is None), lab
        if w is not None:
            _bitwise(np.asarray(g[0]), np.asarray(w[0]).astype(np.asarray(g[0]).dtype), f"modes of {lab}")
            assert g[1] == w[1]


@pytest.mark.parametrize("want_mode", [False, True])
def test_hist_path_against_jit_hist(want_mode):
    jcols, tcols, n = _frames(_columns(6))
    labels = ["small", "i32", "flag"]
    _, tplans = _plans(jcols, tcols, labels, "nunique", n)
    span_pad = jred._next_pow2(max(p.span for p in tplans) + 2)
    fn = jred._jit_hist(len(labels), span_pad, n, want_mode, True)
    want = fn(
        tuple(jcols[lab].data for lab in labels),
        tuple(jnp.asarray(int(p.base)) for p in tplans),
    )
    for lab, p, w in zip(labels, tplans, want):
        counts, _ = tred._hist_counts(p)
        if not want_mode:
            assert int((counts > 0).sum()) == int(w), lab
        else:
            mask = (counts == counts.max()) & (counts > 0)
            np.testing.assert_array_equal(mask.numpy(), np.asarray(w[0])[: p.span])
            assert int(counts.max()) == int(w[1])


# --------------------------------------------------------------------- #
# row-wise: reduce_axis1, nunique_axis1, mode_axis1
# --------------------------------------------------------------------- #


def _row_frames(kind: str, n: int = 401):
    rng = np.random.default_rng(7)
    if kind == "int":
        cols = [rng.integers(0, 5, n) for _ in range(6)]
    elif kind == "int_uniform":
        # every row a permutation of one set: as many modes as columns
        cols = list(np.argsort(rng.random((n, 5)), axis=1).T.astype(np.int64))
    elif kind == "float_nan":
        cols = []
        for _ in range(5):
            c = rng.integers(0, 4, n) / 2.0
            c[rng.random(n) < 0.25] = np.nan
            cols.append(c)
        cols[0][:3] = np.nan
        cols[1][:3] = np.nan
        cols[2][:3] = np.nan
        cols[3][:3] = np.nan
        cols[4][:3] = np.nan  # all-NaN rows
    elif kind == "bool":
        cols = [rng.random(n) < 0.5 for _ in range(4)]
    else:
        raise ValueError(kind)
    return cols


ROW_KINDS = ["int", "int_uniform", "float_nan", "bool"]


@pytest.mark.parametrize("kind", ROW_KINDS)
@pytest.mark.parametrize("dropna", [True, False])
def test_nunique_axis1(kind, dropna):
    cols = _row_frames(kind)
    n = len(cols[0])
    want = np.asarray(jred.nunique_axis1([jnp.asarray(c) for c in cols], n, dropna))[:n]
    got = tred.nunique_axis1([torch.as_tensor(c) for c in cols], n, dropna).numpy()
    _bitwise(got, want.astype(np.int64), f"row nunique of {kind}")


@pytest.mark.parametrize("kind", ROW_KINDS)
def test_mode_axis1(kind, monkeypatch):
    # small chunks: the chunked loop is what runs at 1e8 rows
    monkeypatch.setattr(tred, "AXIS1_CHUNK_ROWS", 64)
    cols = _row_frames(kind)
    n = len(cols[0])
    vals, vals_f, m_max, uniform = jred.mode_axis1([jnp.asarray(c) for c in cols], n)
    got_cols, got_m, got_uniform = tred.mode_axis1([torch.as_tensor(c) for c in cols], n)
    assert (got_m, got_uniform) == (m_max, uniform)
    assert uniform == (kind == "int_uniform")
    want = np.asarray(vals if uniform else vals_f)[:n, :m_max]
    got = np.stack([c.numpy() for c in got_cols], axis=1)
    _bitwise(got, want, f"row modes of {kind}")


AXIS1_OPS = sorted(tred.AXIS1_REDUCTIONS)


@pytest.mark.parametrize("skipna", [True, False])
@pytest.mark.parametrize("op", AXIS1_OPS)
@pytest.mark.parametrize("kind", ["int", "float_nan", "bool"])
def test_reduce_axis1(op, kind, skipna):
    cols = _row_frames(kind)
    n = len(cols[0])
    cast_bool = op in ("sum", "mean", "median", "var", "std")
    want = np.asarray(jred.reduce_axis1(op, [jnp.asarray(c) for c in cols], skipna=skipna,
                                        ddof=1, cast_bool=cast_bool))[:n]
    got = tred.reduce_axis1(op, [torch.as_tensor(c) for c in cols], skipna=skipna,
                            ddof=1, cast_bool=cast_bool).numpy()
    assert got.dtype == want.dtype or op == "median", (got.dtype, want.dtype)
    _close(got, want, f"{op} across {kind} columns")


# --------------------------------------------------------------------- #
# column reductions added in this slice
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("skipna", [True, False])
@pytest.mark.parametrize("ddof", [0, 1])
@pytest.mark.parametrize("op", ["var", "std", "sem", "prod", "any", "all"])
def test_reduce_columns(op, ddof, skipna):
    data = _columns(8, n=64)
    data["small"] = data["small"] % 3 + 1  # a product that fits in int64
    labels = ["small", "flt", "i32", "flag"]
    cast_bool = op in ("var", "std", "sem", "prod")
    want = jred.reduce_columns(op, [jnp.asarray(data[k]) for k in labels], 64,
                               skipna=skipna, ddof=ddof, cast_bool=cast_bool)
    got = tred.reduce_columns(op, [torch.as_tensor(data[k]) for k in labels], 64,
                              skipna=skipna, ddof=ddof, cast_bool=cast_bool)
    for lab, g, w in zip(labels, got, want):
        _close(g, w, f"{op} of {lab}")
        if op in ("prod", "any", "all"):
            assert g.dtype == w.dtype, (lab, g.dtype, w.dtype)


# --------------------------------------------------------------------- #
# the sorted-representation cache never answers for a replaced tensor
# --------------------------------------------------------------------- #


def test_one_sort_serves_the_family():
    data = _columns(9)
    pdf = pandas.DataFrame({k: data[k] for k in ("wide", "flt")})
    tdf = tpd.DataFrame(pdf)
    cols = tdf._query_compiler._modin_frame._columns
    tdf.median()
    reps = [sorted_cache.get(c)[0] for c in cols]
    tdf.quantile([0.2, 0.8])
    tdf.describe()
    assert [sorted_cache.get(c)[0] for c in cols] == reps  # the same tensors
    pandas.testing.assert_frame_equal(tpd.to_pandas(tdf.mode()), pdf.mode())


def test_cache_dropped_on_setitem():
    data = _columns(10)
    pdf = pandas.DataFrame({"a": data["wide"], "b": data["flt"]})
    tdf = tpd.DataFrame(pdf)
    tdf.median()
    old = tdf._query_compiler._modin_frame.get_column(0)
    assert sorted_cache.peek(old)
    defaults = tqc.DEFAULTS_TO_PANDAS
    for df in (pdf, tdf):
        df["a"] = df["a"] // 3
    assert not sorted_cache.peek(old)
    pandas.testing.assert_series_equal(tpd.to_pandas(tdf.median()), pdf.median())
    pandas.testing.assert_series_equal(tpd.to_pandas(tdf.nunique()), pdf.nunique())
    assert tqc.DEFAULTS_TO_PANDAS == defaults


def test_cache_stays_right_after_insert():
    data = _columns(11)
    pdf = pandas.DataFrame({"a": data["wide"], "b": data["flt"]})
    tdf = tpd.DataFrame(pdf)
    tdf.quantile(0.3)
    for df in (pdf, tdf):
        df.insert(0, "z", data["i32"])
    pandas.testing.assert_frame_equal(
        tpd.to_pandas(tdf.quantile([0.3, 0.6])), pdf.quantile([0.3, 0.6])
    )


def test_cache_dropped_when_the_tensor_is_replaced():
    col = tpd.DataFrame({"a": np.arange(10)[::-1].copy()})._query_compiler._modin_frame.get_column(0)
    assert tred.median_columns([col], 10)[0] == 4.5
    assert sorted_cache.peek(col)
    col.data = torch.arange(100, 110)
    assert not sorted_cache.peek(col)
    assert tred.median_columns([col], 10)[0] == 104.5
