"""Groupby factorization and segment aggregation of the torch port against
the JAX package.

``factorize_keys`` must return the same codes, group count, group keys and
sizes as ``modin_tpu.ops.groupby.factorize_keys`` for every key kind the
slice takes: small-range ints (the bincount path), large-range ints, floats
with NaN under ``dropna`` True and False, bools, and two-level keys.
``groupby_reduce`` must return the same per-group values: integer results
and counts exactly, float sums and means to ``rtol=1e-12`` because the two
packages add in different orders; min/max exactly.
"""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from modin_tpu.ops import groupby as jax_gb

import modin_tpu_torch
from modin_tpu_torch.config import GroupbyRangeLimit
from modin_tpu_torch.ops import groupby as gb

N = 3_000


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


def _keys(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "int_small":
        return rng.integers(-20, 80, N)
    if kind == "int_sparse":
        # range wider than the direct-code limit: the unique path
        return rng.choice(np.array([-(10**12), 5, 7, 10**12, 3 * 10**12]), N)
    if kind == "int32":
        return rng.integers(0, 50, N).astype(np.int32)
    if kind == "float_nan":
        k = rng.integers(0, 30, N) / 4.0
        k[rng.random(N) < 0.05] = np.nan
        return k
    if kind == "float_clean":
        return rng.integers(0, 30, N) / 8.0
    if kind == "bool":
        return rng.random(N) < 0.3
    raise ValueError(kind)


def _values(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "int64":
        return rng.integers(-1000, 1000, N)
    if kind == "int32":
        return rng.integers(-1000, 1000, N).astype(np.int32)
    if kind == "float64_nan":
        x = rng.normal(0, 100, N)
        x[rng.random(N) < 0.02] = np.nan
        return x
    raise ValueError(kind)


def _factorize_both(key_arrays, dropna):
    want = jax_gb.factorize_keys([jnp.asarray(k) for k in key_arrays], N, dropna)
    got = gb.factorize_keys([torch.as_tensor(k) for k in key_arrays], N, dropna)
    return got, want


def _assert_factorization_equal(got, want):
    g_codes, g_n, g_keys, g_sizes = got
    w_codes, w_n, w_keys, w_sizes = want
    assert g_n == w_n
    np.testing.assert_array_equal(g_codes.numpy(), np.asarray(w_codes)[:N])
    assert len(g_keys) == len(w_keys)
    for gk, wk in zip(g_keys, w_keys):
        assert gk.dtype == np.asarray(wk).dtype
        np.testing.assert_array_equal(gk, np.asarray(wk))
    if w_sizes is None:
        assert g_sizes is None
    else:
        np.testing.assert_array_equal(g_sizes, np.asarray(w_sizes))


@pytest.mark.parametrize(
    "kind", ["int_small", "int_sparse", "int32", "float_nan", "float_clean", "bool"]
)
@pytest.mark.parametrize("dropna", [True, False])
def test_factorize_single_key(kind, dropna):
    got, want = _factorize_both([_keys(kind, 1)], dropna)
    _assert_factorization_equal(got, want)


@pytest.mark.parametrize(
    "kinds", [("int_small", "bool"), ("int32", "float_nan"), ("float_clean", "int_sparse")]
)
@pytest.mark.parametrize("dropna", [True, False])
def test_factorize_two_level_keys(kinds, dropna):
    got, want = _factorize_both([_keys(kinds[0], 2), _keys(kinds[1], 3)], dropna)
    _assert_factorization_equal(got, want)


def test_factorize_range_limit_switches_to_unique(monkeypatch):
    monkeypatch.setattr(GroupbyRangeLimit, "_value", 10)
    keys = _keys("int_small", 4)  # range 100 > 10: unique path
    codes, n_groups, uniques, sizes = gb.factorize_keys([torch.as_tensor(keys)], N)
    assert sizes is None
    np.testing.assert_array_equal(uniques[0], np.unique(keys))
    np.testing.assert_array_equal(codes.numpy(), np.searchsorted(np.unique(keys), keys))


def test_factorize_too_many_composite_groups(monkeypatch):
    monkeypatch.setattr(GroupbyRangeLimit, "_value", 4)
    keys = [_keys("int32", 5), _keys("int32", 6)]  # 50 x 50 > 4 * 4
    with pytest.raises(gb._TooManyGroups):
        gb.factorize_keys([torch.as_tensor(k) for k in keys], N)


@pytest.mark.parametrize("agg", ["size", "count", "sum", "mean", "min", "max"])
@pytest.mark.parametrize("key_kind", ["int_small", "float_nan", "bool"])
@pytest.mark.parametrize("dropna", [True, False])
@pytest.mark.parametrize("pass_sizes", [True, False])
def test_groupby_reduce(agg, key_kind, dropna, pass_sizes):
    keys = _keys(key_kind, 7)
    value_kinds = ["int64", "int32", "float64_nan"]
    values = [_values(v, 20 + i) for i, v in enumerate(value_kinds)]
    w_codes, w_n, _, w_sizes = jax_gb.factorize_keys([jnp.asarray(keys)], N, dropna)
    g_codes, g_n, _, g_sizes = gb.factorize_keys([torch.as_tensor(keys)], N, dropna)
    assert g_n == w_n
    want = jax_gb.groupby_reduce(
        agg, [jnp.asarray(v) for v in values], w_codes, w_n, N,
        sizes=w_sizes if pass_sizes else None,
    )
    got = gb.groupby_reduce(
        agg, [torch.as_tensor(v) for v in values], g_codes, g_n, N,
        sizes=g_sizes if pass_sizes else None,
    )
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)[:g_n]
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        if g.dtype.kind == "f" and agg in ("sum", "mean"):
            np.testing.assert_allclose(g, w, rtol=1e-12)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("agg", ["count", "sum", "mean", "min", "max"])
def test_groupby_reduce_two_level_keys(agg):
    keys = [_keys("int_small", 8), _keys("float_nan", 9)]
    values = [_values("int64", 30), _values("float64_nan", 31)]
    w_codes, w_n, _, w_sizes = jax_gb.factorize_keys([jnp.asarray(k) for k in keys], N)
    g_codes, g_n, _, g_sizes = gb.factorize_keys([torch.as_tensor(k) for k in keys], N)
    want = jax_gb.groupby_reduce(agg, [jnp.asarray(v) for v in values], w_codes, w_n, N, sizes=w_sizes)
    got = gb.groupby_reduce(agg, [torch.as_tensor(v) for v in values], g_codes, g_n, N, sizes=g_sizes)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:g_n], rtol=1e-12)


def test_float_group_sums_repeat_bitwise():
    keys = torch.as_tensor(_keys("float_nan", 10))
    vals = torch.as_tensor(_values("float64_nan", 11))
    codes, n_groups, _, sizes = gb.factorize_keys([keys], N)
    a = gb.groupby_reduce("mean", [vals], codes, n_groups, N, sizes=sizes)[0]
    b = gb.groupby_reduce("mean", [vals], codes, n_groups, N, sizes=sizes)[0]
    assert torch.equal(a.view(torch.int64), b.view(torch.int64))


def test_unported_aggregation_raises():
    with pytest.raises(ValueError):
        gb.groupby_reduce("median", [torch.zeros(3)], torch.zeros(3, dtype=torch.int64), 1, 3)
