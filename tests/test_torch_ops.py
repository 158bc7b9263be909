"""Elementwise ops and column reductions of the torch port against the JAX
package.

The same numpy inputs (made from a seed) go through
``modin_tpu.ops.elementwise`` / ``modin_tpu.ops.reductions`` on the CPU mesh
and through their ports in ``modin_tpu_torch.ops``.  Integer and boolean
results must be equal with equal dtypes.  Elementwise float results must be
equal too (both sides compute one IEEE operation per element), with one
exception: a float floor division by zero is NaN in the JAX package and
+/-inf in pandas (``2 // 0.0 == inf``); the port follows pandas, and the
tests take numpy's (pandas') value at those positions.  Float reductions
agree to ``rtol=1e-12`` in float64 and ``1e-5`` in float32: the two
libraries sum in different orders, and float32 keeps ~7 digits over 1000
terms.
"""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from modin_tpu.ops import elementwise as jax_elementwise
from modin_tpu.ops import reductions as jax_reductions

import modin_tpu_torch
from modin_tpu_torch.ops import elementwise, reductions
from modin_tpu_torch.ops.lazy import materialize

N = 1_000


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


def _column(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "int64":
        return rng.integers(-50, 100, N)
    if kind == "int64_zeros":
        return rng.integers(-3, 4, N)  # many zero divisors
    if kind == "int32":
        return rng.integers(-50, 100, N).astype(np.int32)
    if kind == "float64":
        return rng.normal(0, 10, N)
    if kind == "float64_nan":
        x = rng.normal(0, 10, N)
        x[rng.random(N) < 0.1] = np.nan
        x[:3] = 0.0
        return x
    if kind == "float32":
        return rng.normal(0, 10, N).astype(np.float32)
    if kind == "bool":
        return rng.random(N) < 0.5
    raise ValueError(kind)


def _jax_binary(op, x, y):
    want = np.asarray(jax_elementwise.get_op(op)(x, y))
    if op in ("floordiv", "rfloordiv") and want.dtype.kind == "f":
        num, den = (x, y) if op == "floordiv" else (y, x)
        num, den = np.asarray(num), np.asarray(den)
        with np.errstate(divide="ignore", invalid="ignore"):
            pandas_like = np.floor_divide(num, den).astype(want.dtype)
        want = np.where(np.broadcast_to(den == 0, want.shape), pandas_like, want)
    return want


def _assert_same(got: torch.Tensor, want: np.ndarray):
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


ARITH = ["add", "radd", "sub", "rsub", "mul", "rmul", "truediv", "rtruediv",
         "floordiv", "rfloordiv", "mod", "rmod"]
CMP = ["eq", "ne", "lt", "le", "gt", "ge"]


@pytest.mark.parametrize("op", ARITH + CMP)
@pytest.mark.parametrize("kind", ["int64", "int32", "float64_nan", "float32"])
@pytest.mark.parametrize("scalar", [2, -3, 2.5])
def test_binary_scalar(op, kind, scalar):
    x = _column(kind, 1)
    got = materialize(elementwise.binary_op_columns(op, [torch.as_tensor(x)], scalar)[0])
    _assert_same(got, _jax_binary(op, jnp.asarray(x), scalar))


@pytest.mark.parametrize("op", ARITH + CMP)
@pytest.mark.parametrize(
    "kinds",
    [("int64", "int64_zeros"), ("int64", "float64_nan"), ("float64", "float64_nan"),
     ("int32", "int64"), ("float32", "float64")],
)
def test_binary_columns(op, kinds):
    x, y = _column(kinds[0], 2), _column(kinds[1], 3)
    got = materialize(elementwise.binary_op_columns(
        op, [torch.as_tensor(x)], [torch.as_tensor(y)]
    )[0])
    _assert_same(got, _jax_binary(op, jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("op", ["floordiv", "mod"])
def test_int_division_by_zero_scalar_masks_like_jax(op):
    x = _column("int64", 4)
    got = materialize(elementwise.binary_op_columns(op, [torch.as_tensor(x)], 0)[0])
    _assert_same(got, _jax_binary(op, jnp.asarray(x), 0))


@pytest.mark.parametrize("op", ["abs", "negative"])
@pytest.mark.parametrize("kind", ["int64", "int32", "float64_nan", "float32"])
def test_unary(op, kind):
    x = _column(kind, 5)
    got = materialize(elementwise.unary_op_columns(op, [torch.as_tensor(x)])[0])
    want = np.asarray(jax_elementwise.get_op(op)(jnp.asarray(x)))
    _assert_same(got, want)


@pytest.mark.parametrize("op", ["sum", "mean", "count", "min", "max"])
@pytest.mark.parametrize("skipna", [True, False])
def test_reduce_columns(op, skipna):
    kinds = ["int64", "int32", "float64", "float64_nan", "float32", "bool"]
    cols = [_column(k, 10 + i) for i, k in enumerate(kinds)]
    cast_bool = op in ("sum", "mean")
    want = jax_reductions.reduce_columns(
        op, [jnp.asarray(c) for c in cols], N, skipna=skipna, cast_bool=cast_bool
    )
    got = reductions.reduce_columns(
        op, [torch.as_tensor(c) for c in cols], N, skipna=skipna, cast_bool=cast_bool
    )
    for kind, g, w in zip(kinds, got, want):
        g_item, w_item = g.item(), np.asarray(w).item()
        assert type(g_item) is type(w_item), (kind, g_item, w_item)
        if isinstance(w_item, float):
            rtol = 1e-5 if kind == "float32" else 1e-12
            np.testing.assert_allclose(g_item, w_item, rtol=rtol, err_msg=kind)
        else:
            assert g_item == w_item, (kind, g_item, w_item)


@pytest.mark.parametrize("op", ["sum", "mean", "count", "min", "max"])
def test_reduce_all_nan_column(op):
    x = np.full(N, np.nan)
    want = np.asarray(
        jax_reductions.reduce_columns(op, [jnp.asarray(x)], N, skipna=True)[0]
    ).item()
    got = reductions.reduce_columns(op, [torch.as_tensor(x)], N, skipna=True)[0].item()
    np.testing.assert_equal(got, want)


def test_unported_reduction_raises():
    with pytest.raises(ValueError):
        reductions.reduce_columns("median", [torch.zeros(3)], 3)
