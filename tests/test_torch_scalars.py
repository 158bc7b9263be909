"""Scalar operands of the torch port's elementwise ops, held to pandas.

pandas takes a numpy scalar operand of an arithmetic op as it takes the
Python scalar (weak in numpy's promotion: ``float32 + np.float64(0.1)`` stays
float32, ``int8 * np.int64(3)`` stays int8), and refuses an int that the
column's dtype cannot hold (``int8 + 300`` raises ``OverflowError``, where a
silent wrap would give wrong values).  A comparison keeps a numpy scalar
strong and compares an out-of-range int exactly (``int8 == 300`` is False
everywhere).  Each case runs through ``modin_tpu_torch.pandas`` on a Series
and on a DataFrame (the deferred chain read back by ``to_pandas``, and the
same chain folded into a ``sum`` tail), and through the registry's eager body
(``elementwise.get_op``) with the operand the builder passes; each gives
pandas' dtype and values, or raises pandas' exception when the op is called.
The JAX package keeps numpy scalars strong and wraps out-of-range ints
(ROADMAP Queue 3, item 3): the port follows pandas.
"""

import threading

import numpy as np
import pandas
import pytest
import torch

import modin_tpu_torch
import modin_tpu_torch.pandas as mpd
from modin_tpu_torch.ops import elementwise as ew
from modin_tpu_torch.ops import lazy

COLUMNS = {
    "float32": np.array([0.1, 2.5, np.nan, -1.0, 44.0], dtype=np.float32),
    "int8": np.array([44, 2, -128, 127, -1], dtype=np.int8),  # 44 is 300 wrapped to int8
    "int16": np.array([1000, -1000, 7, 32767, 0], dtype=np.int16),
    "uint8": np.array([255, 1, 0, 44, 200], dtype=np.uint8),
    "bool": np.array([True, False, True, True, False]),
}

# (id, column dtype, op, scalar)
CASES = [
    ("f32_add_np_f64", "float32", "add", np.float64(0.1)),
    ("f32_truediv_np_f64", "float32", "truediv", np.float64(0.1)),
    ("f32_mul_np_f32", "float32", "mul", np.float32(1.5)),
    ("f32_eq_np_f64", "float32", "eq", np.float64(0.1)),  # strong: compared in float64
    ("i8_mul_np_i64", "int8", "mul", np.int64(3)),
    ("i8_add_np_i64", "int8", "add", np.int64(3)),
    ("i8_add_np_f32", "int8", "add", np.float32(1.5)),
    ("i8_add_300", "int8", "add", 300),
    ("i8_mul_300", "int8", "mul", 300),
    ("i8_add_minus129", "int8", "add", -129),
    ("i8_add_np_i64_300", "int8", "add", np.int64(300)),
    ("i8_mul_np_i64_300", "int8", "mul", np.int64(300)),
    ("i8_sub_np_i16_1000", "int8", "sub", np.int16(1000)),
    ("i8_floordiv_300", "int8", "floordiv", 300),
    ("i8_mod_300", "int8", "mod", 300),
    ("i8_rsub_300", "int8", "rsub", 300),
    ("i8_truediv_300", "int8", "truediv", 300),
    ("i8_eq_300", "int8", "eq", 300),
    ("i8_lt_300", "int8", "lt", 300),
    ("i8_gt_minus129", "int8", "gt", -129),
    ("i8_ne_np_i64_300", "int8", "ne", np.int64(300)),
    ("i16_mul_np_i64_minus300", "int16", "mul", np.int64(-300)),
    ("u8_add_minus1", "uint8", "add", -1),
    ("u8_sub_1", "uint8", "sub", 1),
    ("u8_eq_minus1", "uint8", "eq", -1),
    ("u8_ge_minus1", "uint8", "ge", -1),
    ("bool_add_np_i8", "bool", "add", np.int8(3)),
]
IDS = [c[0] for c in CASES]


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


def _objects(kind: str, dtype: str):
    col = COLUMNS[dtype]
    p = pandas.Series(col, name="a") if kind == "series" else pandas.DataFrame({"a": col, "b": col[::-1].copy()})
    return p, (mpd.Series(p) if kind == "series" else mpd.DataFrame(p))


def _pandas_or_error(fn):
    try:
        return fn(), None
    except (OverflowError, TypeError, ValueError) as err:
        return None, err


def _assert_same(got, want):
    if isinstance(want, pandas.DataFrame):
        pandas.testing.assert_frame_equal(got, want)
    else:
        pandas.testing.assert_series_equal(got, want)


@pytest.mark.parametrize("kind", ["series", "frame"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_scalar_operand_follows_pandas(case, kind):
    _, dtype, op, scalar = case
    p, m = _objects(kind, dtype)
    want, err = _pandas_or_error(lambda: getattr(p, op)(scalar))
    if err is not None:
        with pytest.raises(type(err)):
            getattr(m, op)(scalar)  # raised where the op is called, before anything defers
        return
    got = getattr(m, op)(scalar)
    _assert_same(got._to_pandas(), want)


@pytest.mark.parametrize("kind", ["series", "frame"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_scalar_operand_in_a_reduction_tail_follows_pandas(case, kind):
    _, dtype, op, scalar = case
    p, m = _objects(kind, dtype)
    want, err = _pandas_or_error(lambda: getattr(p, op)(scalar).sum())
    if err is not None:
        with pytest.raises(type(err)):
            getattr(m, op)(scalar).sum()
        return
    got = getattr(m, op)(scalar).sum()
    got = got._to_pandas() if kind == "frame" else got
    assert np.asarray(got).dtype == np.asarray(want).dtype, (got, want)
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64), rtol=1e-6)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_scalar_operand_of_the_eager_body_follows_pandas(case):
    """The registry's eager body (what a barrier runs and the plain program
    calls) with the operand that ``binary_op_columns`` passes on."""
    _, dtype, op, scalar = case
    col = COLUMNS[dtype]
    want, err = _pandas_or_error(lambda: getattr(pandas.Series(col), op)(scalar))
    operand = scalar.item() if isinstance(scalar, np.generic) and op in ew.ARITH_OPS else scalar
    body = ew.get_op(op)
    if err is not None:
        with pytest.raises(type(err)):
            body(torch.as_tensor(col), operand)
        with pytest.raises(type(err)):
            ew.binary_op_columns(op, [torch.as_tensor(col)], scalar)
        return
    got = body(torch.as_tensor(col), operand)
    fused = lazy.materialize(ew.binary_op_columns(op, [torch.as_tensor(col)], scalar)[0])
    for t in (got, fused):
        np.testing.assert_array_equal(t.numpy(), want.to_numpy())
        assert t.numpy().dtype == want.dtype, (t.dtype, want.dtype)


def test_a_comparison_with_an_out_of_range_int_compiles_apart():
    """The program cache keys an int scalar by the ranges that hold it: ``s ==
    2`` and ``s == 300`` over int8 are two programs (the second compares in
    int64), so a cached program never wraps 300 to 44."""
    s = torch.as_tensor(COLUMNS["int8"])
    small = lazy.materialize(ew.binary_op_columns("eq", [s], 44)[0])
    big = lazy.materialize(ew.binary_op_columns("eq", [s], 300)[0])
    assert small.tolist() == [True, False, False, False, False]
    assert big.tolist() == [False] * 5
