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


# ---------------------------------------------------------------------- #
# Series // and % by an int Series holding a zero
# ---------------------------------------------------------------------- #

INT_WIDTHS = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64"]
DIVIDENDS = [5, -3, 0, 7, 4, 0, -9]
DIVISORS = [0, 0, 0, 2, 0, 3, -4]


def _int_pair(dtype: str):
    signed = np.dtype(dtype).kind == "i"
    a = np.array([v if signed else abs(v) for v in DIVIDENDS], dtype=dtype)
    z = np.array([v if signed else abs(v) for v in DIVISORS], dtype=dtype)
    return pandas.Series(a, name="a"), pandas.Series(z, name="z")


# the reflected forms divide by ``a`` (``z // a``), whose zero is the third row
OPERATORS = {
    "floordiv": lambda a, z: a // z,
    "mod": lambda a, z: a % z,
    "rfloordiv": lambda a, z: a.__rfloordiv__(z),
    "rmod": lambda a, z: a.__rmod__(z),
}


@pytest.mark.parametrize("other", ["port", "pandas"])
@pytest.mark.parametrize("op", sorted(OPERATORS))
@pytest.mark.parametrize("dtype", INT_WIDTHS)
def test_int_division_operator_by_a_zero_follows_pandas(dtype, op, other):
    """``s // z`` and ``s % z`` give pandas' operator result: float64 with
    +/-inf and NaN at each zero divisor, on the device (no default) for the
    widths the port keeps there (uint16-uint64 columns stay on the host,
    where pandas' operator answers)."""
    from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc

    a, z = _int_pair(dtype)
    want = OPERATORS[op](a, z)
    assert want.dtype == np.float64
    ma = mpd.Series(a)
    mz = mpd.Series(z) if other == "port" else z
    defaults = tqc.DEFAULTS_TO_PANDAS
    got = OPERATORS[op](ma, mz)
    on_device = ma._query_compiler._modin_frame._columns[0].is_device
    assert on_device == (dtype not in ("uint16", "uint32", "uint64"))
    assert tqc.DEFAULTS_TO_PANDAS - defaults == (0 if on_device else 1)
    _assert_same(got._to_pandas(), want)


@pytest.mark.parametrize("dtype", INT_WIDTHS)
def test_int_divmod_by_a_zero_follows_pandas(dtype):
    a, z = _int_pair(dtype)
    ma, mz = mpd.Series(a), mpd.Series(z)
    for got, want in zip(divmod(ma, mz), divmod(a, z)):
        _assert_same(got._to_pandas(), want)
    for got, want in zip(divmod(ma, z), divmod(a, z)):
        _assert_same(got._to_pandas(), want)


@pytest.mark.parametrize("dtype", INT_WIDTHS)
def test_int_division_operator_with_no_zero_keeps_the_int_dtype(dtype):
    a, _ = _int_pair(dtype)
    z = pandas.Series(np.array([1, 2, 3, 4, 5, 6, 7], dtype=dtype), name="z")
    ma, mz = mpd.Series(a), mpd.Series(z)
    for got, want in ((ma // mz, a // z), (ma % mz, a % z)):
        assert want.dtype == np.dtype(dtype)
        _assert_same(got._to_pandas(), want)


@pytest.mark.parametrize("dtype", INT_WIDTHS)
def test_int_flex_division_by_a_zero_keeps_pandas_flex_result(dtype):
    """pandas' flex methods leave numpy's 0 at a zero divisor and keep the
    int dtype, unlike its operators; the port keeps both."""
    a, z = _int_pair(dtype)
    ma, mz = mpd.Series(a), mpd.Series(z)
    for name in ("floordiv", "mod", "rfloordiv", "rmod"):
        want = getattr(a, name)(z)
        assert want.dtype.kind in "iu"
        _assert_same(getattr(ma, name)(mz)._to_pandas(), want)
    for got, want in zip(ma.divmod(mz), a.divmod(z)):
        _assert_same(got._to_pandas(), want)


def test_the_jax_package_gives_the_flex_result_for_the_operator():
    """A known difference (ROADMAP Queue 3, item 6): the JAX package answers
    ``s // z`` and ``s % z`` with pandas' flex result; the port follows
    pandas' operator."""
    import modin_tpu.pandas as jpd

    a, z = _int_pair("int64")
    ja, jz = jpd.Series(a), jpd.Series(z)
    _assert_same((ja // jz)._to_pandas(), a.floordiv(z))
    _assert_same((ja % jz)._to_pandas(), a.mod(z))
    _assert_same((mpd.Series(a) // mpd.Series(z))._to_pandas(), a // z)
