"""The fused program of the torch port: compiler, plain version, reference.

``modin_tpu_torch/ops/cuda/fused_program.py`` compiles a deferred chain
(``ops/lazy.py``) into the register program that ``csrc/fused.cu``
interprets; on the CPU, ``fused_kernels.run_program_plain`` walks the same
instructions with torch tensors as registers.  Held here:

- the compiler: registers allocated by liveness under the kernel's caps,
  explicit casts where numpy's promotion asks for them, a forest split into
  programs by root, a Cut where one root overflows, barriers for the ops the
  kernel does not take;
- the plain program against the eager ops (``elementwise.get_op``) bit for
  bit, over a seeded grid of op x dtype (bool, int8-64, uint8, float32,
  float64) x column/scalar, with NaN, +/-inf, +/-0.0, zero divisors and the
  int extremes (``INT64_MIN // -1``).  uint16/32/64 have no device column in
  the port (``utils._NP_TO_TORCH``), so the grid stops at uint8;
- the reduction tails against the eager reductions (exact for counts, ints,
  min/max and any/all; rtol 1e-12 for float sums, which the tail takes in
  the kernel's block order; rtol 1e-10 for skew/kurt, whose third and fourth
  powers of centred values cancel more);
- the fused result against the JAX package's ``modin_tpu.ops.lazy.run_fused``
  on the same numpy inputs, for each op both registries share.  Where the
  JAX package and pandas differ (a float floor division by zero: NaN in the
  JAX package, +/-inf in pandas; ROADMAP Queue 3, item 3), the port is held
  to pandas (numpy).
"""

import threading

import numpy as np
import pandas
import pytest
import torch

import jax.numpy as jnp

import modin_tpu.pandas  # noqa: F401  (the JAX package's x64 set-up)
from modin_tpu.ops import lazy as jax_lazy

import modin_tpu_torch
from modin_tpu_torch.ops import elementwise as ew
from modin_tpu_torch.ops import lazy, reductions
from modin_tpu_torch.ops.cuda import fused_kernels as fk
from modin_tpu_torch.ops.cuda import fused_program as fp

N = 2003

DTYPES = ["bool", "int8", "int16", "int32", "int64", "uint8", "float32", "float64"]
BINARY = ["add", "sub", "mul", "truediv", "floordiv", "mod", "pow", "eq", "ne", "lt", "le",
          "gt", "ge", "__and__", "__or__", "__xor__", "radd", "rsub", "rmul", "rtruediv",
          "rfloordiv", "rmod", "rpow", "__rand__", "__ror__", "__rxor__"]
SCALARS = [2, -3, 0, 2.5, 0.1, -0.5, 0.5, -1, 3, -2, 1, True, np.float32(1.5), np.int8(3), np.float64(-0.25)]


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


def _column(dtype: str, seed: int) -> np.ndarray:
    """NaN, +/-inf and both zeros (floats); the extremes, 0 and -1 or 1
    (ints); the rest seeded."""
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.random(N) < 0.5
    if dtype.startswith("float"):
        x = rng.normal(0, 10, N)
        x[rng.random(N) < 0.1] = np.nan
        x[:10] = [np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0, 0.5, 2.0, 1e300, -3.0]
        return x.astype(dtype)
    info = np.iinfo(dtype)
    x = rng.integers(max(info.min, -100), min(info.max, 100) + 1, N).astype(dtype)
    x[:5] = [info.min, info.max, 0, 1, info.max - 1]
    if info.min < 0:
        x[5:8] = [-1, info.min + 1, -2]
    return x


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    return a.view(f"u{a.itemsize}") if a.dtype.kind == "f" else a


def _assert_bitwise(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    diff = np.flatnonzero(_bits(got) != _bits(want))
    assert diff.size == 0, (what, diff[:5], got[diff[:5]], want[diff[:5]])


def _fused_vs_eager(op, args, static=()) -> bool:
    """The fused program of one node against the eager op, bit for bit;
    False where the eager op refuses the inputs (then so must the node)."""
    try:
        want = ew.get_op(op)(*args, **dict(static))
    except (RuntimeError, TypeError, OverflowError) as err:
        with pytest.raises(type(err)):
            lazy.lazy_op(op, *args, static=static)
        return False
    got = lazy.materialize(lazy.lazy_op(op, *args, static=static))
    _assert_bitwise(got, want, f"{op} {[getattr(a, 'dtype', a) for a in args]} {static}")
    return True


# ---------------------------------------------------------------------- #
# The plain program against the eager ops, bit for bit
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("dx", DTYPES)
@pytest.mark.parametrize("op", BINARY)
def test_binary_grid_bitwise(op, dx):
    x = torch.as_tensor(_column(dx, 1))
    for dy in DTYPES:
        _fused_vs_eager(op, (x, torch.as_tensor(_column(dy, 2))))
    for s in SCALARS:
        _fused_vs_eager(op, (x, s))


@pytest.mark.parametrize("dx", DTYPES)
@pytest.mark.parametrize("op", ["abs", "negative", "invert", "isna", "notna", *sorted(ew.MATH_UNARY)])
def test_unary_grid_bitwise(op, dx):
    _fused_vs_eager(op, (torch.as_tensor(_column(dx, 3)),))


@pytest.mark.parametrize("dx", DTYPES)
def test_maps_grid_bitwise(dx):
    x = torch.as_tensor(_column(dx, 4))
    for d in (-3, -1, 0, 1, 2, 5):
        _fused_vs_eager("round", (x,), (("decimals", d),))
    for target in DTYPES:
        if not (dx.startswith("float") and target[0] in "iub"):  # NaN into ints: pandas raises
            _fused_vs_eager("astype", (x,), (("dtype", target),))
    for v in (0, 1.5, -2, 1e300):
        if dx.startswith("float"):
            _fused_vs_eager("fillna", (x, ew.cast_scalar(v, x.dtype)))
        if dx != "bool" and (dx.startswith("float") or np.iinfo(dx).min <= v <= np.iinfo(dx).max) and float(v).is_integer() or dx.startswith("float"):
            for op in ("clip_lower", "clip_upper"):
                _fused_vs_eager(op, (x, ew.cast_scalar(v, x.dtype)))
    if dx == "int64":
        nat = x.clone()
        nat[::7] = np.iinfo(np.int64).min
        _fused_vs_eager("isna_nat", (nat,))
        _fused_vs_eager("notna_nat", (nat,))


def test_int64_min_floordiv_minus_one_wraps_as_numpy():
    x = torch.tensor([np.iinfo(np.int64).min, -7, 7, 0], dtype=torch.int64)
    got = lazy.materialize(ew.binary_op_columns("floordiv", [x], -1)[0])
    with np.errstate(over="ignore"):
        want_np = np.array([np.iinfo(np.int64).min, -7, 7, 0]) // -1  # numpy wraps
        want_pd = (pandas.Series([np.iinfo(np.int64).min, -7, 7, 0]) // -1).to_numpy()
    np.testing.assert_array_equal(got.numpy(), want_np)
    np.testing.assert_array_equal(got.numpy(), want_pd)
    _assert_bitwise(got, ew.get_op("floordiv")(x, -1), "INT64_MIN // -1")
    got_mod = lazy.materialize(ew.binary_op_columns("mod", [x], -1)[0])
    np.testing.assert_array_equal(got_mod.numpy(), np.zeros(4, np.int64))


def test_float_floor_division_and_modulo_follow_numpy():
    # 1.0 // 0.1 is 9.0 in numpy and pandas, while floor(1.0 / 0.1) is 10
    x = torch.tensor([1.0, -1.0, 7.5, -7.5, 0.3, np.inf, np.nan, -0.0], dtype=torch.float64)
    for s in (0.1, -0.1, 2.0, -3.0, 0.0):
        got = lazy.materialize(ew.binary_op_columns("floordiv", [x], s)[0]).numpy()
        with np.errstate(all="ignore"):
            np.testing.assert_array_equal(got, np.floor_divide(x.numpy(), s))
        got = lazy.materialize(ew.binary_op_columns("mod", [x], s)[0]).numpy()
        with np.errstate(all="ignore"):
            np.testing.assert_array_equal(got, np.remainder(x.numpy(), s))


def test_a_chain_is_the_eager_chain_bit_for_bit():
    rng = np.random.default_rng(5)
    a, b, c = (torch.as_tensor(rng.normal(size=N)) for _ in range(3))
    i8 = torch.as_tensor(rng.integers(-128, 128, N).astype(np.int8))
    e = ew.binary_op_columns("add", ew.binary_op_columns("mul", [a], [b]), [c])[0]
    _assert_bitwise(lazy.materialize(e), a * b + c, "a * b + c")
    w = ew.binary_op_columns("mul", ew.binary_op_columns("add", [i8], 100), 3)[0]
    _assert_bitwise(lazy.materialize(w), (i8 + 100) * 3, "int8 wrap")
    x = ew.binary_op_columns("add", [a], [b])[0]
    d = ew.binary_op_columns("sub", ew.binary_op_columns("mul", [x], [x]), [x])[0]
    _assert_bitwise(lazy.materialize(d), (a + b) * (a + b) - (a + b), "diamond")


# ---------------------------------------------------------------------- #
# The compiler
# ---------------------------------------------------------------------- #


def _compile(roots, tail=None):
    lin = lazy._linearize(roots)
    return lin, fp.compile_forest(lin.nodes, lin.node_codes, lin.out_refs, lin.leaf_codes,
                                  lin.scalar_tags, tail)


def test_promotion_becomes_explicit_casts():
    i32 = torch.arange(N, dtype=torch.int32)
    f32 = torch.ones(N, dtype=torch.float32)
    _, plan = _compile([ew.binary_op_columns("add", [i32], 2.5)[0]])
    ops = [(fp.OP_NAMES[i[0]], i[1]) for i in plan[0].instrs]
    assert ops[0] == ("CAST", fp.DTYPE_CODES[torch.int32])  # int32 -> float64 first
    assert plan[0].instrs[0][6] == fp.F64
    assert ops[1] == ("ADD", fp.F64)
    # float32 with a weak Python float stays float32: no cast, a float32 slot
    _, plan = _compile([ew.binary_op_columns("mul", [f32], 0.1)[0]])
    assert [fp.OP_NAMES[i[0]] for i in plan[0].instrs] == ["MUL", "STORE"]
    assert plan[0].slots == (("scalar", 0, fp.F32),)
    # a strong numpy float64 scalar promotes the float32 column
    _, plan = _compile([ew.binary_op_columns("mul", [f32], np.float64(0.1))[0]])
    assert fp.OP_NAMES[plan[0].instrs[0][0]] == "CAST"
    # int / int divides in float64
    _, plan = _compile([ew.binary_op_columns("truediv", [i32], [i32])[0]])
    assert [fp.OP_NAMES[i[0]] for i in plan[0].instrs] == ["CAST", "CAST", "TDIV", "STORE"]


def test_registers_are_reused_by_liveness_under_the_cap():
    cols = [torch.full((N,), float(k)) for k in range(24)]
    # a balanced sum of 24 columns: at most ~log2(24) values live at once
    level = cols
    while len(level) > 1:
        level = [ew.binary_op_columns("add", [level[i]], [level[i + 1]])[0] if i + 1 < len(level) else level[i]
                 for i in range(0, len(level), 2)]
    _, plan = _compile(level)
    assert len(plan) == 1 and plan[0].n_regs <= 6
    assert float(lazy.materialize(level[0])[0]) == sum(range(24))


def test_wide_forest_splits_into_programs_by_root():
    x = torch.arange(N, dtype=torch.float64)
    roots = ew.binary_op_columns("add", [x] * 40, [x] * 40)
    _, plan = _compile(roots)
    assert len(plan) == 2
    assert [len(p.roots) for p in plan] == [32, 8]  # MAX_OUTPUTS outputs a launch
    assert all(len(p.instrs) <= fp.MAX_INSTR and p.n_regs <= fp.MAX_REGS for p in plan)
    before = fk.PROGRAMS_RUN
    values = lazy.materialize_exprs(roots)
    assert fk.PROGRAMS_RUN - before == 2
    assert all(torch.equal(v, x + x) for v in values)


def test_a_root_over_a_cap_cuts_and_materializes_mid_chain():
    x = torch.arange(N, dtype=torch.float64)
    e = x
    for k in range(40):  # 40 scalars: past the 32 scalar slots of a program
        e = ew.binary_op_columns("add", [e], float(k))[0]
    lin, plan = _compile([e])
    assert isinstance(plan, fp.Cut) and plan.nodes
    before = fk.PROGRAMS_RUN
    got = lazy.materialize(e)
    assert fk.PROGRAMS_RUN - before == 2
    want = x
    for k in range(40):
        want = want + float(k)
    _assert_bitwise(got, want, "cut chain")


def test_barriers_materialize_their_inputs_and_count():
    x = torch.arange(N, dtype=torch.float64) - 100.0
    i8 = torch.arange(N, dtype=torch.int64).to(torch.int8)
    before = lazy.BARRIERS
    c = ew.unary_op_columns("cumsum", ew.binary_op_columns("mul", [x], 2.0))[0]
    assert isinstance(c, torch.Tensor) and lazy.BARRIERS == before + 1
    _assert_bitwise(c, ew.get_op("cumsum")(x * 2.0), "cumsum barrier")
    # numpy's sqrt of int8 is float16: the kernel takes no float16, so a barrier
    s = ew.math_unary_columns("sqrt", ew.unary_op_columns("abs", [i8]))[0]
    assert isinstance(s, torch.Tensor) and s.dtype == torch.float16 and lazy.BARRIERS == before + 2
    assert not fp.fusable("cumsum", [torch.float64], torch.float64)
    assert not fp.fusable("sqrt", [torch.int8], torch.float16)
    assert fp.fusable("sqrt", [torch.int32], torch.float64)


def test_a_program_fits_the_kernel_parameters():
    import ctypes

    assert ctypes.sizeof(fk.FusedParams) <= 4096
    assert len(fp.pack_instr((1, 2, 3, 4, 5, 6, 7, -8))) == 16


# ---------------------------------------------------------------------- #
# Reduction tails against the eager reductions
# ---------------------------------------------------------------------- #

REDUCE_KINDS = ["float64", "float32", "int64", "int8", "bool"]


@pytest.mark.parametrize("skipna", [True, False])
@pytest.mark.parametrize("op", sorted(reductions.REDUCTIONS))
def test_reduction_tails_against_eager(op, skipna):
    for k, kind in enumerate(REDUCE_KINDS):
        # well-conditioned values (no extremes: a float sum of INT64_MIN and
        # INT64_MAX cancels to whatever its order leaves), NaN in the floats
        rng = np.random.default_rng(6 + k)
        if kind == "bool":
            x = torch.as_tensor(rng.random(N) < 0.5)
        elif kind.startswith("float"):
            v = rng.normal(3, 10, N)
            v[rng.random(N) < 0.1] = np.nan
            x = torch.as_tensor(v.astype(kind))
        else:
            x = torch.as_tensor(rng.integers(-100, 101, N).astype(kind))
        cast_bool = op in ("sum", "prod", "mean", "var", "std", "sem", "skew", "kurt")
        e = ew.binary_op_columns("mul", [x], True if kind == "bool" else 1)[0]
        if op == "prod" and kind != "bool":
            e = ew.binary_op_columns("add", [ew.binary_op_columns("mul", [x], 0)[0]], 1)[0]
        (got,) = reductions.reduce_columns(op, [e], N, skipna=skipna, cast_bool=cast_bool)
        (want,) = reductions.reduce_columns(op, [lazy.materialize(e)], N, skipna=skipna, cast_bool=cast_bool)
        assert got.dtype == want.dtype, (op, kind, got.dtype, want.dtype)
        if want.dtype.kind == "f" and op not in ("min", "max"):
            rtol = 1e-10 if op in ("skew", "kurt") else (1e-6 if kind == "float32" else 1e-12)
            np.testing.assert_allclose(got, want, rtol=rtol, err_msg=f"{op} {kind}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{op} {kind}")


def test_a_tail_is_one_program_and_moments_two():
    rng = np.random.default_rng(7)
    a, b, c = (torch.as_tensor(rng.normal(size=N)) for _ in range(3))
    e = ew.binary_op_columns("add", ew.binary_op_columns("mul", [a], [b]), [c])[0]
    before = fk.PROGRAMS_RUN
    (s,) = reductions.reduce_columns("sum", [e], N)
    assert fk.PROGRAMS_RUN - before == 1 and lazy.is_lazy(e)
    before = fk.PROGRAMS_RUN
    (v,) = reductions.reduce_columns("var", [e], N)
    assert fk.PROGRAMS_RUN - before == 2
    ref = (a * b + c).numpy()
    np.testing.assert_allclose(s, ref.sum(), rtol=1e-12)
    np.testing.assert_allclose(v, ref.var(ddof=1), rtol=1e-12)


def test_plain_reduction_takes_the_kernel_order():
    # the plain tail is the kernel's order: threads over rows, trees over
    # each block and the merge; one block of 256 rows sums as that tree
    x = torch.as_tensor(np.random.default_rng(8).normal(size=256) * 1e10)
    e = ew.binary_op_columns("mul", [x], 1.0)[0]
    first, _ = lazy.run_fused([e], ("reduce", "sum", True, 1, False))
    v = x.clone()
    w = 128
    while w:
        v = v[:w] + v[w: 2 * w]
        w //= 2
    assert first[0, 0].reshape(1).view(torch.float64)[0].item() == v[0].item()


@pytest.mark.parametrize("op", sorted(fp.ROW_OPS))
@pytest.mark.parametrize("skipna", [True, False])
def test_row_tails_against_eager(op, skipna):
    cols = [torch.as_tensor(_column(k, 9 + i)) for i, k in enumerate(["float64", "float32", "int64", "int8"])]
    cols = [torch.where(torch.isinf(c), 2.0, c).to(c.dtype) if c.is_floating_point() else c for c in cols]
    exprs = [ew.binary_op_columns("mul", [c], 2)[0] for c in cols]
    before = fk.PROGRAMS_RUN
    got = reductions.reduce_axis1(op, exprs, skipna=skipna)
    assert fk.PROGRAMS_RUN - before == (0 if op == "count" and False else 1)
    want = reductions.reduce_axis1(op, lazy.materialize_exprs(exprs), skipna=skipna)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6 if want.dtype == torch.float32 else 1e-12)


# ---------------------------------------------------------------------- #
# Against the JAX package's run_fused
# ---------------------------------------------------------------------- #

SHARED = ["add", "sub", "mul", "truediv", "floordiv", "mod", "eq", "ne", "lt", "le", "gt", "ge",
          "radd", "rsub", "rmul", "rtruediv", "rfloordiv", "rmod"]


@pytest.mark.parametrize("kinds", [("float64", "float64"), ("int64", "float64"), ("float32", "float32"),
                                   ("int32", "int32"), ("int64", "int8"), ("float32", "float64")])
@pytest.mark.parametrize("op", SHARED)
def test_against_the_jax_package(op, kinds):
    x, y = _column(kinds[0], 11), _column(kinds[1], 12)
    if kinds[1][0] in "iu" and "div" in op or "mod" in op and kinds[1][0] in "iu":
        y = np.where(y == 0, 3, y).astype(y.dtype)
        x = np.where(x == 0, 5, x).astype(x.dtype)
    if kinds[0][0] in "iu" and kinds[1][0] in "iu":  # keep min // -1 out: the JAX side is XLA's
        x = np.where(x == np.iinfo(x.dtype).min, 0, x).astype(x.dtype)
    for other_np, other_t in ((y, torch.as_tensor(y)), (2.5, 2.5), (3, 3)):
        if isinstance(other_np, int) and op in ("rfloordiv", "rmod", "rtruediv") and kinds[0][0] in "iu":
            continue
        got = lazy.materialize(ew.binary_op_columns(op, [torch.as_tensor(x)], [other_t])[0]).numpy()
        j_other = jnp.asarray(other_np) if isinstance(other_np, np.ndarray) else other_np
        want = np.asarray(jax_lazy.run_fused([jax_lazy.lazy_op(op, jnp.asarray(x), j_other)])[0])
        assert got.dtype == want.dtype, (op, kinds, got.dtype, want.dtype)
        if "floordiv" in op and got.dtype.kind == "f":
            # the JAX package gives NaN for a float division by zero; pandas
            # (numpy) +/-inf, and so does the port
            num, den = (x, other_np) if op == "floordiv" else (other_np, x)
            with np.errstate(all="ignore"):
                pandas_like = np.floor_divide(num, den).astype(got.dtype)
            zero = np.broadcast_to(np.asarray(den) == 0, got.shape)
            want = np.where(zero, pandas_like, want)
        np.testing.assert_array_equal(got, want, err_msg=f"{op} {kinds} {type(other_np).__name__}")
