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

import itertools
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
    # a numpy float64 scalar operand is weak, as pandas takes it: no cast
    _, plan = _compile([ew.binary_op_columns("mul", [f32], np.float64(0.1))[0]])
    assert [fp.OP_NAMES[i[0]] for i in plan[0].instrs] == ["MUL", "STORE"]
    # one strong numpy float64 per column (a broadcast Series' values)
    # promotes the float32 column
    _, plan = _compile([ew.binary_op_columns("mul", [f32], [np.float64(0.1)])[0]])
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
    assert len(fp.pack_kinstr(1, 2, 3, 4, 5, 6, 7)) == 8
    assert fk.FusedParams.code.size == 8 * fp.MAX_CODE == 8 * (fp.MAX_INSTR + fp.MAX_LEAVES)


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


@pytest.mark.parametrize("rows_per_thread", [None, 1, 2, 4])
def test_plain_reduction_takes_the_kernel_order(rows_per_thread):
    # the plain tail is the kernel's order: thread t of a block folds its
    # rows t, t + 256, ... of a tile (rows_per_thread of them) in order, then
    # a tree over the block's threads; one block of 1024 rows sums so
    x = torch.as_tensor(np.random.default_rng(8).normal(size=1024) * 1e10)
    e = ew.binary_op_columns("mul", [x], 1.0)[0]
    lin, plan = lazy._plan([e], ("reduce", "sum", True, 1, False))
    low = fp.relower(plan[0], rows_per_thread=rows_per_thread)
    assert low.threads == fp.THREADS and low.rows_per_thread == (rows_per_thread or 4)
    per = low.rows_per_thread
    _, acc = fk.run_program(plan[0], lazy._leaf_args(lin, plan[0]), lin.scalars, 1024,
                            _shape={"rows_per_thread": rows_per_thread})
    blocks = 1024 // (256 * per)
    assert fp.grid(1024, low) == blocks
    parts = []
    for b in range(blocks):
        v = torch.zeros(256, dtype=torch.float64)
        for k in range(per):
            v = v + x[b * 256 * per + k * 256: b * 256 * per + (k + 1) * 256]
        w = 128
        while w:
            v = v[:w] + v[w: 2 * w]
            w //= 2
        parts.append(v[0])
    m = torch.zeros(256, dtype=torch.float64)
    m[:blocks] = torch.stack(parts)
    w = 128
    while w:
        m = m[:w] + m[w: 2 * w]
        w //= 2
    assert acc[0, 0].reshape(1).view(torch.float64)[0].item() == m[0].item()
    if per > 1:  # the order is the kernel's own: K = 1 folds another way
        one = fk.run_program(plan[0], lazy._leaf_args(lin, plan[0]), lin.scalars, 1024,
                             _shape={"rows_per_thread": 1})[1]
        assert not torch.equal(one, acc) or per == 1


@pytest.mark.parametrize("threads", [64, 32])
@pytest.mark.parametrize("op", ["sum", "var"])
def test_small_block_tails_of_32_outputs(threads, op):
    # 32 outputs give each block 3 * 32 partials, more than its 64 or 32
    # threads: the tail in the order of those blocks, against numpy
    rng = np.random.default_rng(40)
    n = 5000
    cols = [torch.as_tensor(rng.normal(size=n)) for _ in range(32)]
    roots = [ew.binary_op_columns("add", ew.binary_op_columns("mul", [cols[j]], 0.5), [cols[(j + 1) % 32]])[0]
             for j in range(32)]
    lin, plan = lazy._plan(roots, ("reduce", op, True, 1, False))
    assert len(plan) == 1 and len(plan[0].out_dtypes) == 32
    shape = {"threads": threads}
    low = fp.relower(plan[0], **shape)
    assert low.threads == threads and low.rows_per_thread == 1 and 3 * 32 > threads
    assert fp.grid(n, low) == -(-n // threads)
    leaves = lazy._leaf_args(lin, plan[0])
    _, acc = fk.run_program(plan[0], leaves, lin.scalars, n, _shape=shape)
    ref = np.stack([c.numpy() * 0.5 + cols[(j + 1) % 32].numpy() for j, c in enumerate(cols)])
    np.testing.assert_allclose(acc[:, 0].contiguous().view(torch.float64).numpy(), ref.sum(axis=1),
                               rtol=0, atol=1e-9)
    assert (acc[:, 1] == n).all() and (acc[:, 2] == 0).all()
    if op == "var":
        _, m2 = fk.run_program(plan[0], leaves, lin.scalars, n, second_pass=True, first=acc, _shape=shape)
        dev = ref - ref.mean(axis=1, keepdims=True)
        for j, p in enumerate((2, 3, 4)):
            np.testing.assert_allclose(m2[:, j].contiguous().view(torch.float64).numpy(),
                                       (dev ** p).sum(axis=1), rtol=1e-9, atol=1e-9)


def test_forced_launch_shapes_and_builds():
    # relower's overrides, which the card check's sweep times: a shape or a
    # prefetch given is taken; a shape the kernel has no build for is refused
    x, y = (torch.as_tensor(np.random.default_rng(k).normal(size=64)) for k in (41, 42))
    _, plan = lazy._plan([ew.binary_op_columns("add", ew.binary_op_columns("mul", [x], [y]), [x])[0]], None)
    own = plan[0].kernel
    assert fp.relower(plan[0]) is own and fp.relower(plan[0], rows_per_thread=None) is own
    assert own.prefetch and not own.slow and own.rows_per_thread == 4
    off = fp.relower(plan[0], rows_per_thread=4, prefetch=False)
    assert not off.prefetch and off.code == own.code and off.smem_bytes < own.smem_bytes
    small = fp.relower(plan[0], threads=32)
    assert (small.threads, small.rows_per_thread) == (32, 1)
    for bad in ({"threads": 48}, {"threads": 64, "rows_per_thread": 2}):
        with pytest.raises(ValueError):
            fp.relower(plan[0], **bad)
    _, plan = lazy._plan([lazy.lazy_op("exp", x)], None)
    # a long routine holds the host's choice to two rows a thread; four run
    # where asked
    assert plan[0].kernel.slow and plan[0].kernel.rows_per_thread == 2
    assert fp.relower(plan[0], rows_per_thread=4).rows_per_thread == 4


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


# ---------------------------------------------------------------------- #
# The kernel encoding (fused_program.lower)
# ---------------------------------------------------------------------- #


def _programs_of(op, args_list, static=(), tail=None):
    """The compiled programs of one node of ``op`` over each argument tuple
    (the ones the eager op refuses are skipped, as the node refuses them)."""
    out = []
    for args in args_list:
        try:
            e = lazy.lazy_op(op, *args, static=static)
        except (RuntimeError, TypeError, OverflowError):
            continue
        if isinstance(e, lazy.LazyExpr):
            out.extend(lazy._plan([e], tail)[1])
    return out


def _grid_programs(op):
    cols = {d: torch.as_tensor(_column(d, 20 + i)) for i, d in enumerate(DTYPES)}
    if op in BINARY:
        return _programs_of(op, [(cols[dx], cols[dy]) for dx in DTYPES for dy in DTYPES]
                            + [(cols[dx], sc) for dx in DTYPES for sc in SCALARS])
    if op == "round":
        return [p for d in (-3, -1, 0, 2) for p in _programs_of(op, [(c,) for c in cols.values()],
                                                                (("decimals", d),))]
    if op == "astype":
        return [p for t in DTYPES for p in _programs_of(op, [(c,) for c in cols.values()], (("dtype", t),))]
    if op in ("fillna", "clip_lower", "clip_upper"):
        return _programs_of(op, [(c, ew.cast_scalar(1.5, c.dtype)) for d, c in cols.items() if d != "bool"])
    if op in ("isna_nat", "notna_nat"):
        return _programs_of(op, [(cols["int64"],)])
    if op == "tails":
        progs = []
        for red in sorted(reductions.REDUCTIONS):
            for kind in ("float64", "float32", "int64", "int8", "bool"):
                e = ew.binary_op_columns("mul", [cols[kind]], True if kind == "bool" else 2)[0]
                for tail in (("reduce", red, True, 1, True),
                             ("reduce", red, False, 1, False)):
                    if red in fp.REDUCE_MODES:
                        progs.extend(lazy._plan([e], tail)[1])
        for red in sorted(fp.ROW_OPS):
            exprs = [ew.binary_op_columns("mul", [cols[k]], 2)[0] for k in ("float64", "float32", "int64", "int8")]
            for skipna in (True, False):
                progs.extend(lazy._plan(exprs, ("rows", red, skipna, True))[1])
        return progs
    return _programs_of(op, [(c,) for c in cols.values()])


LOWERED_OPS = [*BINARY, "abs", "negative", "invert", "isna", "notna", *sorted(ew.MATH_UNARY), "round",
               "astype", "fillna", "clip_lower", "clip_upper", "isna_nat", "tails"]


def _semantic_refs(program):
    """``Program.instrs`` with operands as ("r", reg), ("s", slot), ("l", leaf)."""

    def ref(o):
        if o == fp.NO_OPERAND:
            return None
        if o >= fp.LEAF_BASE:
            return ("l", o - fp.LEAF_BASE)
        if o >= fp.SCALAR_BASE:
            return ("s", o - fp.SCALAR_BASE)
        return ("r", o)

    return [(op, dt, None if op in (fp.STORE, fp.ACC) else ("r", dst), ref(a), ref(b), ref(c), aux, imm)
            for op, dt, dst, a, b, c, aux, imm in program.instrs]


def _ssa(instrs):
    """Registers renamed to the value each use reads (the order of
    definitions): two programs equal up to register names compare equal."""
    current, out, n = {}, [], 0
    for op, dt, dst, a, b, c, aux, imm in instrs:
        srcs = tuple(("v", current[r]) if r is not None and r[0] in "ra" else r for r in (a, b, c))
        if dst is not None:
            current[dst] = n
            dst = ("v", n)
            n += 1
        out.append((op, dt, dst, *srcs, aux, imm))
    return out


def _lowerings(program):
    return [program.kernel] + ([program.kernel_m2] if program.kernel_m2 is not None else [])


def _kcode(low):
    import struct

    return [struct.unpack_from("<6BH", low.code, 8 * i) for i in range(low.n_code)]


@pytest.mark.parametrize("op", LOWERED_OPS)
def test_lowering_round_trips_to_the_semantic_program(op):
    programs = _grid_programs(op)
    assert programs
    for program in programs:
        for low in _lowerings(program):
            assert _ssa(fp.decode(low, len(program.slots))) == _ssa(_semantic_refs(program)), \
                (op, program.instrs)


@pytest.mark.parametrize("op", LOWERED_OPS)
def test_each_leaf_is_loaded_once_before_its_first_use(op):
    loads = {fp.KOP[n] for n in fp.KOPS if n.startswith("LD_")}
    for program in _grid_programs(op):
        for low in _lowerings(program):
            code = _kcode(low)
            n_ld = sum(1 for ins in code if ins[0] in loads)
            # the loads are the code's head: each a run of leaves of one dtype
            # (dt of them from leaf aux into the slots from dst), and together
            # every leaf the program reads, once, each into its own slot
            assert all(ins[0] in loads for ins in code[:n_ld])
            assert not any(ins[0] in loads for ins in code[n_ld:])
            loaded = [(ins[6] + j, ins[2] + j, ins[0]) for ins in code[:n_ld] for j in range(ins[1])]
            assert [leaf for leaf, _, _ in loaded] == list(range(len(program.leaves)))
            assert [slot for _, slot, _ in loaded] == list(range(len(program.leaves)))
            for leaf, _, kop in loaded:
                want = "LD_U8" if program.leaf_dtypes[leaf] == fp.BOOL else \
                    "LD_" + fp._NAME[program.leaf_dtypes[leaf]]
                assert kop == fp.KOP[want]
            # no instruction writes a leaf's slot before the leaf's last read
            decoded = fp.decode(low, len(program.slots))
            assert _ssa(decoded) == _ssa(_semantic_refs(program))


@pytest.mark.parametrize("op", LOWERED_OPS)
def test_lowered_operands_are_slots_or_constants(op):
    for program in _grid_programs(op):
        for low in _lowerings(program):
            n_const = len(program.slots) + len(low.fixed)
            assert n_const <= fp.MAX_CONSTS and low.n_slots <= fp.MAX_SLOTS
            for kop, dt, dst, a, b, c, aux in _kcode(low):
                assert dst in (fp.NONE_OPERAND, fp.ACC_OPERAND) or dst < low.n_slots
                for o in (a, b, c):
                    if o in (fp.NONE_OPERAND, fp.ACC_OPERAND):
                        continue
                    # a register-file slot, or a constant: never a leaf
                    assert (o & fp.CONST_BIT and (o & 0x7F) < n_const) or o < low.n_slots


def test_kernel_opcodes_match_the_source():
    import os
    import re

    src = open(os.path.join(os.path.dirname(fp.__file__), "csrc", "fused.cu")).read()
    block = src[src.index("#define FUSED_KOPS(X)"):src.index("enum KOp")]
    assert tuple(re.findall(r"X\((\w+)\)", block)) == fp.KOPS
    cases = src[src.index("switch (op)"):]
    for name in fp.KOPS:  # every opcode has its case, written out or by a macro
        base, _, cls = name.rpartition("_")
        assert (f"K_{name}:" in cases or f"CMP({base}," in cases or f"MATH({base}," in cases
                or f"SLOW({base})" in cases or f"ACC_FLOAT({name[4:]}," in cases
                or f"ACC_INT({name[4:]}," in cases), name


def test_launch_shape_fits_shared_memory_at_every_size():
    for n_slots in range(0, fp.MAX_SLOTS + 1):
        for n_out in (1, 8, fp.MAX_OUTPUTS):
            for n_consts in (0, fp.MAX_SCALARS, fp.MAX_CONSTS):
                for mode in (fp.TAIL_NONE, fp.TAIL_SUM, fp.TAIL_M2):
                    for forced, prefetch, slow in itertools.product((None, 1, 2, 4), (False, True),
                                                                    (False, True)):
                        n_leaves = min(n_slots, fp.MAX_LEAVES)
                        try:
                            threads, k, smem = fp.launch_shape(n_slots, n_leaves, n_consts, n_out, mode, forced,
                                                               prefetch, slow)
                        except ValueError:
                            # only a forced K > 1 may not fit 256 threads
                            assert forced and forced > 1
                            continue
                        assert forced or not slow or k <= 2
                        need = n_consts + (n_out if mode == fp.TAIL_M2 else 0) + \
                            (3 * n_out * threads if mode != fp.TAIL_NONE else 0) + \
                            (n_slots + (n_leaves if prefetch else 0)) * threads * k
                        assert smem == 8 * need <= fp.SMEM_MAX
                        assert k in fp.ROWS_PER_THREAD and (forced is None or k == forced)
                        assert threads == fp.THREADS or (k == 1 and threads in (128, 64, 32))


def test_programs_at_the_caps_fit_the_kernel():
    rng = np.random.default_rng(31)
    leaves = [torch.as_tensor(rng.normal(size=64)) for _ in range(fp.MAX_LEAVES)]
    roots = [ew.binary_op_columns("add", [leaves[2 * i]], [leaves[2 * i + 1]])[0] for i in range(32)]
    checked = 0
    for tail in (None, ("reduce", "sum", True, 1, False), ("reduce", "var", True, 1, False)):
        lin, plan = lazy._plan(roots, tail)
        assert len(plan) == 1 and len(plan[0].leaves) == fp.MAX_LEAVES
        assert len(plan[0].out_dtypes) == fp.MAX_OUTPUTS
        for low in _lowerings(plan[0]):
            assert low.n_code <= fp.MAX_CODE and low.smem_bytes <= fp.SMEM_MAX
            n_leaves = len(plan[0].leaves) if low.prefetch else 0
            assert (low.n_slots + n_leaves) * low.threads * low.rows_per_thread * 8 <= low.smem_bytes
            checked += 1
        got = fk.run_program(plan[0], lazy._leaf_args(lin, plan[0]), lin.scalars, 64)
        want = fk.run_program_plain(plan[0], lazy._leaf_args(lin, plan[0]), lin.scalars, 64)
        assert all(torch.equal(g, w) for g, w in zip(got[0], want[0]))
    # the 150-node program of the card's check: 151 instructions over 8 leaves
    e = ew.binary_op_columns("mul", [leaves[0]], [leaves[1]])[0]
    for k in range(1, 150):
        e = ew.binary_op_columns(("add", "sub", "mul", "add")[k % 4] if k % 5 else "mul", [e],
                                 0.5 if k % 5 == 0 else [leaves[k % 8]])[0]
    _, plan = lazy._plan([e], None)
    low = plan[0].kernel
    assert len(plan) == 1 and low.n_code == len(plan[0].instrs) + 1 <= fp.MAX_CODE  # one load of 8 leaves
    assert low.smem_bytes <= fp.SMEM_TARGET and checked == 4
    # 151 instructions over 8 leaves: long against its loads, so no second
    # copy of the leaf slots; a * b + c: short, so the next tile's leaves
    # arrive while a tile runs
    assert not low.prefetch and not low.slow and low.rows_per_thread == 4
    _, plan = lazy._plan([ew.binary_op_columns("add", ew.binary_op_columns("mul", [leaves[0]], [leaves[1]]),
                                               [leaves[2]])[0]], None)
    assert plan[0].kernel.prefetch and plan[0].kernel.rows_per_thread == 4
