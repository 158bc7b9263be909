"""Elementwise ops over column sets: deferred chains and their eager bodies.

The port's counterpart of ``modin_tpu/ops/elementwise.py``.  As in the JAX
package, the builders (``binary_op_columns``, ``unary_op_columns``,
``isna_columns``, ``round_columns``, ``fillna_columns``, ``clip_columns``,
``math_unary_columns``, ``astype_column``) do not compute: each returns
:class:`~modin_tpu_torch.ops.lazy.LazyExpr` nodes, and a consumer runs the
whole accumulated chain as one launch of the fused kernel
(``ops/lazy.py``, ``ops/cuda/fused_kernels.py``).  The eager torch bodies
stay here as the op registry (:func:`get_op`): a node's dtype is the eager
op's over 0-length tensors, the fused kernel computes what they compute, its
plain version calls them, and an op the kernel does not take (a barrier)
runs them.  Result dtypes follow numpy's promotion rules (NEP 50: a Python
scalar is weak), which is what the JAX package gets under x64 and what
pandas does; torch's own rules would turn ``int64 + 2.5`` into float32, so
every operand is cast to the numpy result dtype first.

Pandas semantic deltas, as in the JAX package:
- int / int true-division promotes to float64 and yields +/-inf on zero
  division;
- int floordiv/mod by a zero divisor promote to float64 in pandas 3 — a
  data-dependent dtype that the query compiler sends to pandas; the kernels'
  zero-masking only backstops divisors known nonzero at dispatch.

The logical ops ``&``/``|``/``^`` and ``invert`` keep the JAX package's
names (``__and__``, ...), which are also the query compiler's method names.

The cumulative ops skip NaN as pandas does (a NaN keeps its place and does
not poison later rows).  All four run on the scan kernel
(``ops/cuda/scan_kernels.py``, one segment): float sums and products in a
fixed order, so a result repeats bit for bit, and int sums and products
wrapping as numpy's do.  ``torch.cummax`` took ~60 ms a column at 2e7
rows on the H100, the kernel well under 1 ms.  They are barriers of a
deferred chain: their inputs materialize first.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch

from modin_tpu_torch.ops.cuda.scan_kernels import scan
from modin_tpu_torch.ops.lazy import lazy_op
from modin_tpu_torch.utils import numpy_dtype, torch_dtype


def _np_operand(x: Any) -> Any:
    """What numpy's promotion sees: a tensor's dtype (strong) or the scalar
    itself (a Python scalar is weak, a numpy scalar strong)."""
    if isinstance(x, torch.Tensor):
        return numpy_dtype(x.dtype)
    return x


def _is_py_int(v: Any) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _result_dtype(x: Any, y: Any, out_of_range: str = "raise") -> np.dtype:
    """numpy's result dtype of ``x <op> y`` (NEP 50).  A weak Python int
    that an int result cannot hold raises ``OverflowError`` (``"raise"``:
    arithmetic and the logical ops, as numpy and pandas raise), widens the
    comparison to int64 (``"widen"``: numpy compares it exactly), or is left
    to the caller (``"ignore"``: a true division computes in float64)."""
    dt = np.result_type(_np_operand(x), _np_operand(y))
    if dt.kind in "iu" and out_of_range != "ignore":
        for v in (x, y):
            if _is_py_int(v) and not np.iinfo(dt).min <= v <= np.iinfo(dt).max:
                if out_of_range == "widen" and np.iinfo(np.int64).min <= v <= np.iinfo(np.int64).max:
                    return np.dtype(np.int64)
                raise OverflowError(f"Python integer {v} out of bounds for {dt}")
    return dt


def _cast(x: Any, dtype: np.dtype) -> Any:
    if isinstance(x, torch.Tensor):
        return x.to(torch_dtype(dtype))
    if isinstance(x, np.generic):
        return x.item()
    return x


def _promote(x: Any, y: Any, out_of_range: str = "raise"):
    dt = _result_dtype(x, y, out_of_range)
    return _cast(x, dt), _cast(y, dt), dt


def _is_int(dt: np.dtype) -> bool:
    return dt.kind in "iu"


def _as_tensor_like(y: Any, x: torch.Tensor) -> torch.Tensor:
    if isinstance(y, torch.Tensor):
        return y
    return torch.full_like(x, y)


def _tensors(x, y):
    """Both operands as tensors (a scalar side broadcast to the other's shape)."""
    ref = x if isinstance(x, torch.Tensor) else y
    return _as_tensor_like(x, ref), _as_tensor_like(y, ref)


def _floordiv(x, y):
    x, y, dt = _promote(x, y)
    x, y = _tensors(x, y)
    if _is_int(dt):
        zero = y == 0
        safe = torch.where(zero, torch.ones_like(y), y)
        return torch.where(
            zero, torch.zeros_like(y), torch.div(x, safe, rounding_mode="floor")
        )
    return torch.floor_divide(x, y)


def _mod(x, y):
    x, y, dt = _promote(x, y)
    x, y = _tensors(x, y)
    if _is_int(dt):
        zero = y == 0
        safe = torch.where(zero, torch.ones_like(y), y)
        return torch.where(zero, torch.zeros_like(y), torch.remainder(x, safe))
    return torch.remainder(x, y)


def _truediv(x, y):
    dt = _result_dtype(x, y, "ignore")
    if dt.kind in "iub":
        dt = np.dtype(np.float64)
    x, y = _tensors(_cast(x, dt), _cast(y, dt))
    return x / y


def _promoted(fn: Callable, out_of_range: str = "raise") -> Callable:
    """``fn`` applied after casting both operands to their result dtype."""

    def op(x, y):
        x, y, _ = _promote(x, y, out_of_range)
        return fn(x, y)

    return op


def _build_ops() -> Dict[str, Callable]:
    return {
        "add": _promoted(lambda x, y: x + y),
        "radd": _promoted(lambda x, y: y + x),
        "sub": _promoted(lambda x, y: x - y),
        "rsub": _promoted(lambda x, y: y - x),
        "mul": _promoted(lambda x, y: x * y),
        "rmul": _promoted(lambda x, y: y * x),
        "truediv": _truediv,
        "rtruediv": lambda x, y: _truediv(y, x),
        "floordiv": _floordiv,
        "rfloordiv": lambda x, y: _floordiv(y, x),
        "mod": _mod,
        "rmod": lambda x, y: _mod(y, x),
        "pow": _promoted(lambda x, y: x ** y),
        "rpow": _promoted(lambda x, y: y ** x),
        "eq": _promoted(lambda x, y: x == y, "widen"),
        "ne": _promoted(lambda x, y: x != y, "widen"),
        "lt": _promoted(lambda x, y: x < y, "widen"),
        "le": _promoted(lambda x, y: x <= y, "widen"),
        "gt": _promoted(lambda x, y: x > y, "widen"),
        "ge": _promoted(lambda x, y: x >= y, "widen"),
        "__and__": _promoted(lambda x, y: x & y),
        "__or__": _promoted(lambda x, y: x | y),
        "__xor__": _promoted(lambda x, y: x ^ y),
        "__rand__": _promoted(lambda x, y: y & x),
        "__ror__": _promoted(lambda x, y: y | x),
        "__rxor__": _promoted(lambda x, y: y ^ x),
        # unary
        "abs": torch.abs,
        "negative": torch.neg,
        # logical not of bool, bitwise not of ints
        "invert": torch.bitwise_not,
        "cumsum": lambda x: _nan_skipping_cum(x, "cumsum"),
        "cumprod": lambda x: _nan_skipping_cum(x, "cumprod"),
        "cummax": lambda x: _nan_skipping_cum(x, "cummax"),
        "cummin": lambda x: _nan_skipping_cum(x, "cummin"),
    }


# each cumulative op's scan-kernel mode, and its NaN fill: the neutral element
CUM_SCAN_MODE = {"cumsum": "seg_add", "cumprod": "seg_mul", "cummax": "seg_max", "cummin": "seg_min"}
CUM_NEUTRAL = {"cumsum": 0.0, "cumprod": 1.0, "cummax": float("-inf"), "cummin": float("inf")}


def _nan_skipping_cum(x: torch.Tensor, op: str) -> torch.Tensor:
    """pandas' skipna cumulative op down one column.  Ints scan as int64:
    cumsum/cumprod give int64, cummax/cummin keep the column's dtype (the
    compiler declines unsigned columns, which pandas widens to uint64)."""
    if not x.dtype.is_floating_point:
        y = scan(CUM_SCAN_MODE[op], x.to(torch.int64))
        return y if op in ("cumsum", "cumprod") else y.to(x.dtype)
    nan = torch.isnan(x)
    filled = torch.where(nan, CUM_NEUTRAL[op], x).to(torch.float64)
    y = scan(CUM_SCAN_MODE[op], filled).to(x.dtype)
    return torch.where(nan, float("nan"), y)


CUM_OPS = frozenset(["cumsum", "cumprod", "cummax", "cummin"])
_UNARY = ("abs", "negative", "invert", *sorted(CUM_OPS))

_OPS: Dict[str, Callable] = _build_ops()

BINARY_OPS = frozenset(k for k in _OPS if k not in _UNARY)
LOGICAL_OPS = frozenset(k for k in BINARY_OPS if k.startswith("__"))
COMPARE_OPS = frozenset(["eq", "ne", "lt", "le", "gt", "ge"])
ARITH_OPS = BINARY_OPS - LOGICAL_OPS - COMPARE_OPS


def binary_op_columns(op_name: str, cols: List[Any], other: Any) -> List[Any]:
    """Deferred binary op on device columns (tensors or LazyExprs) vs a
    scalar, matching columns, or one scalar per column.

    One numpy scalar ``other`` of an arithmetic op promotes as its Python
    value (weak), as pandas promotes a scalar operand (``float32 +
    np.float64(0.1)`` stays float32, ``int8 * np.int64(3)`` int8), and so
    meets the range check of :func:`_result_dtype`: an int that the column's
    dtype cannot hold raises ``OverflowError`` here, before anything
    defers.  Comparisons and the logical ops keep numpy scalars strong, as
    pandas does; one scalar per column (a broadcast Series' values) is
    strong too."""
    if op_name not in BINARY_OPS:
        raise ValueError(f"binary op {op_name!r} is not ported")
    if isinstance(other, (list, tuple)):
        return [lazy_op(op_name, c, o) for c, o in zip(cols, other)]
    if isinstance(other, np.generic) and op_name in ARITH_OPS:
        other = other.item()
    return [lazy_op(op_name, c, other) for c in cols]


def unary_op_columns(op_name: str, cols: List[Any]) -> List[Any]:
    """Deferred unary op on device columns (the cumulative ops are
    barriers: they run at once on their materialized inputs)."""
    if op_name not in _UNARY:
        raise ValueError(f"unary op {op_name!r} is not ported")
    return [lazy_op(op_name, c) for c in cols]


# numpy's math ufuncs of one argument (``np.sqrt(df)``; the JAX package's
# ``_MATH_UNARY``); torch's sign is 0 at NaN where numpy's is NaN
MATH_UNARY = frozenset(
    ["sqrt", "exp", "log", "log2", "log10", "sin", "cos", "tan", "tanh", "floor", "ceil", "sign"]
)
_MATH_FN: Dict[str, Callable] = {
    **{name: getattr(torch, name) for name in MATH_UNARY},
    "sign": lambda x: torch.where(torch.isnan(x), x, torch.sign(x)) if x.is_floating_point() else torch.sign(x),
}


def _math_dtype(op_name: str, dtype: torch.dtype) -> np.dtype:
    return getattr(np, op_name)(np.empty(0, numpy_dtype(dtype))).dtype


def _math_one(op_name: str, c: torch.Tensor) -> torch.Tensor:
    """numpy's ufunc ``op_name`` of one column, in numpy's result dtype."""
    dtype = _math_dtype(op_name, c.dtype)
    if dtype.kind in "iu":
        return _MATH_FN[op_name](c) if op_name == "sign" else c
    work = torch.float32 if dtype == np.float16 else torch_dtype(dtype)
    return _MATH_FN[op_name](c.to(work)).to(torch_dtype(dtype))


def math_unary_columns(op_name: str, cols: List[Any]) -> List[Any]:
    """numpy's ufunc ``op_name`` over device columns, deferred, in numpy's
    result dtype: ints become float64 (int8 float16, int16 float32), floats
    keep theirs; an int result (``sign``; ``floor``/``ceil`` where numpy
    keeps ints) stays int.  numpy's float16 loops compute in float32 and
    round, as this does (float16 results are barriers: they run at once)."""
    out = []
    for c in cols:
        if _math_dtype(op_name, c.dtype).kind in "iu" and op_name != "sign":
            out.append(c)
        else:
            out.append(lazy_op(op_name, c))
    return out


def _shift_one(c: torch.Tensor, n: int, periods: int, as_diff: bool) -> torch.Tensor:
    k = abs(periods)
    if k == 0:
        if as_diff:
            # pandas diff(0) still promotes ints to float64
            return (c - c).to(torch.float64)
        return c  # shift(0) keeps the dtype
    if k >= n:
        # pandas: shifting past the frame is all-NaN (diff likewise)
        return torch.full(c.shape, float("nan"), dtype=torch.float64, device=c.device)
    x = c if c.dtype.is_floating_point else c.to(torch.float64)
    fill = torch.full((k,), float("nan"), dtype=x.dtype, device=x.device)
    if periods > 0:
        shifted = torch.cat([fill, x[: n - k]])
    else:
        shifted = torch.cat([x[k:], fill])
    return x - shifted if as_diff else shifted


def shift_columns(cols: List[torch.Tensor], n: int, periods: int) -> List[torch.Tensor]:
    """pandas shift: rows move by ``periods`` with NaN fill (ints become
    float64, floats keep their dtype)."""
    return [_shift_one(c, int(n), int(periods), False) for c in cols]


def diff_columns(cols: List[torch.Tensor], n: int, periods: int) -> List[torch.Tensor]:
    """pandas diff: x - x.shift(periods)."""
    return [_shift_one(c, int(n), int(periods), True) for c in cols]


# ---------------------------------------------------------------------- #
# Missing data and dtypes: the maps behind isna/notna, round, fillna, clip
# and astype (the JAX package's op bodies ``isna``/``isna_nat``, ``round``,
# ``fillna``, ``clip_lower``/``clip_upper``, ``astype``)
# ---------------------------------------------------------------------- #

# NaT of a datetime/timedelta column stored as int64 (pandas' own sentinel)
NAT_SENTINEL = np.iinfo(np.int64).min


def _isna_one(x: torch.Tensor, is_dt: bool) -> torch.Tensor:
    if is_dt:
        return x == NAT_SENTINEL
    if x.dtype.is_floating_point:
        return torch.isnan(x)
    return torch.zeros(x.shape, dtype=torch.bool, device=x.device)


def isna_columns(cols: List[Any], mM_flags, negate: bool) -> List[Any]:
    """Deferred isna (or notna, ``negate``) per column: NaN of floats, the
    NaT sentinel of the columns flagged datetime/timedelta, nothing of the
    rest."""
    out = []
    for c, is_dt in zip(cols, mM_flags):
        name = ("notna" if negate else "isna") + ("_nat" if is_dt else "")
        out.append(lazy_op(name, c))
    return out


def _round_int(x: torch.Tensor, decimals: int) -> torch.Tensor:
    """pandas' round of an int column to ``decimals`` < 0: to the nearest
    multiple of 10**-decimals, half to even, in the column's dtype (a
    result past its range wraps as numpy's cast does).  Computed in int64,
    so it equals numpy's float64 path wherever that is exact (|x| < 2**53)
    and stays exact beyond it."""
    unit = 10 ** (-decimals)
    v = x.to(torch.int64)
    q = torch.div(v, unit, rounding_mode="floor")
    twice_r = 2 * (v - q * unit)  # in [0, 2 * unit): no overflow for unit <= 1e18
    up = (twice_r > unit) | ((twice_r == unit) & (q % 2 == 1))
    return ((q + up.to(torch.int64)) * unit).to(x.dtype)


def _round_one(x: torch.Tensor, decimals: int) -> torch.Tensor:
    if x.dtype.is_floating_point:
        return torch.round(x, decimals=decimals)
    if decimals < 0 and x.dtype != torch.bool:
        return _round_int(x, decimals)
    return x


def round_columns(cols: List[Any], decimals: int, mM_flags=None) -> List[Any]:
    """Deferred pandas ``round``: floats as numpy's ``round`` (scale, round
    half to even, unscale; ``torch.round(decimals=)`` computes the same),
    ints with ``decimals`` < 0 by :func:`_round_int` (the caller declines
    ``decimals`` < -18, past int64); other ints, bools and the columns
    flagged datetime/timedelta are unchanged."""
    decimals = int(decimals)
    flags = mM_flags if mM_flags is not None else [False] * len(cols)
    out = []
    for c, is_dt in zip(cols, flags):
        if c.dtype.is_floating_point or (decimals < 0 and not is_dt and c.dtype != torch.bool):
            out.append(lazy_op("round", c, static=(("decimals", decimals),)))
        else:
            out.append(c)
    return out


def cast_scalar(value: Any, dtype: torch.dtype) -> Any:
    """``value`` cast by numpy to ``dtype`` (rounded to nearest; past a
    float32 range it is inf, as numpy and pandas make it), as a Python
    scalar that torch takes without a range check."""
    if value is None:
        return None
    with np.errstate(over="ignore"):
        return numpy_dtype(dtype).type(value).item()


def _fillna_one(x: torch.Tensor, value: Any) -> torch.Tensor:
    if not x.dtype.is_floating_point:
        return x
    return torch.where(torch.isnan(x), cast_scalar(value, x.dtype), x)


def fillna_columns(cols: List[Any], value: Any) -> List[Any]:
    """Deferred: a numeric scalar into the NaN rows of float columns (cast
    to the column's dtype, as pandas casts it); int and bool columns hold no
    NaN and pass through."""
    return [
        lazy_op("fillna", c, cast_scalar(value, c.dtype)) if c.dtype.is_floating_point else c
        for c in cols
    ]


def clip_columns(cols: List[torch.Tensor], lower: Any, upper: Any) -> List[torch.Tensor]:
    """Elementwise clip to [lower, upper] (either may be None); NaN stays
    NaN.  Each bound is cast to the column's dtype first, as numpy compares
    a float32 array with a Python float.  The caller picks the result dtype
    (pandas': an int column becomes float64 once a bound it cannot hold
    replaces a value), passes the columns already cast to it, and passes
    an int column only bounds it holds."""
    out = []
    for c in cols:
        lo, hi = cast_scalar(lower, c.dtype), cast_scalar(upper, c.dtype)
        r = c
        if lo is not None:
            r = lazy_op("clip_lower", r, lo)
        if hi is not None:
            r = lazy_op("clip_upper", r, hi)
        out.append(r)
    return out


def astype_column(col: Any, target: np.dtype) -> Any:
    """Deferred numpy ``astype`` to a numeric ``target`` (ints wrap, floats
    round to nearest)."""
    return lazy_op("astype", col, static=(("dtype", str(np.dtype(target))),))


# ---------------------------------------------------------------------- #
# The op registry: the eager body of every deferred op, by the JAX
# package's names (``modin_tpu/ops/elementwise.py::_build_ops``)
# ---------------------------------------------------------------------- #

_REGISTRY: Dict[str, Callable] = {
    **_OPS,
    "isna": lambda x: _isna_one(x, False),
    "notna": lambda x: ~_isna_one(x, False),
    "isna_nat": lambda x: _isna_one(x, True),
    "notna_nat": lambda x: ~_isna_one(x, True),
    "round": _round_one,
    "fillna": _fillna_one,
    "clip_lower": lambda x, lo: torch.where(x < lo, lo, x),
    "clip_upper": lambda x, hi: torch.where(x > hi, hi, x),
    "astype": lambda x, dtype: x.to(torch_dtype(np.dtype(dtype))),
    # torch.where(mask, x, y) with y a scalar in x's dtype (the fused
    # groupby's slot column)
    "where": lambda m, x, y: torch.where(m, x, torch.tensor(y, dtype=x.dtype)),
    **{name: (lambda x, name=name: _math_one(name, x)) for name in MATH_UNARY},
}


def get_op(op_name: str) -> Callable:
    """The eager body of a deferred op (the registry of ``ops/lazy.py``)."""
    return _REGISTRY[op_name]
