"""Elementwise ops over column sets, eagerly in torch.

The port's counterpart of ``modin_tpu/ops/elementwise.py``.  The JAX package
defers each op into a fused jit (``ops/lazy.py``); here every op runs at once
as torch kernels on the columns' device.  Result dtypes follow numpy's
promotion rules (NEP 50: a Python scalar is weak), which is what the JAX
package gets under x64 and what pandas does; torch's own rules would turn
``int64 + 2.5`` into float32, so every operand is cast to the numpy result
dtype first.

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
rows on the H100, the kernel well under 1 ms.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch

from modin_tpu_torch.ops.cuda.scan_kernels import scan
from modin_tpu_torch.utils import numpy_dtype, torch_dtype


def _np_operand(x: Any) -> Any:
    """What numpy's promotion sees: a tensor's dtype (strong) or the scalar
    itself (a Python scalar is weak, a numpy scalar strong)."""
    if isinstance(x, torch.Tensor):
        return numpy_dtype(x.dtype)
    return x


def _result_dtype(x: Any, y: Any) -> np.dtype:
    return np.result_type(_np_operand(x), _np_operand(y))


def _cast(x: Any, dtype: np.dtype) -> Any:
    if isinstance(x, torch.Tensor):
        return x.to(torch_dtype(dtype))
    if isinstance(x, np.generic):
        return x.item()
    return x


def _promote(x: Any, y: Any):
    dt = _result_dtype(x, y)
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
    dt = _result_dtype(x, y)
    if dt.kind in "iub":
        dt = np.dtype(np.float64)
    x, y = _tensors(_cast(x, dt), _cast(y, dt))
    return x / y


def _promoted(fn: Callable) -> Callable:
    """``fn`` applied after casting both operands to their result dtype."""

    def op(x, y):
        x, y, _ = _promote(x, y)
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
        "eq": _promoted(lambda x, y: x == y),
        "ne": _promoted(lambda x, y: x != y),
        "lt": _promoted(lambda x, y: x < y),
        "le": _promoted(lambda x, y: x <= y),
        "gt": _promoted(lambda x, y: x > y),
        "ge": _promoted(lambda x, y: x >= y),
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


def binary_op_columns(op_name: str, cols: List[torch.Tensor], other: Any) -> List[torch.Tensor]:
    """Binary op on device columns vs a scalar or matching columns."""
    fn = _OPS[op_name]
    if isinstance(other, (list, tuple)):
        return [fn(c, o) for c, o in zip(cols, other)]
    return [fn(c, other) for c in cols]


def unary_op_columns(op_name: str, cols: List[torch.Tensor]) -> List[torch.Tensor]:
    """Unary op on device columns."""
    fn = _OPS[op_name]
    return [fn(c) for c in cols]


# numpy's math ufuncs of one argument (``np.sqrt(df)``; the JAX package's
# ``_MATH_UNARY``); torch's sign is 0 at NaN where numpy's is NaN
MATH_UNARY = frozenset(
    ["sqrt", "exp", "log", "log2", "log10", "sin", "cos", "tan", "tanh", "floor", "ceil", "sign"]
)
_MATH_FN: Dict[str, Callable] = {
    **{name: getattr(torch, name) for name in MATH_UNARY},
    "sign": lambda x: torch.where(torch.isnan(x), x, torch.sign(x)) if x.is_floating_point() else torch.sign(x),
}


def math_unary_columns(op_name: str, cols: List[torch.Tensor]) -> List[torch.Tensor]:
    """numpy's ufunc ``op_name`` over device columns, in numpy's result
    dtype: ints become float64 (int8 float16, int16 float32), floats keep
    theirs; an int result (``sign``; ``floor``/``ceil`` where numpy keeps
    ints) stays int.  numpy's float16 loops compute in float32 and round,
    as this does."""
    out = []
    for c in cols:
        dtype = getattr(np, op_name)(np.empty(0, numpy_dtype(c.dtype))).dtype
        if dtype.kind in "iu":
            out.append(_MATH_FN[op_name](c) if op_name == "sign" else c)
            continue
        work = torch.float32 if dtype == np.float16 else torch_dtype(dtype)
        out.append(_MATH_FN[op_name](c.to(work)).to(torch_dtype(dtype)))
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


def isna_columns(cols: List[torch.Tensor], mM_flags, negate: bool) -> List[torch.Tensor]:
    """isna (or notna, ``negate``) per column: NaN of floats, the NaT
    sentinel of the columns flagged datetime/timedelta, nothing of the rest."""
    out = [_isna_one(c, bool(is_dt)) for c, is_dt in zip(cols, mM_flags)]
    return [~m for m in out] if negate else out


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


def round_columns(cols: List[torch.Tensor], decimals: int, mM_flags=None) -> List[torch.Tensor]:
    """pandas ``round``: floats as numpy's ``round`` (scale, round half to
    even, unscale; ``torch.round(decimals=)`` computes the same), ints
    with ``decimals`` < 0 by :func:`_round_int` (the caller declines
    ``decimals`` < -18, past int64); other ints, bools and the columns
    flagged datetime/timedelta are unchanged."""
    decimals = int(decimals)
    flags = mM_flags if mM_flags is not None else [False] * len(cols)
    out = []
    for c, is_dt in zip(cols, flags):
        if c.dtype.is_floating_point:
            out.append(torch.round(c, decimals=decimals))
        elif decimals < 0 and not is_dt and c.dtype != torch.bool:
            out.append(_round_int(c, decimals))
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


def fillna_columns(cols: List[torch.Tensor], value: Any) -> List[torch.Tensor]:
    """A numeric scalar into the NaN rows of float columns (cast to the
    column's dtype, as pandas casts it); int and bool columns hold no NaN
    and pass through."""
    return [
        torch.where(torch.isnan(c), cast_scalar(value, c.dtype), c) if c.dtype.is_floating_point else c
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
            r = torch.where(r < lo, lo, r)
        if hi is not None:
            r = torch.where(r > hi, hi, r)
        out.append(r)
    return out


def astype_column(col: torch.Tensor, target: np.dtype) -> torch.Tensor:
    """numpy's ``astype`` to a numeric ``target`` (ints wrap, floats round
    to nearest)."""
    return col.to(torch_dtype(target))
