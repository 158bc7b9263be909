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
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch

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
        "eq": _promoted(lambda x, y: x == y),
        "ne": _promoted(lambda x, y: x != y),
        "lt": _promoted(lambda x, y: x < y),
        "le": _promoted(lambda x, y: x <= y),
        "gt": _promoted(lambda x, y: x > y),
        "ge": _promoted(lambda x, y: x >= y),
        # unary
        "abs": torch.abs,
        "negative": torch.neg,
    }


_OPS: Dict[str, Callable] = _build_ops()

BINARY_OPS = frozenset(k for k in _OPS if k not in ("abs", "negative"))


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
