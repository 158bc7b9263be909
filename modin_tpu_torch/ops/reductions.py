"""Column reductions with pandas NaN semantics.

The port's counterpart of ``modin_tpu/ops/reductions.py`` (``_reduce_one``,
``reduce_columns``), cut to sum/mean/count/min/max.  Columns are unpadded on
one device, so the validity mask of the JAX package is gone; NaN handling,
result dtypes and the float64 accumulation of ``mean`` are the same.  Torch's
full reductions on CUDA take a fixed order, so a result repeats bit for bit
from run to run.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from modin_tpu_torch.parallel.engine import materialize as _engine_materialize

REDUCTIONS = frozenset(["sum", "mean", "count", "min", "max"])


def _extreme(c: torch.Tensor, op: str, skipna: bool, nan_mask, n: int) -> torch.Tensor:
    reducer = torch.amin if op == "min" else torch.amax
    if nan_mask is None:
        if c.dtype == torch.bool:
            return reducer(c.to(torch.uint8)).to(torch.bool)
        return reducer(c)
    neutral = float("inf") if op == "min" else float("-inf")
    r = reducer(torch.where(nan_mask, neutral, c))
    n_use = n - nan_mask.sum()
    nan = torch.full_like(r, float("nan"))
    if not skipna:
        r = torch.where(nan_mask.any(), nan, r)
    return torch.where(n_use == 0, nan, r)


def _reduce_one(op: str, c: torch.Tensor, n: int, skipna: bool) -> torch.Tensor:
    """Reduce one column of ``n`` rows to a 0-d tensor."""
    is_f = c.dtype.is_floating_point
    nan_mask = torch.isnan(c) if is_f else None
    if op == "count":
        if nan_mask is None:
            return torch.tensor(n, dtype=torch.int64, device=c.device)
        return (~nan_mask).sum()
    if op == "sum":
        if skipna and is_f:
            return torch.where(nan_mask, torch.zeros((), dtype=c.dtype, device=c.device), c).sum()
        return c.sum()
    if op in ("min", "max"):
        return _extreme(c, op, skipna, nan_mask, n)
    if op == "mean":
        x = c.to(torch.float64)
        if is_f and skipna:
            x = torch.where(nan_mask, 0.0, x)
            n_use = n - nan_mask.sum()
        else:
            n_use = torch.tensor(n, dtype=torch.int64, device=c.device)
        mean = x.sum() / n_use
        return torch.where(n_use == 0, torch.full_like(mean, float("nan")), mean)
    raise ValueError(op)


def reduce_columns(
    op_name: str,
    cols: List[torch.Tensor],
    n: int,
    skipna: bool = True,
    cast_bool: bool = False,
) -> list:
    """Reduce each column (``n`` rows) to a scalar; returns 0-d numpy arrays.

    ``cast_bool`` applies the pandas bool->int promotion of the arithmetic
    aggregations.
    """
    if op_name not in REDUCTIONS:
        raise ValueError(f"reduction {op_name!r} is not ported")
    n, skipna = int(n), bool(skipna)
    results = []
    for c in cols:
        if cast_bool and c.dtype == torch.bool:
            c = c.to(torch.int64)
        results.append(_reduce_one(op_name, c, n, skipna))
    return [np.asarray(r) for r in _engine_materialize(results)]
