"""Append-only fold rules.

The port's counterpart of ``modin_tpu/views/incremental.py``: a column
grown by a row ``concat`` is its parent's rows plus an appended tail, so a
cached aggregate over the parent folds the tail's partial instead of
reducing the whole column again.

Exactness:

- ``count``, ``min``, ``max``, ``any``, ``all`` and int/bool ``sum`` and
  ``prod`` fold bit for bit: the combines stay in numpy dtypes (``np.add``
  on int64 wraps as pandas' sum does; an unsigned sum comes as its int64
  bits and wraps the same way), never through Python ints;
- float ``sum``/``prod`` and every ``mean`` re-associate the accumulation
  (a mean is multiplied back by its valid count);
- the rest (var, std, sem, skew, kurt, median, nunique, mode, sorted
  representations) does not fold: the child misses and recomputes.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np

# the reductions with an algebraic combine of partials, and the groupby
# aggregations with a partial-table combine: the streaming layer's sets, one
# source of truth for which aggregations recombine from partials
from modin_tpu_torch.streaming import GROUPBY_COMBINABLE, REDUCE_COMBINABLE  # noqa: F401

#: scalar reductions whose artifact folds over an append
FOLDABLE_REDUCES = REDUCE_COMBINABLE | frozenset({"any", "all"})

#: scalar reductions cached as whole results
CACHEABLE_REDUCES = FOLDABLE_REDUCES | frozenset({"var", "std", "sem", "skew", "kurt", "median"})

#: groupby aggregations whose table folds over an append
FOLDABLE_GROUPBYS = GROUPBY_COMBINABLE | frozenset({"size"})


def combine_scalar(op: str, skipna: bool, old: np.ndarray, tail: np.ndarray) -> np.ndarray:
    """Fold one column's tail reduction into its cached prefix result:
    ``old`` and ``tail`` are the 0-d numpy results of the same reduction
    over each segment."""
    old = np.asarray(old)
    tail = np.asarray(tail)
    with np.errstate(over="ignore", invalid="ignore"):
        if op in ("sum", "count"):
            return np.add(old, tail)
        if op == "prod":
            return np.multiply(old, tail)
    if op == "min":
        if old.dtype.kind == "f" and skipna:
            # skipna: a NaN segment result means an all-NaN segment
            return np.fmin(old, tail)
        return np.minimum(old, tail)  # NaN propagates (skipna=False)
    if op == "max":
        if old.dtype.kind == "f" and skipna:
            return np.fmax(old, tail)
        return np.maximum(old, tail)
    if op == "any":
        return np.logical_or(old, tail)
    if op == "all":
        return np.logical_and(old, tail)
    raise ValueError(op)


def combine_mean(old_mean: np.ndarray, old_k: int, tail_mean: np.ndarray, tail_k: int) -> Tuple[np.ndarray, int]:
    """Fold a (mean, valid count) pair: a segment with no valid value
    defers to the other; a NaN with valid values (skipna=False) poisons."""
    k = int(old_k) + int(tail_k)
    if old_k == 0:
        return np.asarray(tail_mean, dtype=np.float64), k
    if tail_k == 0:
        return np.asarray(old_mean, dtype=np.float64), k
    total = np.float64(old_mean) * old_k + np.float64(tail_mean) * tail_k
    return np.float64(total / k), k


def combine_groupby(agg: str, old: Any, tail: Any, old_count: Any = None, tail_count: Any = None) -> Tuple[Any, Any]:
    """Combine two groupby result tables (same columns, key-indexed,
    sorted, dropna) into the whole data's table: ``(combined, counts)``,
    the per-group valid counts carried for ``mean`` only."""
    import pandas

    levels = list(range(old.index.nlevels))
    if agg in ("sum", "count", "size"):
        return pandas.concat([old, tail]).groupby(level=levels, sort=True).sum(), None
    if agg in ("min", "max"):
        grouped = pandas.concat([old, tail]).groupby(level=levels, sort=True)
        return (grouped.min() if agg == "min" else grouped.max()), None
    if agg == "mean":
        counts = pandas.concat([old_count, tail_count]).groupby(level=levels, sort=True).sum()

        def contribution(means, ks):
            k = ks.to_numpy()
            # an all-NaN group (k = 0) adds 0 to the sum; its NaN comes back
            # through the 0/0 division
            return means.where(k != 0, 0.0) * np.where(k != 0, k, 0)

        sums = pandas.concat(
            [contribution(old, old_count), contribution(tail, tail_count)]
        ).groupby(level=levels, sort=True).sum()
        return sums / counts.to_numpy(), counts
    raise ValueError(agg)


def extend_dict_encoding(base_col: Any, tail_values: np.ndarray) -> Optional[Any]:
    """The concatenated column's :class:`~modin_tpu_torch.ops.dictionary.
    DictEncoding` by code-table extension: factorize only the appended
    tail, union the sorted category tables, remap the base's device codes
    where the tail brought a new category, and concatenate the codes on
    the device.  None where the extension cannot give ``_encode``'s exact
    result (unorderable values, the category bound)."""
    import pandas
    import torch

    from modin_tpu_torch.core.dataframe.torch.dataframe import DeviceColumn
    from modin_tpu_torch.ops import dictionary as _dict
    from modin_tpu_torch.parallel.engine import TorchWrapper

    base_enc = base_col._dict_cache
    if not isinstance(base_enc, _dict.DictEncoding):
        return None
    try:
        tail_codes, tail_cats = pandas.factorize(
            np.asarray(tail_values, dtype=object), sort=True, use_na_sentinel=True
        )
        union, base_map, tail_map = _dict.union_categories(
            base_enc.categories, np.asarray(tail_cats, dtype=object)
        )
    except TypeError:
        return None  # unorderable values
    if len(union) > _dict._MAX_CATEGORIES:
        return None
    tail_has_nan = bool((tail_codes == -1).any())
    tail_fcodes = np.where(
        tail_codes == -1, np.nan, tail_map[np.maximum(tail_codes, 0)] if len(tail_map) else 0.0
    ).astype(np.float64)
    base_raw = base_enc.codes.data
    if len(union) != len(base_enc.categories):
        base_raw = _dict.remap_codes_device(base_raw, base_map)
    tail_dev = TorchWrapper.put(tail_fcodes, base_raw.device)
    codes = DeviceColumn(torch.cat([base_raw, tail_dev]), np.dtype(np.float64))
    return _dict.DictEncoding(codes, union, base_enc.has_nan or tail_has_nan)
