"""Groupby reductions as device segment operations.

The port's counterpart of ``modin_tpu/ops/groupby.py``: factorize the key
columns into group codes, then aggregate the value columns by code.

Key factorization strategies (as in the JAX package):
- int-like keys with a small value range -> direct offset codes, counted by
  the CUDA ``bincount`` kernel (no sort)
- wider int keys and float keys          -> ``torch.unique`` (device sort,
                                            one host sync for the group count)
- several keys                           -> one composite code per row,
                                            counted by the same kernel

Rows whose key is NaN get the overflow code ``num_groups`` when
``dropna=True`` and are dropped from every aggregation; with
``dropna=False`` they form a last group of their own.  Columns are not
padded here (one device, one shard), so the overflow bucket holds NaN keys
only.

Determinism: integer aggregations add with integer atomics (exact, so
independent of order); float sums and means sort the codes once (stable)
and reduce each contiguous segment, so the result repeats bit for bit; min
and max do not depend on order.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from modin_tpu_torch.config import GroupbyRangeLimit
from modin_tpu_torch.ops.cuda.groupby_kernels import bincount
from modin_tpu_torch.parallel.engine import materialize as _engine_materialize
from modin_tpu_torch.utils import numpy_dtype

# aggregations this module computes (a subset of the JAX package's
# SEGMENT_AGGS)
SEGMENT_AGGS = frozenset(["sum", "count", "mean", "min", "max", "size"])


class _TooManyGroups(Exception):
    pass


def factorize_keys(
    key_cols: List[torch.Tensor], n: int, dropna: bool = True
) -> Tuple[torch.Tensor, int, List[np.ndarray], Optional[np.ndarray]]:
    """Device factorization of one or more key columns of ``n`` rows.

    Returns (codes, num_groups, group_key_arrays_host, sizes): ``codes``
    maps each row to [0, num_groups), with NaN keys mapped to ``num_groups``
    when ``dropna``.  Group key values are host-side, sorted ascending
    (pandas sort=True order); a NaN group, when kept, is last.  ``sizes`` is
    a host int64 array of per-group row counts where the factorization
    computed one anyway (range and multi-key paths), else None.
    """
    if len(key_cols) == 1:
        k = key_cols[0]
        kdt = numpy_dtype(k.dtype)
        if not k.dtype.is_floating_point:
            k64 = k.to(torch.int64)
            kmin, kmax = (
                int(v) for v in _engine_materialize(torch.stack(torch.aminmax(k64)))
            )
            width = kmax - kmin + 1
            if width <= GroupbyRangeLimit.get():
                ids = k64 - kmin
                counts = np.asarray(_engine_materialize(bincount(ids, width)))
                present = np.nonzero(counts)[0]
                remap = np.full(width, len(present), dtype=np.int64)
                remap[present] = np.arange(len(present))
                codes = torch.as_tensor(remap, device=k.device)[ids]
                uniques = (present + kmin).astype(np.int64).astype(kdt)
                return codes, len(present), [uniques], counts[present]
            uniques, codes = torch.unique(k64, sorted=True, return_inverse=True)
            uniques_host = np.asarray(_engine_materialize(uniques)).astype(kdt)
            return codes, len(uniques_host), [uniques_host], None
        nan_mask = torch.isnan(k)
        has_nan = bool(_engine_materialize(nan_mask.any()))
        if has_nan:
            valid = ~nan_mask
            uniques, inverse = torch.unique(k[valid], sorted=True, return_inverse=True)
            n_valid = int(uniques.shape[0])
            codes = torch.full(k.shape, n_valid, dtype=torch.int64, device=k.device)
            codes[valid] = inverse
        else:
            uniques, codes = torch.unique(k, sorted=True, return_inverse=True)
            n_valid = int(uniques.shape[0])
        uniques_host = np.asarray(_engine_materialize(uniques))
        if dropna or not has_nan:
            return codes, n_valid, [uniques_host], None
        # keep the NaN group: its rows already carry code n_valid
        return codes, n_valid + 1, [
            np.concatenate([uniques_host, np.array([np.nan], uniques_host.dtype)])
        ], None

    # multi-key: combine per-level codes into one composite code
    level_codes = []
    level_uniques = []
    n_groups_each = []
    for k in key_cols:
        codes_i, n_i, uniques_i, _sizes_i = factorize_keys([k], n, dropna=dropna)
        level_codes.append(codes_i)
        level_uniques.append(uniques_i[0])
        n_groups_each.append(n_i)
    total = int(np.prod(n_groups_each))
    if total > GroupbyRangeLimit.get() * 4:
        raise _TooManyGroups()
    # a row is valid only if every level code is in range
    in_range = torch.ones_like(level_codes[0], dtype=torch.bool)
    composite = torch.zeros_like(level_codes[0])
    for codes_i, n_i in zip(level_codes, n_groups_each):
        in_range &= codes_i < n_i
        composite = composite * n_i + torch.clamp(codes_i, max=n_i - 1)
    composite = torch.where(in_range, composite, total)
    counts = np.asarray(_engine_materialize(bincount(composite, total)))
    present = np.nonzero(counts)[0]
    remap = np.full(total + 1, len(present), dtype=np.int64)
    remap[present] = np.arange(len(present))
    codes = torch.as_tensor(remap, device=composite.device)[composite]
    keys_out: List[np.ndarray] = []
    rem = present.copy()
    for uniques_i, n_i in zip(reversed(level_uniques), reversed(n_groups_each)):
        keys_out.append(np.asarray(uniques_i)[rem % n_i])
        rem = rem // n_i
    keys_out.reverse()
    return codes, len(present), keys_out, counts[present]


class _Segments:
    """Per-call facts about the codes, each computed at most once and shared
    by every value column: group sizes and the stable sort by code."""

    def __init__(self, codes: torch.Tensor, num_groups: int, sizes: Optional[np.ndarray]):
        self.codes = codes
        self.num_groups = num_groups
        self._sizes_host = None if sizes is None else np.asarray(sizes, np.int64)
        self._sizes = None
        self._lengths = None
        self._order = None

    def sizes(self) -> torch.Tensor:
        """int64 [num_groups]: rows per group (overflow rows excluded)."""
        if self._sizes is None:
            if self._sizes_host is not None:
                self._sizes = torch.as_tensor(self._sizes_host, device=self.codes.device)
            else:
                self._sizes = self.lengths()[: self.num_groups]
        return self._sizes

    def lengths(self) -> torch.Tensor:
        """int64 [num_groups + 1]: rows per code, the overflow bucket last."""
        if self._lengths is None:
            if self._sizes_host is not None:
                tail = self.codes.shape[0] - int(self._sizes_host.sum())
                self._lengths = torch.as_tensor(
                    np.append(self._sizes_host, tail), device=self.codes.device
                )
            else:
                self._lengths = bincount(self.codes, self.num_groups + 1)
        return self._lengths

    def segment_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Per-code sum of ``x`` over [num_groups + 1] codes."""
        ns = self.num_groups + 1
        if not x.dtype.is_floating_point:
            out = torch.zeros(ns, dtype=x.dtype, device=x.device)
            return out.index_add_(0, self.codes, x)
        if self._order is None:
            self._order = torch.argsort(self.codes, stable=True)
        return torch.segment_reduce(
            x[self._order], "sum", lengths=self.lengths(), unsafe=True
        )

    def valid_count(self, c: torch.Tensor) -> torch.Tensor:
        """Per-code count of the non-NaN values of float column ``c``."""
        out = torch.zeros(self.num_groups + 1, dtype=torch.int64, device=c.device)
        return out.index_add_(0, self.codes, (~torch.isnan(c)).to(torch.int64))


def _segment_extreme(agg: str, c: torch.Tensor, codes: torch.Tensor, ns: int) -> torch.Tensor:
    reduce = "amin" if agg == "min" else "amax"
    is_f = c.dtype.is_floating_point
    is_bool = c.dtype == torch.bool
    if is_f:
        neutral = float("inf") if agg == "min" else float("-inf")
        x = torch.where(torch.isnan(c), neutral, c)
    else:
        x = c.to(torch.uint8) if is_bool else c
        info = torch.iinfo(x.dtype)
        neutral = info.max if agg == "min" else info.min
    out = torch.full((ns,), neutral, dtype=x.dtype, device=x.device)
    out.scatter_reduce_(0, codes, x, reduce, include_self=True)
    if is_f:
        # an all-NaN group kept the neutral infinity
        empty = torch.isposinf(out) if agg == "min" else torch.isneginf(out)
        return torch.where(empty, float("nan"), out)
    return out.to(torch.bool) if is_bool else out


def groupby_reduce(
    agg: str,
    value_cols: List[torch.Tensor],
    codes: torch.Tensor,
    num_groups: int,
    n: int,
    sizes: Optional[np.ndarray] = None,
) -> List[torch.Tensor]:
    """Aggregate value columns by group codes; returns device tensors of
    length ``num_groups`` (the overflow bucket is sliced off).

    ``sizes`` (host int64 per-group row counts, a factorization by-product)
    lets ``size`` skip the histogram kernel and gives int ``count``/``mean``
    their denominators for free.
    """
    if agg not in SEGMENT_AGGS:
        raise ValueError(f"groupby aggregation {agg!r} is not ported")
    seg = _Segments(codes, num_groups, sizes)
    if agg == "size":
        if sizes is not None:
            return [seg.sizes()]
        return [bincount(codes, num_groups)]
    ns = num_groups + 1
    out = []
    for c in value_cols:
        is_f = c.dtype.is_floating_point
        if agg in ("min", "max"):
            r = _segment_extreme(agg, c, codes, ns)
        elif agg == "count":
            r = seg.valid_count(c) if is_f else seg.sizes()
        else:
            x = torch.where(torch.isnan(c), 0, c) if is_f else c
            s = seg.segment_sum(x)
            if agg == "sum":
                r = s
            elif is_f:
                # divide in the sum's dtype: float32 means stay float32 (pandas)
                r = s / seg.valid_count(c).to(s.dtype)
            else:
                r = s[:num_groups].to(torch.float64) / seg.sizes().to(torch.float64)
        out.append(r[:num_groups])
    return out


def groupby_first_position(codes: torch.Tensor, num_groups: int) -> torch.Tensor:
    """The first row position of each group (pandas' order of first
    appearance); rows with the overflow code ``num_groups`` are dropped."""
    n = codes.shape[0]
    first = torch.full((num_groups + 1,), n, dtype=torch.int64, device=codes.device)
    rows = torch.arange(n, dtype=torch.int64, device=codes.device)
    first.scatter_reduce_(0, codes, rows, "amin", include_self=True)
    return first[:num_groups]
