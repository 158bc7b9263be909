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
independent of order); float sums, means, variances and products sort the
codes once (stable) and reduce each contiguous segment, so the result
repeats bit for bit; min, max, any, all, first and last do not depend on
order.  An int or bool column's mean adds in float64, as pandas does (an
int64 sum would wrap).  Where the route gate says so
(:func:`takes_groupagg`), sum, mean, prod, min, max and a float column's
count run instead as one launch of the ``groupagg`` kernel over all the
value columns (the codes as its slots), which folds in a fixed order too.

Beyond the segment aggregations (``SEGMENT_AGGS``): the order aggregations
(``ORDER_AGGS``: median/quantile, nunique, first/last) sort each value
column within its groups (``lexsort_permutation`` by code, then value); the
row-shaped ones gather a group's aggregate back to its rows
(``groupby_broadcast``, for ``transform``), number the rows within their
group (``groupby_cumcount``) or run a segmented scan over the rows sorted by
code (``groupby_cumulative``: the scan kernel's ``seg_*`` modes, which
restart where the code changes).  ``factorize_keys_cached`` keeps the last
factorizations, so ``agg([...])``, ``describe`` and ``transform`` factorize
once.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from modin_tpu_torch.config import GroupbyRangeLimit
from modin_tpu_torch.ops.cuda.groupby_kernels import bincount
from modin_tpu_torch.ops.cuda.scan_kernels import scan
from modin_tpu_torch.ops.elementwise import CUM_NEUTRAL, CUM_SCAN_MODE
from modin_tpu_torch.ops.sort import lexsort_permutation
from modin_tpu_torch.parallel.engine import materialize as _engine_materialize
from modin_tpu_torch.utils import numpy_dtype

# aggregations expressible as segment reductions
SEGMENT_AGGS = frozenset(
    ["sum", "count", "mean", "min", "max", "prod", "size", "var", "std", "any", "all", "sem"]
)

# order-statistic aggregations: a sort within each group
ORDER_AGGS = frozenset(["median", "quantile", "nunique", "first", "last"])

# row-shaped cumulative aggregations (a segmented scan)
CUM_AGGS = frozenset(["cumsum", "cumprod", "cummax", "cummin"])


# rows a float segment sum adds serially before it adds the partial sums
_SUM_BLOCK = 1024


class _TooManyGroups(Exception):
    pass


_FACTORIZE_CACHE: List[Tuple[tuple, List[torch.Tensor], tuple]] = []
_FACTORIZE_CACHE_MAX = 8


def clear_factorize_cache() -> None:
    """Drop every kept factorization (timings of the cold path, tests)."""
    _FACTORIZE_CACHE.clear()


def factorize_keys_cached(
    key_cols: List[torch.Tensor], n: int, dropna: bool = True
) -> Tuple[torch.Tensor, int, List[np.ndarray], Optional[np.ndarray]]:
    """:func:`factorize_keys`, kept for the last few key sets: key tensors
    of the same identity (the entry holds them, so an identity cannot be
    reused while it is kept) hit."""
    cache_key = (tuple(id(k) for k in key_cols), int(n), bool(dropna))
    for entry_key, _refs, result in _FACTORIZE_CACHE:
        if entry_key == cache_key:
            return result
    result = factorize_keys(key_cols, n, dropna)
    _FACTORIZE_CACHE.append((cache_key, list(key_cols), result))
    if len(_FACTORIZE_CACHE) > _FACTORIZE_CACHE_MAX:
        _FACTORIZE_CACHE.pop(0)
    return result


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
        self._blocks = None

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

    def order(self) -> torch.Tensor:
        """The stable permutation that sorts the rows by code."""
        if self._order is None:
            self._order = torch.argsort(self.codes, stable=True)
        return self._order

    def blocks(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(block lengths, blocks per code): each code's rows, in code
        order, cut into blocks of ``_SUM_BLOCK`` rows (a code without rows
        keeps one empty block)."""
        if self._blocks is None:
            lengths = self.lengths()
            per_code = torch.clamp(torch.div(lengths + _SUM_BLOCK - 1, _SUM_BLOCK, rounding_mode="floor"), min=1)
            total = int(_engine_materialize(per_code.sum()))
            block_lengths = torch.full((total,), _SUM_BLOCK, dtype=torch.int64, device=lengths.device)
            block_lengths[torch.cumsum(per_code, 0) - 1] = lengths - (per_code - 1) * _SUM_BLOCK
            self._blocks = (block_lengths, per_code)
        return self._blocks

    def segment_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Per-code sum of ``x`` over [num_groups + 1] codes.  Float sums
        add each block of a code's rows in row order, then the block sums
        in order: the rounding grows with the block size and the block
        count, not with the group's length (a serial sum over a group of
        1e5 two-valued terms drifts past rtol 1e-12 of pandas')."""
        ns = self.num_groups + 1
        if not x.dtype.is_floating_point:
            out = torch.zeros(ns, dtype=x.dtype, device=x.device)
            return out.index_add_(0, self.codes, x)
        block_lengths, per_code = self.blocks()
        partial = torch.segment_reduce(x[self.order()], "sum", lengths=block_lengths, unsafe=True)
        return torch.segment_reduce(partial, "sum", lengths=per_code, unsafe=True)

    def segment_prod(self, x: torch.Tensor) -> torch.Tensor:
        """Per-code product of ``x``: int products wrap and are exact in any
        order; float products reduce the code-sorted segments in order."""
        ns = self.num_groups + 1
        if not x.dtype.is_floating_point:
            out = torch.ones(ns, dtype=x.dtype, device=x.device)
            return out.scatter_reduce_(0, self.codes, x, "prod", include_self=True)
        return torch.segment_reduce(
            x[self.order()], "prod", lengths=self.lengths(), unsafe=True
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


def _segment_truth(agg: str, c: torch.Tensor, codes: torch.Tensor, ns: int) -> torch.Tensor:
    """Per-code any/all: NaN counts as False for any and True for all."""
    if c.dtype.is_floating_point:
        truthy = torch.where(torch.isnan(c), agg == "all", c != 0)
    else:
        truthy = c if c.dtype == torch.bool else c != 0
    init = 1 if agg == "all" else 0
    out = torch.full((ns,), init, dtype=torch.int32, device=c.device)
    out.scatter_reduce_(0, codes, truthy.to(torch.int32), "amin" if agg == "all" else "amax", include_self=True)
    return out.to(torch.bool)


def groupby_reduce(
    agg: str,
    value_cols: List[torch.Tensor],
    codes: torch.Tensor,
    num_groups: int,
    n: int,
    sizes: Optional[np.ndarray] = None,
    ddof: int = 1,
) -> List[torch.Tensor]:
    """Aggregate value columns by group codes; returns device tensors of
    length ``num_groups`` (the overflow bucket is sliced off).

    ``sizes`` (host int64 per-group row counts, a factorization by-product)
    lets ``size`` skip the histogram kernel and gives int ``count``/``mean``
    their denominators for free.  var/std/sem are the two-pass centred
    form: the group mean gathered back to each row, then the segment sum
    of squared deviations (no E[x^2] - E[x]^2 cancellation).
    """
    if agg not in SEGMENT_AGGS:
        raise ValueError(f"groupby aggregation {agg!r} is not ported")
    seg = _Segments(codes, num_groups, sizes)
    if agg == "size":
        if sizes is not None:
            return [seg.sizes()]
        return [bincount(codes, num_groups)]
    launched = _groupagg_columns(agg, value_cols, codes, num_groups, n)
    ns = num_groups + 1
    out = []
    for c, r in zip(value_cols, launched):
        if r is not None:
            out.append(r)
            continue
        is_f = c.dtype.is_floating_point
        if agg in ("min", "max"):
            r = _segment_extreme(agg, c, codes, ns)
        elif agg == "count":
            r = seg.valid_count(c) if is_f else seg.sizes()
        elif agg in ("any", "all"):
            r = _segment_truth(agg, c, codes, ns)
        elif agg == "prod":
            r = seg.segment_prod(torch.where(torch.isnan(c), 1, c) if is_f else c.to(torch.int64))
        elif agg in ("var", "std", "sem"):
            r = _segment_var(agg, c, seg, ddof)
        else:
            if is_f:
                s = seg.segment_sum(torch.where(torch.isnan(c), 0, c))
                # divide in the sum's dtype: float32 means stay float32 (pandas)
                r = s if agg == "sum" else s / seg.valid_count(c).to(s.dtype)
            elif agg == "sum":
                # ints add in int64 (an unsigned column's uint64 sum has the same bits)
                r = seg.segment_sum(c.to(torch.int64))
            else:
                # an int mean adds in float64, as pandas does: an int64 sum
                # would wrap where a group's sum passes 2^63
                s = seg.segment_sum(c.to(torch.float64))
                r = s[:num_groups] / seg.sizes().to(torch.float64)
        r = r[:num_groups]
        if agg in ("sum", "prod") and not is_f and c.dtype != torch.bool:
            r = int_sum_result(r, c.dtype)
        out.append(r)
    return out


def takes_groupagg(agg: str, dtypes: List[torch.dtype], num_groups: int, n: int) -> bool:
    """Whether ``groupby_reduce`` runs ``agg`` of columns of ``dtypes`` over
    ``num_groups`` groups of ``n`` rows as ``groupagg`` launches (32
    columns a launch): a segment aggregation the kernel computes
    (``FUSED_GROUPBY_AGGS``; ``count`` only of float columns, an int
    column's count being its group's size), dtypes it takes, at most
    ``FUSED_MAX_GROUPS`` groups, and the route gate's yes
    (``ops/router.decide_compile`` and ``ops/route.decide_groupby``, the
    gate of the fused groupby too)."""
    from modin_tpu_torch.ops.cuda.fused_program import DTYPE_CODES
    from modin_tpu_torch.ops.route import decide_groupby
    from modin_tpu_torch.ops.router import decide_compile

    if agg not in FUSED_GROUPBY_AGGS or not dtypes or not 0 < num_groups <= FUSED_MAX_GROUPS:
        return False
    if any(d not in DTYPE_CODES for d in dtypes):
        return False
    if agg == "count":
        dtypes = [d for d in dtypes if d.is_floating_point]
        if not dtypes:
            return False
    any_float = any(d.is_floating_point for d in dtypes)
    return decide_compile(None, n) == "fused" and decide_groupby(n, num_groups + 1, agg, len(dtypes), any_float)


def _groupagg_columns(
    agg: str, value_cols: List[torch.Tensor], codes: torch.Tensor, num_groups: int, n: int
) -> List[Optional[Any]]:
    """Each value column's ``groupby_reduce`` result from ``groupagg``
    launches over the codes (the overflow code ``num_groups`` dropped), or
    None for a column the staged segment path computes (all of them where
    :func:`takes_groupagg` says no; an int column's ``count``).  The
    results take the staged path's dtypes: a float sum, prod or mean in the
    column's dtype, an int sum or prod as :func:`int_sum_result` gives it
    (a bool's as int64), min/max in the column's dtype, counts int64."""
    from modin_tpu_torch.ops.cuda import groupagg_kernels

    out: List[Optional[Any]] = [None] * len(value_cols)
    if not takes_groupagg(agg, [c.dtype for c in value_cols], num_groups, n):
        return out
    todo = [i for i, c in enumerate(value_cols) if agg != "count" or c.dtype.is_floating_point]
    for at in range(0, len(todo), groupagg_kernels.MAX_COLS):
        part = todo[at: at + groupagg_kernels.MAX_COLS]
        cols = [value_cols[i] for i in part]
        table = groupagg_kernels.groupagg(agg, codes, cols, num_groups + 1)
        _sizes, values, counts = groupagg_kernels.finish(agg, table, [c.dtype for c in cols])
        for i, c, v, nn in zip(part, cols, values, counts):
            v, is_f = v[:num_groups], c.dtype.is_floating_point
            if agg == "count":
                r = nn[:num_groups]
            elif agg in ("min", "max") or (is_f and agg != "mean"):
                r = v.to(c.dtype)
            elif agg == "mean":
                r = v.to(torch.float32) if c.dtype == torch.float32 else v
            elif c.dtype == torch.bool:
                r = v
            else:
                r = int_sum_result(v, c.dtype)
            out[i] = r
    return out


def int_sum_result(r: torch.Tensor, dtype: torch.dtype) -> Any:
    """pandas' dtype of a grouped int sum or product ``r`` (int64 bits)
    of a column of ``dtype``: the column's own dtype where every group's
    result fits it, else int64 (uint64 for an unsigned column, which comes
    back as a host numpy array: the port keeps no uint64 device column)."""
    if dtype in (torch.int64, torch.bool):
        return r
    info = torch.iinfo(dtype)
    if r.numel() == 0 or bool(_engine_materialize(((r >= info.min) & (r <= info.max)).all())):
        return r.to(dtype)
    if info.min < 0:
        return r
    return np.asarray(_engine_materialize(r)).view(np.uint64)


def widen_blocks(results: List[Any], dtypes: List[torch.dtype], groups: List[List[int]]) -> List[Any]:
    """pandas' block-wise dtypes of grouped int sums, products and
    cumulative sums and products: ``groups`` lists the results whose
    columns (of ``dtypes``) shared a pandas block; where any of a group
    widened past its narrow dtype (:func:`int_sum_result`), every member
    widens, to int64, or to uint64 for unsigned columns (host numpy)."""
    results = list(results)
    for group in groups:
        widened = [
            isinstance(results[j], np.ndarray) or results[j].dtype != dtypes[j] for j in group
        ]
        if not any(widened) or all(widened):
            continue
        for j, w in zip(group, widened):
            if w:
                continue
            if torch.iinfo(dtypes[j]).min < 0:
                results[j] = results[j].to(torch.int64)
            else:
                results[j] = np.asarray(_engine_materialize(results[j])).astype(np.uint64)
    return results


def groupby_first_position(codes: torch.Tensor, num_groups: int) -> torch.Tensor:
    """The first row position of each group (pandas' order of first
    appearance); rows with the overflow code ``num_groups`` are dropped."""
    n = codes.shape[0]
    first = torch.full((num_groups + 1,), n, dtype=torch.int64, device=codes.device)
    rows = torch.arange(n, dtype=torch.int64, device=codes.device)
    first.scatter_reduce_(0, codes, rows, "amin", include_self=True)
    return first[:num_groups]


def _segment_var(agg: str, c: torch.Tensor, seg: _Segments, ddof: int) -> torch.Tensor:
    """Per-code var/std/sem over [num_groups + 1] codes: float64, float32
    for float32 values (pandas' dtypes)."""
    is_f = c.dtype.is_floating_point
    x = (torch.where(torch.isnan(c), 0, c) if is_f else c).to(torch.float64)
    if is_f:
        valid = ~torch.isnan(c)
        ncnt = seg.valid_count(c)
    else:
        valid = None
        ncnt = seg.lengths()
    mean = seg.segment_sum(x) / ncnt.to(torch.float64)
    d = x - mean[seg.codes]
    if valid is not None:
        d = torch.where(valid, d, 0.0)
    s2 = seg.segment_sum(d * d)
    var = s2 / torch.clamp(ncnt - ddof, min=1)
    var = torch.where(ncnt - ddof > 0, var, float("nan"))
    if agg == "std":
        var = torch.sqrt(var)
    elif agg == "sem":
        var = torch.sqrt(var / ncnt)
    return var.to(c.dtype) if c.dtype == torch.float32 else var


def _sorted_within_groups(c: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts rows by code, then by value (NaN last)."""
    return lexsort_permutation([codes, c], codes.shape[0], [True, True])


def groupby_quantile(
    value_cols: List[torch.Tensor],
    codes: torch.Tensor,
    num_groups: int,
    n: int,
    q: float = 0.5,
    interpolation: str = "linear",
    preserve_float_dtype: bool = False,
) -> List[torch.Tensor]:
    """Per-group quantile of each column: sort within the groups and gather
    at the quantile ranks.  lower/higher/nearest keep an int column's
    dtype; ``preserve_float_dtype`` (median) keeps float32."""
    ns = num_groups + 1
    total = bincount(codes, ns)
    g_start = (torch.cumsum(total, 0) - total)[:num_groups]
    max_pos = max(n - 1, 0)
    out = []
    for c in value_cols:
        keep_int = interpolation in ("lower", "higher", "nearest") and not c.dtype.is_floating_point
        x = c if keep_int else c.to(torch.float64)
        xs = x[_sorted_within_groups(x, codes)]
        if x.dtype.is_floating_point:
            vcnt = torch.zeros(ns, dtype=torch.int64, device=c.device)
            vcnt.index_add_(0, codes, (~torch.isnan(x)).to(torch.int64))
        else:
            vcnt = total
        vcnt = vcnt[:num_groups]
        target = q * (vcnt.to(torch.float64) - 1.0)
        lo = torch.floor(target).to(torch.int64)
        hi = torch.ceil(target).to(torch.int64)
        v_lo = xs[torch.clamp(g_start + lo, 0, max_pos)]
        v_hi = xs[torch.clamp(g_start + hi, 0, max_pos)]
        if interpolation == "linear":
            r = v_lo + (v_hi - v_lo) * (target - lo.to(torch.float64))
        elif interpolation == "lower":
            r = v_lo
        elif interpolation == "higher":
            r = v_hi
        elif interpolation == "midpoint":
            r = (v_lo + v_hi) * 0.5
        else:  # nearest: numpy rounds the virtual rank half to even
            r = xs[torch.clamp(g_start + torch.round(target).to(torch.int64), 0, max_pos)]
        if not keep_int:
            r = torch.where(vcnt == 0, float("nan"), r)
            if preserve_float_dtype and c.dtype.is_floating_point:
                # pandas' groupby median keeps float32; quantile widens
                r = r.to(c.dtype)
        out.append(r)
    return out


def groupby_nunique(
    value_cols: List[torch.Tensor], codes: torch.Tensor, num_groups: int, n: int, dropna: bool = True
) -> List[torch.Tensor]:
    """Per-group count of distinct values: sort within the groups and count
    the heads of runs (NaN counted once when not ``dropna``)."""
    ns = num_groups + 1
    out = []
    for c in value_cols:
        order = _sorted_within_groups(c, codes)
        xs, cs = c[order], codes[order]
        new = torch.ones(xs.shape[0], dtype=torch.bool, device=c.device)
        if xs.shape[0] > 1:
            new[1:] = (cs[1:] != cs[:-1]) | (xs[1:] != xs[:-1])
        if c.dtype.is_floating_point:
            new = new & ~torch.isnan(xs)
        cnt = torch.zeros(ns, dtype=torch.int64, device=c.device)
        cnt.index_add_(0, cs, new.to(torch.int64))
        if not dropna and c.dtype.is_floating_point:
            has_nan = torch.zeros(ns, dtype=torch.int64, device=c.device)
            has_nan.scatter_reduce_(0, codes, torch.isnan(c).to(torch.int64), "amax", include_self=True)
            cnt = cnt + has_nan
        out.append(cnt[:num_groups])
    return out


def groupby_first_last(
    agg: str, value_cols: List[torch.Tensor], codes: torch.Tensor, num_groups: int, n: int
) -> List[torch.Tensor]:
    """Per-group first or last non-NaN value in row order, read through the
    stable sort by code (shared by every column; no atomics): an int
    column's group starts or ends there, a float column's first or last
    valid row is a segment min or max of the sorted positions."""
    seg = _Segments(codes, num_groups, None)
    order = seg.order()
    lengths = seg.lengths()
    starts = (torch.cumsum(lengths, 0) - lengths)[:num_groups]
    sizes = lengths[:num_groups]
    rank = None
    out = []
    for c in value_cols:
        if not c.dtype.is_floating_point:
            # every group of the factorization has rows
            pos = starts if agg == "first" else starts + sizes - 1
            out.append(c[order[pos]])
            continue
        if rank is None:
            rank = torch.arange(n, dtype=torch.float64, device=codes.device)
        valid = ~torch.isnan(c)[order]
        missing = float("inf") if agg == "first" else float("-inf")
        key = torch.where(valid, rank, missing)
        r = torch.segment_reduce(key, "min" if agg == "first" else "max", lengths=lengths, unsafe=True)
        r = r[:num_groups]
        has = torch.isfinite(r)
        idx = order[torch.where(has, r, 0.0).to(torch.int64)]
        out.append(torch.where(has, c[idx], float("nan")))
    return out


def groupby_broadcast(agg_cols: List[torch.Tensor], codes: torch.Tensor) -> List[torch.Tensor]:
    """Row-shaped tensors where row i holds its group's aggregate."""
    return [a[torch.clamp(codes, max=a.shape[0] - 1)] for a in agg_cols]




def groupby_cumulative(op: str, value_cols: List[torch.Tensor], codes: torch.Tensor) -> List[Any]:
    """Row-shaped grouped cumsum/cumprod/cummax/cummin: the rows sorted by
    code (stable), one segmented scan that restarts at each group, the
    result scattered back to row order.  A NaN keeps its place and does
    not poison later rows (pandas' skipna).  Floats scan as float64 and
    keep their dtype; ints scan as int64 and take pandas' result dtype
    (:func:`cumulative_int_result`): a cumsum or cumprod of a narrow int
    that passes its range widens instead of wrapping, so a result can be
    the host numpy array of a uint64 column, which the port keeps off the
    device."""
    if op not in CUM_AGGS:
        raise ValueError(f"grouped cumulative {op!r} is not ported")
    order = torch.argsort(codes, stable=True)
    cs = codes[order]
    out = []
    for c in value_cols:
        x = c[order]
        if c.dtype.is_floating_point:
            nan = torch.isnan(x)
            filled = torch.where(nan, CUM_NEUTRAL[op], x).to(torch.float64)
            y = scan(CUM_SCAN_MODE[op], filled, cs)
            if op == "cumsum":
                y = _poison_after_inf(y, x, cs)
            y = torch.where(nan, float("nan"), y).to(c.dtype)
        else:
            y = scan(CUM_SCAN_MODE[op], x.to(torch.int64), cs)
        r = torch.empty_like(y)
        r[order] = y
        out.append(r if c.dtype.is_floating_point else cumulative_int_result(op, r, c.dtype))
    return out


def cumulative_int_result(op: str, r: torch.Tensor, dtype: torch.dtype) -> Any:
    """pandas' result of a grouped cumulative ``op`` whose int64 scan is
    ``r``, for a column of int ``dtype``: cummax/cummin keep the dtype; a
    cumsum or cumprod keeps it where every value fits, else widens to int64
    (uint64 for an unsigned column), as a grouped sum does
    (:func:`int_sum_result`)."""
    if op in ("cummax", "cummin"):
        return r.to(dtype)
    return int_sum_result(r, dtype)


def _poison_after_inf(y: torch.Tensor, x: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    """pandas' grouped cumsum is a compensated (Kahan) sum: after a +/-inf
    its compensation is NaN, so every later row of the group is NaN (the
    inf's own row keeps the inf).  ``x`` and the sorted codes ``cs`` are in
    the scan's order."""
    inf = torch.isinf(x)
    if not bool(inf.any()):
        return y
    seen = scan("seg_max", inf.to(torch.int64), cs)
    before = torch.zeros_like(seen)
    before[1:] = torch.where(cs[1:] == cs[:-1], seen[:-1], 0)
    return torch.where(before > 0, float("nan"), y)


def groupby_cumcount(
    codes: torch.Tensor, num_groups: int, sizes: Optional[np.ndarray] = None, ascending: bool = True
) -> torch.Tensor:
    """Each row's position within its group (int64), counted from the
    group's first row, or from its last when not ``ascending``."""
    n = codes.shape[0]
    seg = _Segments(codes, num_groups, sizes)
    lengths = seg.lengths()
    starts = torch.cumsum(lengths, 0) - lengths
    order = seg.order()
    cs = codes[order]
    pos = torch.arange(n, dtype=torch.int64, device=codes.device) - starts[cs]
    if not ascending:
        pos = lengths[cs] - 1 - pos
    r = torch.empty_like(pos)
    r[order] = pos
    return r


# ---------------------------------------------------------------------- #
# Whole-plan fused groupby (bounded-range int/bool keys)
# ---------------------------------------------------------------------- #

# aggregations the fused groupby computes (pandas' rules: NaN values always
# skipped; an all-NaN float group gives sum 0, count 0, min/max/mean NaN)
FUSED_GROUPBY_AGGS = frozenset({"sum", "prod", "count", "mean", "min", "max"})

# widest group table of a fused groupby (pow2-padded); wider key ranges
# decline to the staged factorize path
FUSED_MAX_GROUPS = 1 << 16


def fused_groups_bucket(width: int) -> int:
    """Pow2-padded group-table size for a key range of ``width`` values (at
    least 8), as the reference pads it."""
    return 1 << max(int(width - 1).bit_length(), 3)


def _key_int64(key_expr: Any) -> Any:
    """A fused groupby's key as a deferred int64 column."""
    from modin_tpu_torch.ops.lazy import lazy_op

    if key_expr.dtype == torch.int64:
        return key_expr
    return lazy_op("astype", key_expr, static=(("dtype", "int64"),))


def fused_probe_program(key_expr: Any, keep: Optional[Any]) -> Tuple[List[Any], Tuple]:
    """The roots and tail of the probe's one fused launch: the min of the
    key (as int64) and of its bitwise complement (whose min is the
    complement of the key's max, exactly, over all of int64), masked by
    ``keep`` when there is one (the kept-row count is then one more
    output)."""
    from modin_tpu_torch.ops.lazy import lazy_op

    k64 = _key_int64(key_expr)
    roots = [k64, lazy_op("invert", k64)]
    if keep is None:
        return roots, ("reduce", "min", True, 1, False)
    return roots + [keep], ("reduce", "min", True, 1, False, True)


def fused_group_probe(key_expr: Any, keep: Optional[Any], n: int) -> Tuple[int, int, int]:
    """(key min, key max, kept rows) of the key column over the rows where
    ``keep`` (None: every row) is true, in one fused launch: the key's chain
    and the filter's mask run as the masked tails of one program
    (:func:`fused_probe_program`).  Keys are int, uint8 or bool (the caller
    gates)."""
    from modin_tpu_torch.ops.lazy import run_fused

    first, _ = run_fused(*fused_probe_program(key_expr, keep))
    host = _engine_materialize(first)
    kept = n if keep is None else int(host[-1][1])
    return int(host[0][0]), int(~host[1][0]), int(kept)


def fused_slot_expr(key_expr: Any, keep: Optional[Any], kmin: int, n_buckets: int) -> Any:
    """The deferred int32 slot column of a fused groupby: ``key - kmin``
    where ``keep`` holds, the overflow slot ``n_buckets`` elsewhere."""
    from modin_tpu_torch.ops.lazy import lazy_op

    slot = lazy_op("sub", _key_int64(key_expr), int(kmin))
    if keep is not None:
        slot = lazy_op("where", keep, slot, int(n_buckets))
    return lazy_op("astype", slot, static=(("dtype", "int32"),))


def fused_group_agg(
    agg: str,
    key_expr: Any,
    cols: List[Any],
    keep: Optional[Any],
    n: int,
    kmin: int,
    n_buckets: int,
    donate_cols: Optional[List[Any]] = None,
) -> Tuple[np.ndarray, List[np.ndarray], List[np.ndarray]]:
    """The masked grouped aggregation of a fused groupby, in two launches:
    one of the fused kernel that writes the slot column (``key - kmin``
    where ``keep`` holds, the overflow slot ``n_buckets`` elsewhere, as
    int32) and every value column that is still an expression, then one of
    the ``groupagg`` kernel over all the columns.  Returns host arrays
    ``(sizes[n_buckets + 1], per-column aggregates, per-column non-NaN
    counts)`` (aggregates int64, or float64 for a float column and for a
    mean): the caller keeps the slots with a size and applies pandas' dtype
    rules (:func:`fused_groupby_dtype`).  ``donate_cols`` (the scan's
    columns proved donation-safe) that the launches read are marked donated
    once the ``groupagg`` launch, their last reader, is enqueued."""
    from modin_tpu_torch.ops.cuda import groupagg_kernels
    from modin_tpu_torch.ops.lazy import materialize_exprs
    from modin_tpu_torch.ops.reductions import donation_map, mark_donated

    if agg not in FUSED_GROUPBY_AGGS:
        raise ValueError(f"fused groupby aggregation {agg!r} is not ported")
    G = int(n_buckets)
    roots = [fused_slot_expr(key_expr, keep, kmin, G)] + list(cols)
    donated = donation_map(roots, donate_cols)
    concrete = materialize_exprs(roots)
    table = groupagg_kernels.groupagg(agg, concrete[0], concrete[1:], G + 1)
    mark_donated(donated)
    sizes, values, counts = groupagg_kernels.finish(agg, table, [c.dtype for c in concrete[1:]])
    host = _engine_materialize([sizes] + values + counts)
    return host[0], host[1: 1 + len(cols)], host[1 + len(cols):]


def fused_groupby_dtype(agg: str, dtype: np.dtype, values: np.ndarray) -> np.dtype:
    """pandas' dtype of a grouped ``agg`` of a column of ``dtype`` given the
    observed groups' ``values`` (int64 bits, or float64): count int64; mean
    float64 (float32 for float32 values); min/max the column's dtype; sum
    and prod the column's dtype where every value fits it, else int64
    (uint64 for unsigned), bool as int64; floats keep their dtype."""
    dtype = np.dtype(dtype)
    if agg == "count":
        return np.dtype(np.int64)
    if agg == "mean":
        return dtype if dtype == np.float32 else np.dtype(np.float64)
    if agg in ("min", "max") or dtype.kind == "f":
        return dtype
    if dtype.kind == "b":
        return np.dtype(np.int64)
    info = np.iinfo(dtype)
    wide = np.dtype(np.uint64 if dtype.kind == "u" else np.int64)
    if dtype.itemsize == 8:
        return wide
    v = values.view(np.int64) if values.dtype != np.int64 else values
    return dtype if ((v >= info.min) & (v <= info.max)).all() else wide
