"""Device sort: the stable multi-key permutation behind ``sort_values``, the
sorted representation behind the sort-shaped reductions, and the top k and
ranks behind ``nlargest``/``nsmallest`` and ``rank``.

The port's counterpart of ``modin_tpu/ops/sort.py::lexsort_permutation``,
``sorted_valid``/``sorted_valid_columns``, ``top_k_positions`` and
``rank_columns``.
Keys are ordered from the least significant to the most, each by one stable
``torch.sort``; a stable pass keeps the order the earlier passes made among
its ties, and the first pass keeps the original row order.  A descending
stable pass keeps ties in their original order too, as pandas' ``nargsort``
does.

Float keys go through ``float_total_order`` so that NaN sorts strictly
beyond +inf and -0.0 ties 0.0; ``na_position`` then places NaN first or
last whatever the direction.  The JAX package also forces its pad rows past
every valid row (``_pad_sentinel``); the port has no pad rows, so that step
is gone.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from modin_tpu_torch.ops.cuda.scan_kernels import scan
from modin_tpu_torch.ops.structural import float_total_order, int64_key

# below the total-order key of every float, -inf included (the JAX
# package's NaN key for "NaN at the low end")
_NAN_LOW = -(1 << 63) + 1


def _order_one(key: torch.Tensor, ascending: bool, na_last: bool) -> torch.Tensor:
    """Stable argsort of one key column with pandas' NaN placement."""
    if key.dtype.is_floating_point:
        t = float_total_order(key)
        nan = torch.isnan(key)
        # total order puts NaN above +inf: last when ascending, first when
        # descending; the low sentinel moves it to the other end
        if ascending != na_last:
            t = torch.where(nan, _NAN_LOW, t)
        key = t
    elif key.dtype == torch.bool:
        key = key.view(torch.uint8)  # torch sorts no bool tensor
    return torch.sort(key, stable=True, descending=not ascending).indices


def lexsort_permutation(
    keys: Sequence[torch.Tensor],
    n: int,
    ascending: Sequence[bool],
    na_position: str = "last",
) -> torch.Tensor:
    """Stable int64 permutation ordering ``n`` rows by ``keys`` (the first
    key most significant)."""
    if na_position not in ("first", "last"):
        raise ValueError(f"invalid na_position: {na_position!r}")
    if len(keys) != len(ascending):
        raise ValueError("one ascending flag per key")
    na_last = na_position == "last"
    perm = None
    for key, asc in zip(reversed(keys), reversed(list(ascending))):
        if key.shape[0] != n:
            raise ValueError(f"sort key of {key.shape[0]} rows for {n} rows")
        kk = key if perm is None else torch.index_select(key, 0, perm)
        order = _order_one(kk, bool(asc), na_last)
        perm = order if perm is None else torch.index_select(perm, 0, order)
    if perm is None:
        raise ValueError("no sort keys")
    return perm


def sorted_valid(c: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sorted values, n_valid): NaN sorts to the tail as +inf, so the first
    ``n_valid`` entries are exactly the non-NaN data, ascending.  ``n_valid``
    is a 0-d int64 tensor on the column's device.

    The shared prefix of every sort-shaped reduction (median, quantile,
    nunique, mode): ``ops/sorted_cache.py`` keeps it per column so that
    consecutive ops on one column pay one sort.
    """
    x, n_valid = sorted_valid_prep(c, n)
    return torch.sort(x, stable=True).values, n_valid


def sorted_valid_prep(c: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values to sort, n_valid) of :func:`sorted_valid`: NaN as +inf and
    not counted, bool as int8.  The sort is stable, so -0.0 and 0.0 keep
    their row order, as the range shuffle's per-shard sorts keep it
    (``ops/spmd.sharded_sorted_valid``): the two representations are equal
    bit for bit."""
    if c.shape[0] != n:
        raise ValueError(f"column of {c.shape[0]} rows for {n} rows")
    if c.dtype == torch.bool:
        c = c.to(torch.int8)  # 0/1 round-trips every caller
    if c.dtype.is_floating_point:
        nanm = torch.isnan(c)
        return torch.where(nanm, float("inf"), c), n - nanm.sum()
    return c, torch.tensor(n, dtype=torch.int64, device=c.device)


def sorted_valid_columns(arrays: List[torch.Tensor], n: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """One (sorted values, n_valid) pair per column; callers cache the
    pairs on their columns through ``ops/sorted_cache.attach``."""
    return [sorted_valid(c, int(n)) for c in arrays]


# above the total-order key of every float, NaN's own included, and above
# every such key after ``bitwise_not``
_NAN_HIGH = (1 << 63) - 1


def top_k_positions(col: torch.Tensor, n: int, k: int, largest: bool) -> torch.Tensor:
    """Row positions of pandas' ``nlargest``/``nsmallest`` with
    ``keep="first"``: the ``min(k, n)`` best non-NaN values, ties (-0.0 and
    0.0 among them) in row order, then NaN rows in row order where k
    exceeds the valid count.  An int64 tensor on the column's device.

    The head of ``sort_values``' stable order with NaN last (ints as int64
    keys: torch sorts no uint64 on CUDA, and ``torch.topk`` orders no
    ties); the JAX package's ``lax.top_k`` over IEEE bit patterns instead
    tells -0.0 below 0.0.
    """
    if col.shape[0] != n:
        raise ValueError(f"column of {col.shape[0]} rows for {n} rows")
    k = max(min(int(k), int(n)), 0)
    key = col if col.dtype.is_floating_point else int64_key(col)
    return _order_one(key, ascending=not largest, na_last=True)[:k]


RANK_METHODS = ("average", "min", "max", "first", "dense")
NA_OPTIONS = ("keep", "top", "bottom")


def _rank_one(c: torch.Tensor, n: int, method: str, ascending: bool, na_option: str,
              pct: bool) -> torch.Tensor:
    nanm = torch.isnan(c) if c.dtype.is_floating_point else None
    key = int64_key(c)
    if not ascending:
        key = torch.bitwise_not(key)  # -key - 1: reverses the order, no overflow
    if nanm is not None:
        # every valid float key lies strictly between the two ends, so NaN
        # rows tie together first ("top") or last
        key = torch.where(nanm, _NAN_LOW if na_option == "top" else _NAN_HIGH, key)
    sk, order = torch.sort(key, stable=True)
    change = sk[1:] != sk[:-1]
    one = torch.ones(1, dtype=torch.bool, device=c.device)
    first = torch.cat([one, change])  # the first row of each tie group
    pos = torch.arange(n, dtype=torch.int64, device=c.device)
    if method in ("average", "min"):
        # each row's first-of-tie position: a running max of the starts
        f_idx = scan("seg_max", torch.where(first, pos, 0))
    if method in ("average", "max"):
        # each row's last-of-tie position: a running min of the ends, from
        # the last row back
        last = torch.cat([change, one])
        l_idx = scan("seg_min", torch.where(last, pos, n - 1), reverse=True)
    if method == "average":
        ranks = (f_idx + l_idx).to(torch.float64) / 2.0 + 1.0
    elif method == "min":
        ranks = f_idx.to(torch.float64) + 1.0
    elif method == "max":
        ranks = l_idx.to(torch.float64) + 1.0
    elif method == "first":
        ranks = pos.to(torch.float64) + 1.0
    else:  # dense: the running count of tie groups
        ranks = scan("seg_add", first.to(torch.int64)).to(torch.float64)
    out = torch.empty_like(ranks)
    out[order] = ranks  # a permutation: every row written once
    if pct:
        counted = None if (nanm is None or na_option != "keep") else ~nanm
        if method == "dense":
            denom = (out if counted is None else torch.where(counted, out, 0.0)).max()
        else:
            denom = torch.tensor(float(n), dtype=torch.float64, device=c.device)
            if counted is not None:
                denom = counted.sum().to(torch.float64)
        out = out / torch.clamp(denom, min=1.0)
    if nanm is not None and na_option == "keep":
        out = torch.where(nanm, float("nan"), out)
    return out


def rank_columns(cols: List[torch.Tensor], n: int, method: str, ascending: bool,
                 na_option: str, pct: bool) -> List[torch.Tensor]:
    """pandas' column ``rank`` with every ``method``, ``na_option``,
    ``ascending`` and ``pct``: float64 ranks, exact.

    One stable sort a column (NaN rows tie together at the end that
    ``na_option`` names); in sorted order, a tie group's first and last
    positions give min/max/average, the running count of groups gives dense
    and the position itself gives first.  The JAX package takes those
    positions with two ``associative_scan(maximum)`` passes and a
    ``cumsum``; here they are the scan kernel's ``seg_max``, reverse
    ``seg_min`` and ``seg_add`` (``ops/cuda/scan_kernels.py``; its plain
    version on the CPU).  The ranks scatter back through the permutation.
    """
    if method not in RANK_METHODS:
        raise ValueError(f"rank method must be one of {RANK_METHODS}, got {method!r}")
    if na_option not in NA_OPTIONS:
        raise ValueError(f"na_option must be one of {NA_OPTIONS}, got {na_option!r}")
    for c in cols:
        if c.shape[0] != n:
            raise ValueError(f"column of {c.shape[0]} rows for {n} rows")
    return [_rank_one(c, int(n), method, bool(ascending), na_option, bool(pct)) for c in cols]
