"""Device sort: the stable multi-key permutation behind ``sort_values``, and
the sorted representation behind the sort-shaped reductions.

The port's counterpart of ``modin_tpu/ops/sort.py::lexsort_permutation`` and
``sorted_valid``/``sorted_valid_columns``.
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

from modin_tpu_torch.ops.structural import float_total_order

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
    if c.shape[0] != n:
        raise ValueError(f"column of {c.shape[0]} rows for {n} rows")
    if c.dtype == torch.bool:
        c = c.to(torch.int8)  # 0/1 round-trips every caller
    if c.dtype.is_floating_point:
        nanm = torch.isnan(c)
        x = torch.where(nanm, float("inf"), c)
        n_valid = n - nanm.sum()
    else:
        x = c
        n_valid = torch.tensor(n, dtype=torch.int64, device=c.device)
    return torch.sort(x).values, n_valid


def sorted_valid_columns(arrays: List[torch.Tensor], n: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """One (sorted values, n_valid) pair per column; callers cache the
    pairs on their columns through ``ops/sorted_cache.attach``."""
    return [sorted_valid(c, int(n)) for c in arrays]
