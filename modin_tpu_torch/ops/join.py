"""Device sort-merge join.

The port's counterpart of ``modin_tpu/ops/join.py``.  The join runs as a few
torch library operations on the device, as the JAX package's runs as XLA
programs (no Pallas kernel sits under either):

1. stable-sort the right keys (keeps pandas' original order within ties);
2. binary-search every left key against the sorted right keys (lo/hi
   bounds, ``torch.searchsorted`` left and right);
3. one host sync for the output row counts (a data-dependent shape);
4. expand the matches with a searchsorted over the running emit counts and
   gather through the sort permutation.

Matches pandas ``merge`` row order for ``sort=False``: left order, and
right-side ties in right's original order.  Float keys use an IEEE
total-order int mapping so pandas' merge equality holds exactly (-0.0 ==
0.0; every NaN key matches every other NaN key).  Counts and positions are
int64 throughout: an expansion past 2^31 output rows stays exact.

The JAX package's ``merge_positions`` picks between this local sort-merge
and a shuffle across devices; the port has one device and calls
:func:`sort_merge_positions` directly.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from modin_tpu_torch.ops.structural import float_total_order
from modin_tpu_torch.parallel.engine import materialize as _engine_materialize


def _as_int64_key(key: torch.Tensor) -> torch.Tensor:
    """An int64 key with the same equalities and order: total-order bits
    for floats, a widening cast for ints."""
    if key.dtype.is_floating_point:
        return float_total_order(key)
    return key.to(torch.int64)


def _rank_pair(lv: torch.Tensor, rv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both sides' ranks in the sorted union: equal values get equal ranks,
    order is kept."""
    s = torch.sort(torch.cat([lv, rv])).values
    return (
        torch.searchsorted(s, lv, side="left"),
        torch.searchsorted(s, rv, side="left"),
    )


def composite_key_codes(
    left_keys: Sequence[torch.Tensor], right_keys: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(left_code, right_code): int64 tensors that compare equal exactly when
    the key tuples compare equal under pandas merge semantics.

    Per level, both sides' keys rank against the sorted concatenation of
    the two sides; the running composite re-ranks after each fold, so the
    code stays below |L| + |R| and the product never overflows int64.
    """
    total = left_keys[0].shape[0] + right_keys[0].shape[0]
    lc = rc = None
    for lv, rv in zip(left_keys, right_keys):
        l_i, r_i = _rank_pair(_as_int64_key(lv), _as_int64_key(rv))
        if lc is None:
            lc, rc = l_i, r_i
        else:
            lc, rc = _rank_pair(lc * total + l_i, rc * total + r_i)
    return lc, rc


def _match_bounds(left_key: torch.Tensor, right_key: torch.Tensor):
    """(perm, lo, counts, total_inner, total_left) of every left key against
    the stably sorted right keys; the totals stay on the device."""
    left_key, right_key = _as_int64_key(left_key), _as_int64_key(right_key)
    rs, perm = torch.sort(right_key, stable=True)
    lo = torch.searchsorted(rs, left_key, side="left")
    hi = torch.searchsorted(rs, left_key, side="right")
    counts = hi - lo
    total_inner = counts.sum()
    total_left = counts.clamp(min=1).sum()
    return perm, lo, counts, total_inner, total_left


def _expand(
    perm: torch.Tensor, lo: torch.Tensor, counts: torch.Tensor, n_out: int, how_left: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(left_pos, right_pos) of the ``n_out`` output rows; ``right_pos`` is
    -1 for a left-join miss."""
    emit = counts.clamp(min=1) if how_left else counts
    ends = torch.cumsum(emit, 0)
    out_pos = torch.arange(n_out, dtype=torch.int64, device=counts.device)
    # which left row produced output row j
    left_pos = torch.searchsorted(ends, out_pos, side="right")
    starts = ends - emit
    within = out_pos - starts[left_pos]
    # a miss sits at lo, which may be one past the last right row
    sorted_right_pos = (lo[left_pos] + within).clamp(0, perm.shape[0] - 1)
    right_pos = perm[sorted_right_pos]
    if how_left:
        right_pos = torch.where(counts[left_pos] > 0, right_pos, -1)
    return left_pos, right_pos


def sort_merge_positions(
    left_key: torch.Tensor,
    right_key: torch.Tensor,
    n_left: int,
    n_right: int,
    how: str = "inner",
) -> Tuple[torch.Tensor, torch.Tensor, int, bool]:
    """(left_positions, right_positions, n_out, has_miss) of the joined rows.

    ``how`` is ``"inner"`` or ``"left"``; ``right_positions == -1`` marks a
    left-join miss.  Exactly one host sync (the inner and left output
    counts, from which ``has_miss`` follows).
    """
    if how not in ("inner", "left"):
        raise ValueError(f"sort_merge_positions joins inner or left, not {how!r}")
    if left_key.shape[0] != n_left or right_key.shape[0] != n_right:
        raise ValueError("key lengths differ from n_left/n_right")
    perm, lo, counts, total_inner, total_left = _match_bounds(left_key, right_key)
    inner_count, left_count = (
        int(v) for v in _engine_materialize(torch.stack([total_inner, total_left]))
    )
    n_out = left_count if how == "left" else inner_count
    has_miss = how == "left" and left_count > inner_count
    if n_out == 0:
        empty = torch.empty(0, dtype=torch.int64, device=left_key.device)
        return empty, empty, 0, False
    left_pos, right_pos = _expand(perm, lo, counts, n_out, how == "left")
    return left_pos, right_pos, n_out, has_miss


def right_only_positions(right_pos: torch.Tensor, n_right: int) -> Tuple[torch.Tensor, int]:
    """(positions, count) of right rows missing from a left-join output, in
    right order (pandas' outer-merge appendix order)."""
    hit = right_pos[right_pos >= 0]
    matched = torch.zeros(n_right, dtype=torch.bool, device=right_pos.device)
    matched[hit] = True
    positions = torch.nonzero(~matched).flatten()
    return positions, int(positions.shape[0])


def _null_sentinel(dtype: torch.dtype):
    if dtype == torch.bool:
        return False
    return torch.iinfo(dtype).min


def gather_right_columns(cols: Sequence[torch.Tensor], positions: torch.Tensor) -> List[torch.Tensor]:
    """Gather right columns for the join output; position -1 gives NaN for a
    float column and the dtype's minimum (int64's is the NaT sentinel) for
    an int one, which the caller promotes where pandas does."""
    if not cols:
        return []
    found = positions >= 0
    safe = torch.where(found, positions, 0)
    out = []
    for c in cols:
        vals = torch.index_select(c, 0, safe)
        null = float("nan") if c.dtype.is_floating_point else _null_sentinel(c.dtype)
        out.append(torch.where(found, vals, null))
    return out
