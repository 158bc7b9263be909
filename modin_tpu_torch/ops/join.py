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

:func:`merge_positions` asks the layout router (``ops/router.
decide_layout``) whether the right side's sort runs through the range
shuffle over the row-shard mesh (``ops/spmd.sharded_merge_positions``) or
here; the shuffle's positions are bit for bit these, and a single shard or
skewed keys fall back here.

:func:`duplicated_mask` (``DataFrame.duplicated``/``drop_duplicates``) folds
one frame's key columns into a row code by the same ranks.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from modin_tpu_torch.ops.structural import int64_key
from modin_tpu_torch.parallel.engine import materialize as _engine_materialize


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
        l_i, r_i = _rank_pair(int64_key(lv), int64_key(rv))
        if lc is None:
            lc, rc = l_i, r_i
        else:
            lc, rc = _rank_pair(lc * total + l_i, rc * total + r_i)
    return lc, rc


def probe_sorted(rs: torch.Tensor, left_key: torch.Tensor):
    """(lo, counts, total_inner, total_left) of every int64 left key against
    the sorted int64 right keys ``rs``; the totals stay on the device."""
    lo = torch.searchsorted(rs, left_key, side="left")
    hi = torch.searchsorted(rs, left_key, side="right")
    counts = hi - lo
    total_inner = counts.sum()
    total_left = counts.clamp(min=1).sum()
    return lo, counts, total_inner, total_left


def _match_bounds(left_key: torch.Tensor, right_key: torch.Tensor):
    """(perm, lo, counts, total_inner, total_left) of every left key against
    the stably sorted right keys."""
    left_key, right_key = int64_key(left_key), int64_key(right_key)
    rs, perm = torch.sort(right_key, stable=True)
    return (perm, *probe_sorted(rs, left_key))


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
    return positions_from_bounds(*_match_bounds(left_key, right_key), how)


def positions_from_bounds(
    perm: torch.Tensor,
    lo: torch.Tensor,
    counts: torch.Tensor,
    total_inner: torch.Tensor,
    total_left: torch.Tensor,
    how: str,
) -> Tuple[torch.Tensor, torch.Tensor, int, bool]:
    """The join's positions from the probe of the sorted right keys (their
    stable sort permutation ``perm``): one host sync for the two counts."""
    inner_count, left_count = (
        int(v) for v in _engine_materialize(torch.stack([total_inner, total_left]))
    )
    n_out = left_count if how == "left" else inner_count
    has_miss = how == "left" and left_count > inner_count
    if n_out == 0:
        empty = torch.empty(0, dtype=torch.int64, device=lo.device)
        return empty, empty, 0, False
    left_pos, right_pos = _expand(perm, lo, counts, n_out, how == "left")
    return left_pos, right_pos, n_out, has_miss


def merge_positions(
    left_key: torch.Tensor,
    right_key: torch.Tensor,
    n_left: int,
    n_right: int,
    how: str = "inner",
) -> Tuple[torch.Tensor, torch.Tensor, int, bool]:
    """:func:`sort_merge_positions`, with the right side's sort through the
    range shuffle where the layout router says "sharded" (the row ids are
    the one payload it moves); the local sort-merge is the fallback for a
    single shard and for skewed keys."""
    from modin_tpu_torch.ops import router

    if router.decide_layout("merge", int(n_right), payload_cols=1) == "sharded":
        from modin_tpu_torch.ops import spmd

        result = spmd.sharded_merge_positions(left_key, right_key, int(n_left), int(n_right), how)
        if result is not None:
            return result
    return sort_merge_positions(left_key, right_key, n_left, n_right, how)


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


def _dense_rank(v: torch.Tensor) -> torch.Tensor:
    """Each value's position among the sorted values (equal values share
    it): an int64 code below ``len(v)`` with the same equalities."""
    return torch.searchsorted(torch.sort(v).values, v, side="left")


def duplicated_mask(cols: Sequence[torch.Tensor], n: int, keep) -> torch.Tensor:
    """pandas' ``duplicated`` over the key columns ``cols`` (``n`` rows): a
    bool tensor that marks every row equal to an earlier one
    (``keep="first"``), to a later one (``"last"``) or to any other
    (``False``).  Floats compare through ``float_total_order``: NaN equals
    NaN and -0.0 equals 0.0, as in pandas.

    Several columns fold into one int64 row code, re-ranked after each
    fold so that ``code * n + rank`` stays below n**2; a stable sort of the
    codes groups equal rows in row order, and the first and last row of
    each group give every ``keep``.
    """
    if keep not in ("first", "last", False):
        raise ValueError(f"keep must be 'first', 'last' or False, got {keep!r}")
    if not cols:
        raise ValueError("duplicated_mask needs key columns")
    for c in cols:
        if c.shape[0] != n:
            raise ValueError(f"key column of {c.shape[0]} rows for {n} rows")
    keys = [int64_key(c) for c in cols]
    code = keys[0]
    if len(keys) > 1:
        code = _dense_rank(code)
        for i, key in enumerate(keys[1:], start=2):
            code = code * n + _dense_rank(key)
            if i < len(keys):
                code = _dense_rank(code)
    sc, order = torch.sort(code, stable=True)
    change = sc[1:] != sc[:-1]
    one = torch.ones(1, dtype=torch.bool, device=code.device)
    first = torch.cat([one, change])
    last = torch.cat([change, one])
    if keep == "first":
        dup_sorted = ~first
    elif keep == "last":
        dup_sorted = ~last
    else:
        dup_sorted = ~(first & last)
    out = torch.empty_like(dup_sorted)
    out[order] = dup_sorted  # a permutation: every row written once
    return out
