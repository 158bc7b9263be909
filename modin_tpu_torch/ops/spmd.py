"""The sorted-representation build and the merge's right-side sort through
the range shuffle.

The port's counterpart of ``modin_tpu/ops/spmd.py``: the sort-shaped work
the layout router (``ops/router.decide_layout``) may send over the
row-shard mesh, through ``parallel/shuffle.range_shuffle`` (sample,
pivots, the block exchange, a local sort per shard):

- :func:`sharded_sorted_valid` (:func:`sharded_sorted_valid_columns` for a
  batch): the shared prefix of median, quantile, nunique and mode
  (``ops/sort.sorted_valid``), equal bit for bit to the local build (the
  same NaN-as-+inf collapse, ``sort.sorted_valid_prep``);
- :func:`sharded_merge_positions`: the merge's match positions with the
  right keys' sort done by the shuffle (the shuffled row ids are the local
  path's stable permutation); the probe and the expansion are
  ``ops/join.py``'s, so the positions are the local path's bit for bit.

Each returns None where the sharded path declines (a single shard, or
keys skewed past the shuffle's slack) and the caller's local path answers.
The JAX package's pad tail is gone: the port's columns are not padded, so
its ``_jit_seal_tail`` (the rep's sentinel over the pad rows) and the
``n_right`` clipping of ``_jit_match_presorted`` have nothing to do.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch


def _declines() -> bool:
    from modin_tpu_torch.parallel.mesh import num_row_shards

    return num_row_shards() < 2


def sharded_sorted_valid(c: torch.Tensor, n: int) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """``(sorted values, n_valid)`` of one column through the shuffle, or
    None (a single shard, skewed keys)."""
    from modin_tpu_torch.ops.sort import sorted_valid_prep
    from modin_tpu_torch.parallel.shuffle import ShuffleSkewError, range_shuffle

    if _declines():
        return None
    x, n_valid = sorted_valid_prep(c, int(n))
    try:
        xs, _cols, _counts, _pivots = range_shuffle(x, [], int(n), local_sort=True)
    except ShuffleSkewError:
        return None
    return xs, n_valid


def sharded_sorted_valid_columns(arrays: List[torch.Tensor], n: int) -> Optional[List[Tuple[torch.Tensor, torch.Tensor]]]:
    """The sharded build of a batch, or None where any column declines, so
    a batch is built one way whole."""
    out = []
    for c in arrays:
        pair = sharded_sorted_valid(c, n)
        if pair is None:
            return None
        out.append(pair)
    return out


def sharded_merge_positions(
    left_key: torch.Tensor,
    right_key: torch.Tensor,
    n_left: int,
    n_right: int,
    how: str = "inner",
) -> Optional[Tuple[torch.Tensor, torch.Tensor, int, bool]]:
    """``join.sort_merge_positions`` with the right side's sort through the
    shuffle, or None (a single shard, skewed keys).

    The right keys' int64 total-order codes range-partition with their row
    ids as payload and sort per shard; a shard's rows arrive in right
    order, so equal keys keep it, as the local stable sort does."""
    from modin_tpu_torch.ops import join
    from modin_tpu_torch.ops.structural import int64_key
    from modin_tpu_torch.parallel.shuffle import ShuffleSkewError, range_shuffle

    if _declines():
        return None
    if how not in ("inner", "left"):
        raise ValueError(f"sharded_merge_positions joins inner or left, not {how!r}")
    if left_key.shape[0] != n_left or right_key.shape[0] != n_right:
        raise ValueError("key lengths differ from n_left/n_right")
    rk = int64_key(right_key)
    row_ids = torch.arange(int(n_right), dtype=torch.int64, device=rk.device)
    try:
        rs, (perm,), _counts, _pivots = range_shuffle(rk, [row_ids], int(n_right), local_sort=True)
    except ShuffleSkewError:
        return None
    return join.positions_from_bounds(perm, *join.probe_sorted(rs, int64_key(left_key)), how)
