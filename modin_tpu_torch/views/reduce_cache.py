"""Scalar reductions through the artifact registry: whole results reused,
folded over appends.

The port's counterpart of ``modin_tpu/views/reduce_cache.py``.  The query
compiler's column reduction hands this module its concrete device
columns; for each the registry answers

- **hit**: the same (op, skipna, ddof, cast_bool) reduction already ran on
  this tensor: no device work;
- **fold**: the column grew by an append since the artifact was built:
  only the tail ``data[base:n]`` (a view, no copy) is reduced, and
  ``views/incremental.py`` combines it with the cached prefix;
- **miss**: reduced from scratch, as with the cache off, and stored.

The values are the 0-d numpy arrays the plain path returns.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from modin_tpu_torch.observability import spans as _spans
from modin_tpu_torch.views import incremental, registry


def _mean_k(col: Any, n: int, skipna: bool) -> Optional[int]:
    """The valid count a mean's artifact carries where it is known without
    device work: every row for a NaN-free dtype or under skipna=False."""
    if col.pandas_dtype.kind != "f" or not skipna:
        return int(n)
    return None


def cached_reduce(op: str, cols: List[Any], n: int, skipna: bool, ddof: int, cast_bool: bool) -> Optional[List[np.ndarray]]:
    """Per-column results of ``op`` over ``cols`` through the registry, or
    None to decline (a column that is deferred, spilled or on the host:
    deferred chains keep their fusion, spilled columns their restore)."""
    from modin_tpu_torch.ops import reductions

    if op not in incremental.CACHEABLE_REDUCES:
        return None
    for c in cols:
        if not c.is_device or c._data is None or c.is_lazy:
            return None
    n, skipna, ddof = int(n), bool(skipna), int(ddof)
    params = (op, skipna, ddof, bool(cast_bool))
    can_fold = op in incremental.FOLDABLE_REDUCES
    datas = [c._data for c in cols]

    results: List[Optional[np.ndarray]] = [None] * len(cols)
    misses: List[int] = []
    folds: List[Any] = []  # (i, state, base_len)
    for i, col in enumerate(cols):
        outcome, state, base = registry.lookup(col, "reduce", params)
        if outcome == "hit":
            results[i] = state["r"]
        elif outcome == "fold" and can_fold:
            folds.append((i, state, base))
        else:
            misses.append(i)

    if misses:
        values = reductions.reduce_columns(
            op, [datas[i] for i in misses], n, skipna=skipna, ddof=ddof, cast_bool=cast_bool,
        )
        for i, v in zip(misses, values):
            results[i] = v
            state = {"r": v}
            if op == "mean":
                # a float skipna mean's valid count is derived at its first
                # fold, over the prefix rows: a cold query stays one pass
                state["k"] = _mean_k(cols[i], n, skipna)
            registry.store(cols[i], "reduce", params, state, can_fold=can_fold, host_bytes=64, source=datas[i])
    if folds:
        _fold_reduces(op, cols, datas, n, skipna, ddof, cast_bool, params, folds, results)
    return results


def _fold_reduces(
    op: str, cols: List[Any], datas: List[Any], n: int, skipna: bool, ddof: int, cast_bool: bool,
    params: tuple, folds: List[Any], results: List[Optional[np.ndarray]],
) -> None:
    """Reduce each fold column's tail and combine it with its cached prefix;
    the columns of one base length reduce together."""
    by_base: dict = {}
    for i, state, base in folds:
        by_base.setdefault(base, []).append((i, state))
    for base, group in by_base.items():
        n_tail = n - base
        idxs = [i for i, _ in group]
        with _spans.span("view.fold", "QUERY-COMPILER", op=op, cols=len(idxs), base=base, tail=n_tail):
            tail_values, tail_counts, base_counts = _reduce_tails(
                op, cols, datas, n, skipna, ddof, cast_bool, group, idxs, base, n_tail
            )
        for j, (i, state) in enumerate(group):
            if tail_values is None:
                new_state = dict(state)  # an empty tail: the prefix's answer
            elif op == "mean":
                k_tail = _mean_k(cols[i], n_tail, skipna)
                if k_tail is None:
                    k_tail = int(tail_counts[j])
                k_base = state["k"]
                if k_base is None:
                    k_base = int(base_counts[j])
                    registry.amend_ancestor_state(cols[i], "reduce", params, base, "k", k_base)
                m, k = incremental.combine_mean(state["r"], k_base, tail_values[j], k_tail)
                new_state = {"r": np.asarray(m), "k": k}
            else:
                new_state = {"r": incremental.combine_scalar(op, skipna, state["r"], tail_values[j])}
            results[i] = new_state["r"]
            registry.store(
                cols[i], "reduce", params, new_state, can_fold=True, host_bytes=64, folded=True,
                source=datas[i],
            )


def _reduce_tails(op, cols, datas, n, skipna, ddof, cast_bool, group, idxs, base, n_tail):
    """The tail's reductions of one fold group, and the valid counts a mean
    needs: ``(tail_values, tail_counts, base_counts)``, Nones for an empty
    tail."""
    from modin_tpu_torch.ops import reductions

    tail_values = tail_counts = base_counts = None
    if n_tail:
        tails = [datas[i][base:n] for i in idxs]
        tail_values = reductions.reduce_columns(
            op, tails, n_tail, skipna=skipna, ddof=ddof, cast_bool=cast_bool,
        )
        if op == "mean":
            need_k = [j for j, i in enumerate(idxs) if _mean_k(cols[i], n_tail, skipna) is None]
            if need_k:
                counted = reductions.reduce_columns("count", [tails[j] for j in need_k], n_tail, skipna=True)
                tail_counts = dict(zip(need_k, counted))
            # the prefix's valid counts the cold query did not pay for:
            # rows [0, base) are the ancestor's rows, and the count is
            # written back to the ancestor so later folds skip it
            need_k0 = [j for j, (_i, st) in enumerate(group) if st.get("k") is None]
            if need_k0:
                counted0 = reductions.reduce_columns(
                    "count", [datas[idxs[j]][:base] for j in need_k0], base, skipna=True
                )
                base_counts = dict(zip(need_k0, counted0))
    return tail_values, tail_counts, base_counts


# ---------------------------------------------------------------------- #
# sort-shaped results (nunique, mode, median): exact hits only
# ---------------------------------------------------------------------- #


def sort_reduce_lookup(op: str, params: tuple, cols: List[Any]) -> dict:
    """``{position: cached result}`` of the plain device columns in
    ``cols`` (None entries skipped).  A planning peek: nothing counted, no
    LRU touch; the router may still send the op to pandas.  The caller
    confirms the answers it used with :func:`sort_reduce_consume`."""
    out = {}
    for i, col in enumerate(cols):
        if col is None:
            continue
        outcome, state, _ = registry.lookup(col, f"sortred.{op}", params, consume=False)
        if outcome == "hit":
            out[i] = state["r"]
    return out


def sort_reduce_consume(op: str, params: tuple, cols: List[Any], used) -> None:
    """Count the peeked answers at positions ``used`` as served."""
    for i in used:
        if cols[i] is not None:
            registry.consume_hit(cols[i], f"sortred.{op}", params)


def sort_reduce_store(op: str, params: tuple, col: Any, value: Any) -> None:
    registry.store(col, f"sortred.{op}", params, {"r": value}, can_fold=False, host_bytes=_state_bytes(value))


def _state_bytes(value: Any) -> int:
    nbytes = getattr(value, "nbytes", None)
    if nbytes is not None:
        return int(nbytes) + 64
    if isinstance(value, tuple):
        return sum(_state_bytes(v) for v in value)
    return 64
