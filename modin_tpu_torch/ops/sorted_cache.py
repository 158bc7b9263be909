"""Per-column cache of the sorted representation.

The port's counterpart of ``modin_tpu/ops/sorted_cache.py``.  The
sort-shaped reductions (median, quantile, nunique, mode, describe's
quantiles) all begin with the same prefix: sort the column with NaN at the
tail and count the valid prefix (``ops/sort.py::sorted_valid_columns``).
The first op attaches the ``(sorted values, n_valid)`` pair to its
``DeviceColumn``; every later op on that column reuses it.

A representation answers only for the tensor it was computed from: it keeps
that tensor's identity, and ``DeviceColumn.data``'s setter drops it when the
tensor is replaced.  The query compiler also drops the representation of a
column that ``setitem``/``insert`` take out of a frame.  The JAX package's
device-memory ledger (spill of cold representations under pressure) is a
later slice of the port: a representation lives as long as its column or
until :func:`invalidate`.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple


class SortedRep:
    """One column's sorted values, the valid count, and the identity of the
    tensor they were computed from."""

    __slots__ = ("data", "n_valid", "source_id")

    def __init__(self, data: Any, n_valid: Any, source_id: int):
        self.data = data
        self.n_valid = n_valid
        self.source_id = source_id


def _live_rep(col: Any) -> Optional[SortedRep]:
    rep = getattr(col, "_sorted_rep", None)
    if rep is None:
        return None
    if rep.source_id != id(col.data):
        col._sorted_rep = None
        return None
    return rep


def peek(col: Any) -> bool:
    """Whether ``col`` holds a current representation."""
    return _live_rep(col) is not None


def get(col: Any) -> Optional[Tuple[Any, Any]]:
    """``(sorted values, n_valid)`` if ``col`` holds a current one."""
    rep = _live_rep(col)
    return None if rep is None else (rep.data, rep.n_valid)


def attach(col: Any, xs: Any, n_valid: Any) -> None:
    """Cache ``(xs, n_valid)`` as ``col``'s sorted representation."""
    col._sorted_rep = SortedRep(xs, n_valid, id(col.data))


def invalidate(col: Any) -> None:
    """Drop ``col``'s representation (its tensor changed or left a frame)."""
    if getattr(col, "_sorted_rep", None) is not None:
        col._sorted_rep = None
