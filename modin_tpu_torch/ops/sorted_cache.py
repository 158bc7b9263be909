"""Per-column cache of the sorted representation.

The port's counterpart of ``modin_tpu/ops/sorted_cache.py``.  The
sort-shaped reductions (median, quantile, nunique, mode, describe's
quantiles) all begin with the same prefix: sort the column with NaN at the
tail and count the valid prefix (``ops/sort.py::sorted_valid_columns``).
The first op attaches the ``(sorted values, n_valid)`` pair to its
``DeviceColumn``; every later op on that column reuses it.

A representation answers only for the tensor it was computed from: it keeps
that tensor's identity, and replacing, spilling or donating the column's
tensor drops it.  The query compiler also drops the representation of a
column that ``setitem``/``insert`` take out of a frame.  Each representation
is a derived entry of the device ledger (``core/memory.py``), touched on
reuse: under ``DeviceMemoryBudget`` pressure it is spilled before any
column, and spilling it just drops it (the next sort-shaped op sorts again).
"""

from __future__ import annotations

import weakref
from typing import Any, Optional, Tuple

from modin_tpu_torch.core import memory


class SortedRep:
    """One column's sorted values, the valid count, and the identity of the
    tensor they were computed from; a derived device-ledger entry."""

    __slots__ = ("_data", "n_valid", "source_id", "_owner", "_dev_key", "__weakref__")
    is_derived_cache = True
    is_lazy = False

    def __init__(self, data: Any, n_valid: Any, source_id: int, owner: Any = None):
        self._data = data
        self.n_valid = n_valid
        self.source_id = source_id
        self._owner = None if owner is None else weakref.ref(owner)
        self._dev_key = None

    @property
    def data(self) -> Any:
        return self._data

    def spill(self) -> int:
        """Drop the representation from its column; returns the bytes the
        ledger got back."""
        owner = self._owner() if self._owner is not None else None
        if owner is not None and getattr(owner, "_sorted_rep", None) is self:
            owner._sorted_rep = None
        freed = memory.device_ledger.deregister(self)
        self._data = None
        return freed


def _live_rep(col: Any) -> Optional[SortedRep]:
    rep = getattr(col, "_sorted_rep", None)
    if rep is None:
        return None
    # the column's tensor as it stands: probing never restores a spilled one
    if rep._data is None or rep.source_id != id(col._data):
        invalidate(col)
        return None
    if memory._DEVICE_BUDGET is not None:
        memory.device_ledger.touch(rep)
    return rep


def peek(col: Any) -> bool:
    """Whether ``col`` holds a current representation."""
    return _live_rep(col) is not None


def get(col: Any) -> Optional[Tuple[Any, Any]]:
    """``(sorted values, n_valid)`` if ``col`` holds a current one."""
    rep = _live_rep(col)
    return None if rep is None else (rep._data, rep.n_valid)


def attach(col: Any, xs: Any, n_valid: Any) -> None:
    """Cache ``(xs, n_valid)`` as ``col``'s sorted representation."""
    invalidate(col)
    rep = SortedRep(xs, n_valid, id(col._data), col)
    col._sorted_rep = rep
    memory.device_ledger.register(rep)


def invalidate(col: Any) -> None:
    """Drop ``col``'s representation (its tensor changed or left a frame)."""
    rep = getattr(col, "_sorted_rep", None)
    if rep is not None:
        col._sorted_rep = None
        memory.device_ledger.deregister(rep)
