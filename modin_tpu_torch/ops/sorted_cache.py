"""Per-column cache of the sorted representation, over the artifact registry.

The port's counterpart of ``modin_tpu/ops/sorted_cache.py``.  The
sort-shaped reductions (median, quantile, nunique, mode, describe's
quantiles) all begin with the same prefix: sort the column with NaN at the
tail and count the valid prefix (``ops/sort.py::sorted_valid_columns``).
The first op attaches the ``(sorted values, n_valid)`` pair to its
``DeviceColumn``; every later op on that column reuses it.

:class:`SortedRep` is a :class:`~modin_tpu_torch.views.registry.
DerivedArtifact`: the lock, the validity stamps (the tensor it was computed
from and that tensor's version, the placement) and the device-ledger
protocol are the registry's.  What stays here is the column's own slot
(``DeviceColumn._sorted_rep``, read on the sort-shaped hot paths).  A
representation answers only for the tensor it was computed from;
replacing, spilling or donating the column's tensor drops it, and so does
``setitem`` taking the column out of a frame.  Each
representation is a derived entry of the device ledger (``core/memory.py``),
touched on reuse: under ``DeviceMemoryBudget`` pressure it is dropped before
any column, and with it the column's other artifacts (the next query
computes them again from the column, which stays resident).  It is kept
whatever ``ViewsMode`` says.
"""

from __future__ import annotations

import weakref
from typing import Any, Optional, Tuple

from modin_tpu_torch.core import memory
from modin_tpu_torch.logging.metrics import emit_metric
from modin_tpu_torch.views import registry as _registry


class SortedRep(_registry.DerivedArtifact):
    """One column's sorted values and valid count; a derived device-ledger
    entry."""

    __slots__ = ("col_ref",)

    def __init__(self, data: Any, n_valid: Any, source: Any, col: Any = None):
        super().__init__(
            kind="sorted_rep", params=(), token=0, length=0, source=source,
            state={"n_valid": n_valid}, payload=data,
        )
        self.col_ref = None if col is None else weakref.ref(col)

    @property
    def data(self) -> Any:
        return self._payload

    @property
    def n_valid(self) -> Any:
        state = self.state
        return None if state is None else state["n_valid"]

    def drop(self) -> int:
        """Release the payload and detach from the column: what a recovery
        pass does with a representation (it never replays one); returns
        the bytes the ledger got back."""
        col = self.col_ref() if self.col_ref is not None else None
        with _registry.LOCK:
            if col is not None and col._sorted_rep is self:
                col._sorted_rep = None
            return super().drop()

    def spill(self) -> int:
        """Ledger pressure: drop the representation from its column, and the
        column's other artifacts with it; returns the bytes the ledger got
        back."""
        col = self.col_ref() if self.col_ref is not None else None
        with _registry.LOCK:
            if col is not None and col._sorted_rep is self:
                col._sorted_rep = None
            freed = self.drop()
        if freed:
            emit_metric("sortcache.spill", 1)
            _registry.count("view.spill")
            if col is not None:
                _registry.invalidate_column(col, reason="pressure")
        return freed


def _invalidate_locked(col: Any) -> int:
    """Detach ``col``'s representation and take it off the ledger; a caller
    still holding its tensors (a ``get`` in flight) keeps them."""
    rep = getattr(col, "_sorted_rep", None)
    if rep is None:
        return 0
    col._sorted_rep = None
    emit_metric("sortcache.invalidate", 1)
    return memory.device_ledger.deregister(rep)


def _live_rep_locked(col: Any) -> Optional[SortedRep]:
    """``col``'s representation if it answers for the column's tensor as it
    stands (probing never restores a spilled column); a stale one goes."""
    rep = getattr(col, "_sorted_rep", None)
    if rep is None or rep._payload is None:
        return None
    if (
        not rep.answers_for(col._data)
        or rep.epoch != _registry._current_epoch()
        or rep.mesh_key != _registry._mesh_key()
    ):
        _invalidate_locked(col)
        return None
    if memory._DEVICE_BUDGET is not None:
        memory.device_ledger.touch(rep)
    return rep


def peek(col: Any) -> bool:
    """Whether ``col`` holds a current representation."""
    with _registry.LOCK:
        return _live_rep_locked(col) is not None


def get(col: Any) -> Optional[Tuple[Any, Any]]:
    """``(sorted values, n_valid)`` if ``col`` holds a current one."""
    with _registry.LOCK:
        rep = _live_rep_locked(col)
        hit = None if rep is None else (rep._payload, rep.n_valid)
    if hit is not None:
        emit_metric("sortcache.hit", 1)
    return hit


def attach(col: Any, xs: Any, n_valid: Any) -> None:
    """Cache ``(xs, n_valid)`` as ``col``'s sorted representation."""
    rep = SortedRep(xs, n_valid, col._data, col)
    with _registry.LOCK:
        _invalidate_locked(col)
        memory.device_ledger.register(rep)
        col._sorted_rep = rep
    emit_metric("sortcache.build", 1)


def invalidate(col: Any) -> None:
    """Drop ``col``'s representation (its tensor changed or left a frame)."""
    with _registry.LOCK:
        _invalidate_locked(col)
