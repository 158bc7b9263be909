"""Memory ledgers of the column store: host-copy budget and device admission.

The port's counterpart of ``modin_tpu/core/memory.py``.  Two budgets, two
ledgers:

- **Host** (``_HostCacheLedger``, ``MODIN_TPU_TORCH_MEMORY``): the exact host
  copies ``DeviceColumn.host_cache`` keeps.  Past the budget the coldest
  copies are dropped where the device tensor is authoritative (never the
  only copy of a spilled column).
- **Device** (``_DeviceLedger``, ``MODIN_TPU_TORCH_DEVICE_MEMORY_BUDGET``):
  every concrete column tensor and every derived artifact with a device
  payload (``views/registry.py``; the sorted representations of
  ``ops/sorted_cache.py`` are such artifacts).  Before an upload
  (``TorchWrapper.put``) or a fused launch (``ops/lazy.run_fused``) that
  would take the resident bytes past the budget,
  :meth:`_DeviceLedger.admit` spills the coldest entries: derived entries
  first (an artifact is just dropped), then columns, each tier coldest
  first.  A spilled column keeps an exact host
  copy and restores on its next read.

Entries are keyed on the tensor's **storage** (its device and
``untyped_storage().data_ptr()``, sized by the storage's ``nbytes()``), not
on the tensor: a column slice or selection can be a view of another
column's storage.  Two columns over one storage count its bytes once, both
pin it (it frees only when both spill), and neither is its sole consumer
(``buffer_consumers``: no donation).  The JAX package's per-shard
accounting collapses to one device.

Counts are plain integers in :data:`COUNTS` (spills, restores, donations
and their bytes) and seconds in :data:`SECONDS`, as the port counts its
kernel launches.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Dict, Iterable, Optional, Tuple

#: events and bytes: spills (``memory.device.spill``/``_bytes``; of them the
#: columns fetched to the host, ``spill_copy``/``_bytes``; the columns whose
#: host copy did not fit in host memory and so stayed resident,
#: ``spill_failed``), restores, and the fused leg's donations
#: (``fuse.donated``/``_bytes``, and the donated columns read again,
#: ``fuse.donated_restore``)
COUNTS: Dict[str, int] = {
    "memory.device.spill": 0,
    "memory.device.spill_bytes": 0,
    "memory.device.spill_copy": 0,
    "memory.device.spill_copy_bytes": 0,
    "memory.device.spill_failed": 0,
    "memory.device.restore": 0,
    "memory.device.restore_bytes": 0,
    "fuse.donated": 0,
    "fuse.donated_bytes": 0,
    "fuse.donated_restore": 0,
}
#: wall seconds of the device-to-host copies of spills and of the restores
SECONDS: Dict[str, float] = {"memory.device.spill_copy": 0.0, "memory.device.restore": 0.0}

_COUNT_LOCK = threading.Lock()


def count(name: str, value: int = 1) -> None:
    with _COUNT_LOCK:
        COUNTS[name] += int(value)


def add_seconds(name: str, seconds: float) -> None:
    with _COUNT_LOCK:
        SECONDS[name] += float(seconds)


def storage_key(t: Any) -> Tuple[str, int]:
    """The ledger's key of a tensor: its device and its storage's address."""
    return (str(t.device), int(t.untyped_storage().data_ptr()))


def storage_nbytes(t: Any) -> int:
    return int(t.untyped_storage().nbytes())


class _HostCacheLedger:
    """LRU accounting of the columns' host copies."""

    def __init__(self) -> None:
        # reentrant: a weakref callback can fire (GC) while this thread holds it
        self._lock = threading.RLock()
        self._entries: "OrderedDict[int, tuple]" = OrderedDict()
        self._total = 0
        self._next_id = 0

    def register(self, col: Any) -> None:
        cache = col.host_cache
        if cache is None or not hasattr(cache, "nbytes"):
            return
        nbytes = int(cache.nbytes)
        with self._lock:
            self.forget(col)
            key = self._next_id
            self._next_id += 1

            def _on_dead(_ref: Any, *, _key: int = key) -> None:
                self._forget_key(_key)

            self._entries[key] = (weakref.ref(col, _on_dead), nbytes)
            col._ledger_key = key
            self._total += nbytes
        self.enforce()

    def forget(self, col: Any) -> None:
        """Stop counting ``col``'s host copy (it was dropped or replaced)."""
        key = getattr(col, "_ledger_key", None)
        if key is not None:
            col._ledger_key = None
            self._forget_key(key)

    def _forget_key(self, key: int) -> None:
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is not None:
                self._total -= entry[1]

    def touch(self, col: Any) -> None:
        key = getattr(col, "_ledger_key", None)
        if key is None:
            return
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)

    def total_bytes(self) -> int:
        return self._total

    def budget(self) -> Optional[int]:
        from modin_tpu_torch.config import Memory

        return Memory.get()

    def enforce(self) -> None:
        """Drop the least recently used droppable copies until under budget."""
        budget = self.budget()
        if budget is None or self._total <= budget:
            return
        with self._lock:
            for key in list(self._entries):
                if self._total <= budget:
                    break
                entry = self._entries.get(key)
                if entry is None:
                    continue
                col = entry[0]()
                if col is None:
                    self._forget_key(key)
                    continue
                if not _evictable(col):
                    continue
                col.host_cache = None
                col._ledger_key = None
                self._forget_key(key)


def _evictable(col: Any) -> bool:
    """Whether dropping ``col``'s host copy keeps every read exact: the
    device tensor must hold the values (not spilled, not deferred); the
    port keeps every dtype on the device as it is, so any such tensor
    round-trips exactly."""
    return col.host_cache is not None and not col.is_spilled and not col.is_lazy


ledger = _HostCacheLedger()


#: the device budget, kept current by the ``DeviceMemoryBudget``
#: subscription so the admission seams read one attribute
_DEVICE_BUDGET: Optional[int] = None


class _Entry:
    """One storage: its bytes, its live holders by ``id``, and whether it is
    a derived cache (an artifact of ``views/registry.py``)."""

    __slots__ = ("nbytes", "holders", "derived")

    def __init__(self, nbytes: int, derived: bool):
        self.nbytes = nbytes
        self.holders: Dict[int, Any] = {}
        self.derived = derived


class _DeviceLedger:
    """LRU accounting of device-resident storages across the column store.

    A holder is a ``DeviceColumn`` or a ``DerivedArtifact`` (a
    ``SortedRep`` among them): it has ``_data`` (its
    tensor, None once spilled), ``_dev_key``, ``is_lazy``, ``spill()`` and
    ``is_derived_cache``.  Insertion order is the LRU order; :meth:`touch`
    refreshes it.
    """

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._entries: "OrderedDict[Tuple[str, int], _Entry]" = OrderedDict()
        self._total = 0
        self._spill_events = 0

    # -- registration ---------------------------------------------------- #

    def register(self, holder: Any) -> None:
        """Track ``holder``'s concrete tensor (idempotent per holder)."""
        t = holder._data
        nbytes = storage_nbytes(t)
        if nbytes == 0:
            return
        key = storage_key(t)
        derived = bool(getattr(holder, "is_derived_cache", False))
        with self._lock:
            if holder._dev_key is not None:
                self.deregister(holder)
            entry = self._entries.get(key)
            if entry is None:
                entry = self._entries[key] = _Entry(nbytes, derived)
                self._total += nbytes
            else:
                self._entries.move_to_end(key)
            hid = id(holder)

            def _on_dead(_ref: Any, *, _key: Tuple[str, int] = key, _hid: int = hid) -> None:
                self._drop_holder(_key, _hid)

            entry.holders[hid] = weakref.ref(holder, _on_dead)
            holder._dev_key = key

    def deregister(self, holder: Any) -> int:
        """Stop tracking ``holder`` (its tensor is being dropped); returns the
        bytes the device got back (0 while another holder pins the storage)."""
        key = holder._dev_key
        if key is None:
            return 0
        holder._dev_key = None
        return self._drop_holder(key, id(holder))

    def _drop_holder(self, key: Tuple[str, int], hid: int) -> int:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or entry.holders.pop(hid, None) is None:
                return 0
            if entry.holders:
                return 0
            del self._entries[key]
            self._total -= entry.nbytes
            return entry.nbytes

    def touch(self, holder: Any) -> None:
        key = holder._dev_key
        if key is None:
            return
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)

    # -- introspection ---------------------------------------------------- #

    def total_bytes(self) -> int:
        return self._total

    def budget(self) -> Optional[int]:
        return _DEVICE_BUDGET

    def spill_count(self) -> int:
        """Spill events since the process started."""
        return self._spill_events

    def live_columns(self) -> list:
        """The live holders of tracked storages, coldest first, each once:
        what a recovery pass re-seats (columns) or drops (derived entries)."""
        with self._lock:
            refs = [r for e in self._entries.values() for r in e.holders.values()]
        seen = set()
        out = []
        for r in refs:
            h = r()
            if h is not None and id(h) not in seen:
                seen.add(id(h))
                out.append(h)
        return out

    def buffer_consumers(self, buffer: Any) -> int:
        """How many live tracked holders hold ``buffer``'s storage: the
        donation proof needs exactly one."""
        return self.buffer_consumer_counts([buffer]).get(storage_key(buffer), 0)

    def buffer_consumer_counts(self, buffers: Iterable[Any]) -> Dict[Tuple[str, int], int]:
        """``{storage key: live holders}`` of a batch of tensors, one ledger
        read for the batch."""
        keys = {storage_key(b) for b in buffers}
        with self._lock:
            return {
                k: sum(1 for r in self._entries[k].holders.values() if r() is not None)
                for k in keys
                if k in self._entries
            }

    # -- spill policy ------------------------------------------------------ #

    def spill_lru(self, target_bytes: int, exclude_ids: Any = None) -> int:
        """Spill the coldest entries until ``target_bytes`` are freed;
        returns the bytes freed.  ``exclude_ids`` holds the storage keys an
        op is about to read: spilling them frees nothing (the op pins them).
        Derived entries go first (dropped, no copy), each tier coldest
        first."""
        with self._lock:
            candidates = [(k, e.derived, list(e.holders.values())) for k, e in self._entries.items()]
        candidates.sort(key=lambda c: not c[1])
        freed = spilled = 0
        try:
            for key, _derived, refs in candidates:
                if freed >= target_bytes:
                    break
                if exclude_ids is not None and key in exclude_ids:
                    continue
                holders = [h for r in refs if (h := r()) is not None]
                if not holders or any(h.is_lazy for h in holders):
                    continue
                for h in holders:
                    try:
                        got = h.spill()
                    except MemoryError:
                        # no room on the host for the copy: the column stays
                        # resident, counted; a device error propagates
                        count("memory.device.spill_failed")
                        continue
                    freed += got
                    spilled += 1
        finally:
            if spilled:
                with self._lock:
                    self._spill_events += spilled
                count("memory.device.spill", spilled)
                count("memory.device.spill_bytes", freed)
        return freed

    def admit(self, estimate_bytes: int, exclude_ids: Any = None) -> None:
        """Make room for an op about to allocate ``estimate_bytes``: spill
        cold entries where ``resident + estimate`` passes the budget.  No
        budget: nothing (the seams check :data:`_DEVICE_BUDGET` first)."""
        budget = _DEVICE_BUDGET
        if budget is None:
            return
        projected = self._total + max(int(estimate_bytes), 0)
        if projected <= budget:
            return
        self.spill_lru(projected - budget, exclude_ids=exclude_ids)


device_ledger = _DeviceLedger()


def device_resident_bytes() -> int:
    """Device bytes of the tracked storages."""
    return device_ledger.total_bytes()


def timed_copy(name: str, fn: Any) -> Any:
    """``fn()``, its wall seconds added to ``SECONDS[name]``."""
    t0 = time.perf_counter()
    out = fn()
    add_seconds(name, time.perf_counter() - t0)
    return out


def _on_device_budget(param: Any) -> None:
    global _DEVICE_BUDGET
    _DEVICE_BUDGET = param.get()


from modin_tpu_torch.config import DeviceMemoryBudget as _DeviceMemoryBudget  # noqa: E402

_DeviceMemoryBudget.subscribe(_on_device_budget)
