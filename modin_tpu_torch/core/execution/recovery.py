"""Lineage recovery of device columns: re-seat after a loss, evict on OOM.

The port's counterpart of ``modin_tpu/core/execution/recovery.py``.  Every
``DeviceColumn`` carries a **lineage record** attached when its tensor is
made, one of four provenance kinds:

- ``host`` -- the column's ``host_cache`` is an exact host copy; recovery is
  one ``TorchWrapper.put``;
- ``io`` -- the column came from a file read; the record re-reads the column
  from its source (``core/io/file_dispatcher.py`` attaches these);
- ``op`` -- the column is an output of a ``TorchWrapper.deploy``; the seam
  recorded ``(func, args)`` with the input tensors held **weakly** (lineage
  never pins device memory) and recovery replays the call over recovered
  inputs.  A chain deeper than ``LineageMaxDepth`` keeps an exact host copy
  instead (one fetch), which restarts it at depth 0;
- ``opaque`` -- a tensor made outside the seam, with nothing recorded.

On a DeviceLost (or a family's breaker opening on one) :func:`reseat_all`
bumps the **device epoch**, which marks every resident tensor suspect and
makes every derived artifact of ``views/`` stale, and re-seats every live
column from its lineage, so the failed call can run once more.  Derived
entries of the device ledger (the views' artifacts, the sorted
representations) are dropped, never replayed.  :func:`evict_for_oom` is the
evict-then-retry leg's evictor over ``core/memory.py``'s device ledger.

A real sticky CUDA error poisons the process's context: every later CUDA
call fails, the re-seat's uploads too, and the failure reaches the caller
as a DeviceLost.  Re-seat is exercised with injected faults, which leave
the tensors intact.  A column is never re-seated onto the CPU.

The JAX package's dataset manifest (``register_dataset``,
``warm_from_manifest``) waits for ``fleet/``, and its single-shard re-seat
for the multi-GPU port.
"""

from __future__ import annotations

import functools
import threading
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from modin_tpu_torch.concurrency import named_lock, named_rlock
from modin_tpu_torch.core.execution.resilience import count
from modin_tpu_torch.observability import spans as _spans
from modin_tpu_torch.observability.flight_recorder import dump_flight_record
from modin_tpu_torch.serving import context as serving_context

KIND_HOST = "host"
KIND_IO = "io"
KIND_OP = "op"
KIND_OPAQUE = "opaque"

#: kept current by the ``RecoveryMode`` subscription: the hooks on hot
#: paths read this one attribute
RECOVERY_ON: bool = True

_tls = threading.local()

_epoch_lock = named_lock("recovery.epoch")
_device_epoch = 0

#: serializes whole re-seat passes and carries the reseat-once handshake:
#: of several threads that observe one loss, one runs the pass; the others
#: find the epoch moved past what they saw and take that pass's result
_reseat_lock = named_lock("recovery.reseat")
_last_reseat_count = 0


class Unrecoverable(Exception):
    """A column's lineage cannot reproduce its tensor (never escapes)."""


class LineageRecord:
    """Provenance of one device column: ``kind`` (a KIND_* constant),
    ``depth`` (the op-replay chain below it), ``replay`` (the io re-read,
    returning exact host values) and ``detail`` (a note for debugging)."""

    __slots__ = ("kind", "depth", "replay", "detail")

    def __init__(self, kind: str, depth: int = 0, replay: Optional[Callable[[], Any]] = None, detail: str = ""):
        self.kind = kind
        self.depth = depth
        self.replay = replay
        self.detail = detail

    def __repr__(self) -> str:
        return f"<LineageRecord {self.kind} depth={self.depth} {self.detail}>"


# ---------------------------------------------------------------------- #
# provenance capture at the engine seam
# ---------------------------------------------------------------------- #
#
# ``TorchWrapper.deploy``/``put`` call record_deploy/record_put after each
# successful call.  Records are keyed by id(output tensor) behind a weakref
# guard: an entry dies with its tensor.  The input tensors of a deploy
# record are held weakly.


class _ArrRef:
    """Weak placeholder of a tensor leaf in recorded arguments, with its
    owning column and that column's lineage record when it has one: a pass
    that re-seats the column first drops the old tensor, and the replay
    then takes the column's new one (the same values while the column
    keeps the same lineage record; replacing its values resets it)."""

    __slots__ = ("ref", "col_ref", "lineage")

    def __init__(self, arr: Any, col: Optional[Any]):
        self.ref = weakref.ref(arr)
        self.col_ref = None if col is None else weakref.ref(col)
        self.lineage = None if col is None else col.lineage

    def column(self) -> Optional[Any]:
        col = None if self.col_ref is None else self.col_ref()
        return col if col is not None and col.lineage is self.lineage else None


class _DeployCall:
    """One recorded ``deploy``, shared by all its output leaves."""

    __slots__ = ("func", "args", "kwargs", "depth")

    def __init__(self, func: Callable, args: Any, kwargs: Optional[dict], depth: int):
        self.func = func
        self.args = args  # with tensor leaves replaced by _ArrRef
        self.kwargs = kwargs
        self.depth = depth


class _Record:
    """How to make one output tensor again."""

    __slots__ = ("ref", "call", "path", "put_ref", "depth")

    def __init__(self, arr: Any, on_dead: Callable, call: Optional[_DeployCall] = None,
                 path: Tuple[int, ...] = (), put_ref: Optional[weakref.ref] = None):
        self.ref = weakref.ref(arr, on_dead)
        self.call = call
        self.path = path
        self.put_ref = put_ref  # weakref to the host values given to put
        self.depth = call.depth if call is not None else 0


#: serializes the inserts and the purge of ``_columns_by_data``; the
#: provenance map takes single-key inserts and pops only (atomic in CPython)
_prov_lock = named_rlock("recovery.provenance")
_provenance: Dict[int, _Record] = {}
#: id(tensor) -> (weakref(owning column), weakref(tensor)): op replay
#: resolves an input tensor back to its column (and the column's host or io
#: lineage); the tensor's weakref guards id reuse and keeps the map valid
#: after the column re-seats onto a new tensor
_columns_by_data: Dict[int, tuple] = {}
#: the map's size that triggers its next purge of dead entries (twice what
#: the last purge left, so a frame of many columns purges a few times, not
#: once a column)
_purge_at = 4096


def _forget_record(key: int, _ref: Any = None) -> None:
    _provenance.pop(key, None)


def _walk_leaves(tree: Any, path: Tuple[int, ...] = (), out: Optional[list] = None) -> list:
    """[(path, leaf)] of the leaves of a nested tuple/list result."""
    if out is None:
        out = []
    if isinstance(tree, (tuple, list)):
        for i, item in enumerate(tree):
            _walk_leaves(item, path + (i,), out)
    else:
        out.append((path, tree))
    return out


def _is_device_array(x: Any) -> bool:
    return isinstance(x, torch.Tensor)


def _encode_args(tree: Any) -> Tuple[Any, int]:
    """(the recorded form of ``tree``: its tensor leaves as weak
    :class:`_ArrRef`, the deepest provenance among those leaves).  A leaf
    of a column answers with the column's lineage depth (a
    host-checkpointed column is depth 0 whatever chain made it)."""
    if isinstance(tree, (tuple, list)):
        parts = [_encode_args(a) for a in tree]
        return type(tree)(p[0] for p in parts), max((p[1] for p in parts), default=0)
    if not isinstance(tree, torch.Tensor):
        return tree, 0
    col = _lookup_column(tree)
    lin = None if col is None else col.lineage
    if lin is not None:
        depth = lin.depth
    else:
        rec = _lookup_record(tree)
        depth = rec.depth if rec is not None and rec.call is not None else 0
    return _ArrRef(tree, col), depth


# the two lookups read one dict entry each (atomic in CPython) and check
# the entry's identity against ``arr``, so they take no lock


def _lookup_record(arr: Any) -> Optional[_Record]:
    rec = _provenance.get(id(arr))
    return rec if rec is not None and rec.ref() is arr else None


def _lookup_column(arr: Any) -> Optional[Any]:
    entry = _columns_by_data.get(id(arr))
    if entry is None:
        return None
    col_ref, data_ref = entry
    if data_ref() is not arr:
        return None
    return col_ref()


def record_deploy(func: Callable, f_args: tuple, f_kwargs: Optional[dict], result: Any) -> None:
    """Op-replay provenance of every tensor leaf of a deploy's result."""
    if not RECOVERY_ON:
        return
    args, depth = _encode_args(f_args)
    call = _DeployCall(func, args, f_kwargs, depth=1 + depth)
    for path, leaf in _walk_leaves(result):
        if isinstance(leaf, torch.Tensor):
            key = id(leaf)
            _provenance[key] = _Record(leaf, functools.partial(_forget_record, key), call=call, path=path)


def record_put(host_values: Any, result: Any) -> None:
    """Host-origin provenance of a ``put``'s tensor (the host values held
    weakly; a value that takes no weak reference records nothing)."""
    if not RECOVERY_ON or not _is_device_array(result):
        return
    try:
        put_ref = weakref.ref(host_values)
    except TypeError:
        return
    key = id(result)
    _provenance[key] = _Record(result, functools.partial(_forget_record, key), put_ref=put_ref)


def note_column_data(col: Any) -> None:
    """Index ``col``'s concrete tensor for input -> column resolution."""
    data = col._data
    if not _is_device_array(data):
        return
    global _purge_at
    entry = (weakref.ref(col), weakref.ref(data))
    with _prov_lock:
        _columns_by_data[id(data)] = entry
        if len(_columns_by_data) > _purge_at:
            for k in [k for k, (c, d) in _columns_by_data.items() if d() is None or c() is None]:
                _columns_by_data.pop(k, None)
            _purge_at = max(4096, 2 * len(_columns_by_data))


# ---------------------------------------------------------------------- #
# lineage attachment (DeviceColumn calls these when its tensor is made)
# ---------------------------------------------------------------------- #


def current_epoch() -> int:
    return _device_epoch


def in_recovery() -> bool:
    return getattr(_tls, "active", False)


def attach_lineage(col: Any) -> None:
    """Attach ``col``'s lineage record (once: an io record survives).  A
    chain deeper than ``LineageMaxDepth`` is cut by a host checkpoint."""
    if not RECOVERY_ON:
        if col.lineage is None:
            col.lineage = LineageRecord(KIND_OPAQUE)
        return
    if col.lineage is not None:
        return
    if col.host_cache is not None:
        col.lineage = LineageRecord(KIND_HOST)
        return
    rec = _lookup_record(col._data)
    if rec is not None and rec.call is not None:
        from modin_tpu_torch.config import LineageMaxDepth

        if rec.depth > int(LineageMaxDepth.get()):
            col.host_checkpoint()
            col.lineage = LineageRecord(KIND_HOST, detail=f"checkpoint-cut@{rec.depth}")
            count("recovery.checkpoint_cut")
            return
        col.lineage = LineageRecord(KIND_OP, depth=rec.depth)
        return
    if rec is not None and rec.put_ref is not None:
        col.lineage = LineageRecord(KIND_HOST, detail="put-origin")
        return
    col.lineage = LineageRecord(KIND_OPAQUE)


def attach_io_lineage(col: Any, replay: Callable[[], Any], detail: str) -> None:
    """Attach (or upgrade to) an io record: ``replay`` re-reads the
    column's exact host values from its file."""
    col.lineage = LineageRecord(KIND_IO, replay=replay, detail=detail)


# ---------------------------------------------------------------------- #
# recovery: re-seat columns from lineage
# ---------------------------------------------------------------------- #


def _replay_array(arr: Any, depth: int) -> Any:
    """A live tensor equal to ``arr``: its column's recovered tensor (host
    and io records beat replay), else its own record's replay, else ``arr``
    itself (usable only while the runtime still honors it)."""
    from modin_tpu_torch.config import LineageMaxDepth

    if depth > int(LineageMaxDepth.get()):
        raise Unrecoverable("lineage deeper than LineageMaxDepth")
    col = _lookup_column(arr)
    if col is not None:
        recover_column(col, depth=depth)
        fresh = col._data
        if fresh is not None and not col.is_lazy:
            return fresh
    rec = _lookup_record(arr)
    if rec is not None:
        return _replay_record(rec, depth)
    return arr


def _replay_record(rec: _Record, depth: int) -> Any:
    from modin_tpu_torch.parallel.engine import TorchWrapper

    if rec.put_ref is not None:
        host = rec.put_ref()
        if host is None:
            raise Unrecoverable("the host origin of a put was collected")
        old = rec.ref()
        return TorchWrapper.put(host, None if old is None else old.device)
    call = rec.call
    if call is None:
        raise Unrecoverable("a record with neither a put origin nor a deploy call")

    def _decode(tree: Any) -> Any:
        if isinstance(tree, (tuple, list)):
            return type(tree)(_decode(a) for a in tree)
        if isinstance(tree, _ArrRef):
            old = tree.ref()
            if old is not None:
                return _replay_array(old, depth + 1)
            col = tree.column()
            if col is None:
                raise Unrecoverable("an input tensor of the replay is gone")
            recover_column(col, depth=depth + 1)
            return col.data
        return tree

    result = TorchWrapper.deploy(call.func, _decode(call.args), call.kwargs)
    for path, leaf in _walk_leaves(result):
        if path == rec.path:
            return leaf
    raise Unrecoverable("the replayed call did not make the output slot")


def recover_column(col: Any, depth: int = 0, force: bool = False) -> Optional[str]:
    """Re-seat one column's tensor from its lineage.

    Returns the lineage kind used, or None when there was nothing to do (a
    derived entry, which is dropped; a deferred or spilled column; a
    tensor of the current epoch unless ``force``).  Raises
    :class:`Unrecoverable` when no lineage reproduces the tensor.
    """
    if getattr(col, "is_derived_cache", False):
        col.drop()
        return None
    if col.is_lazy or col._data is None:
        return None
    if not force and col._device_epoch >= _device_epoch:
        return None
    if col.host_cache is not None:
        col.reseat_from_host()
        return KIND_HOST
    lin = col.lineage
    if lin is not None and lin.kind == KIND_IO and lin.replay is not None:
        try:
            values = lin.replay()
        except Unrecoverable:
            raise
        except Exception as err:  # a re-read can fail in any way: this lineage is then unusable
            raise Unrecoverable(f"io-source replay failed: {err}") from err
        # the dead tensor goes first: while the re-read values are the only
        # copy, is_spilled shields them from the host ledger
        col.adopt_host_cache(values, drop_tensor=True)
        col.reseat_from_host()
        return KIND_IO
    rec = _lookup_record(col._data)
    if rec is not None and (rec.call is not None or rec.put_ref is not None):
        col._adopt(_replay_record(rec, depth + 1))
        return KIND_OP
    raise Unrecoverable(f"no lineage for a column of dtype {col.pandas_dtype} and {col.length} rows")


#: io re-readers holding a memo of their values for one pass; purged at the
#: end of every pass so that a pass does not pin a host copy of the file
_io_replayers: "weakref.WeakSet" = weakref.WeakSet()


def note_io_replayer(replayer: Any) -> None:
    _io_replayers.add(replayer)


def _purge_io_caches() -> None:
    for replayer in list(_io_replayers):
        replayer.drop_cache()


def reseat_all(reason: str, observed_epoch: Optional[int] = None) -> int:
    """Bump the device epoch and re-seat every live device column; returns
    how many were re-seated (0: nothing resident, or recovery off, and the
    caller should not retry).

    ``observed_epoch`` is the epoch the caller's failed work launched in:
    the first observer of a loss runs the pass, and a later one whose work
    belongs to an epoch already recovered takes that pass's count.
    """
    global _device_epoch, _last_reseat_count
    if not RECOVERY_ON or in_recovery():
        return 0
    from modin_tpu_torch.core.memory import device_ledger

    if observed_epoch is None:
        observed_epoch = _device_epoch
    # lock order: the dispatch lock, then the re-seat lock, always.  A
    # device path reaches here holding the dispatch lock (it wraps the
    # whole guarded call), and the pass re-uploads through deploys that
    # take it; taking it first here makes the order the same for every
    # thread (one holding dispatch and wanting reseat, another the reverse,
    # would deadlock)
    with serving_context.dispatch_lock, _reseat_lock:
        if _device_epoch > observed_epoch:
            return _last_reseat_count
        # the pass is shared work (every query's columns come back through
        # it), so the triggering thread's deadline must not abort it: its
        # serving context is cleared for the pass and restored after
        saved_ctx = serving_context.snapshot_context()
        if saved_ctx is not None:
            serving_context.seed_thread_context(None)
        _tls.active = True
        try:
            with _epoch_lock:
                _device_epoch += 1
            count("recovery.device_lost")
            reseated = 0
            with _spans.span("recovery.reseat", "TORCH-ENGINE", reason=reason) as sp:
                for col in device_ledger.live_columns():
                    try:
                        kind = recover_column(col)
                    except Exception:  # Unrecoverable, or a replay that failed: one column never stops the pass
                        count("recovery.unrecoverable")
                        continue
                    if kind is not None:
                        count(f"recovery.reseat.{kind}")
                        reseated += 1
                if sp is not None:
                    sp.attrs["reseated"] = reseated
            _last_reseat_count = reseated
            if _spans.TRACE_ON and dump_flight_record("recovery_reseat", detail=reason, resolve_device=False):
                count("trace.flight_dump")
            return reseated
        finally:
            _tls.active = False
            if saved_ctx is not None:
                serving_context.seed_thread_context(saved_ctx)
            _purge_io_caches()


def recover_for_read(col: Any, err: BaseException) -> bool:
    """Read-path recovery of one column's host fetch: when ``err`` is a
    DeviceLost and the column's lineage can make it again, re-seat it and
    tell the caller to fetch once more.  False: re-raise."""
    from modin_tpu_torch.core.execution.resilience import DeviceLost, classify_device_error

    if not RECOVERY_ON or in_recovery():
        return False
    if not isinstance(classify_device_error(err), DeviceLost):
        return False
    _tls.active = True
    try:
        try:
            kind = recover_column(col, force=True)
        except Unrecoverable:
            count("recovery.unrecoverable")
            return False
        if kind is not None:
            count(f"recovery.reseat.{kind}")
        return True
    finally:
        _tls.active = False
        _purge_io_caches()


def recover_args(tree: Any) -> Optional[Any]:
    """``tree`` with every tensor leaf swapped for its recovered
    incarnation, or None when one cannot be rebound.  ``TorchWrapper.
    deploy`` runs a call once more over these after a re-seat: its first
    retry closed over the old tensors, which a real loss leaves dead."""
    if not RECOVERY_ON or in_recovery():
        return None
    _tls.active = True
    try:

        def rebind(node: Any) -> Any:
            if isinstance(node, (tuple, list)):
                return type(node)(rebind(a) for a in node)
            if _is_device_array(node):
                return _replay_array(node, 0)
            return node

        try:
            return rebind(tree)
        except Unrecoverable:
            return None
    finally:
        _tls.active = False
        _purge_io_caches()


def evict_for_oom(op: str, exclude_ids: Any = None) -> int:
    """Spill cold device entries after a DeviceOOM; returns the bytes freed
    (0: nothing spillable, the OOM stands).  ``exclude_ids`` holds the
    storage keys (``core/memory.storage_key``) of the failed call's own
    inputs, which the call pins: spilling them frees nothing."""
    if not RECOVERY_ON or in_recovery():
        return 0
    from modin_tpu_torch.config import SpillTargetFraction
    from modin_tpu_torch.core.memory import device_ledger

    _tls.active = True
    try:
        resident = device_ledger.total_bytes()
        target = max(int(resident * float(SpillTargetFraction.get())), 1)
        return device_ledger.spill_lru(target, exclude_ids=exclude_ids)
    finally:
        _tls.active = False


# ---------------------------------------------------------------------- #
# config wiring and test seams
# ---------------------------------------------------------------------- #


def _on_recovery_param(param: Any) -> None:
    global RECOVERY_ON
    RECOVERY_ON = param.get() == "Enable"


def reset_for_tests() -> None:
    """Forget provenance and the epoch."""
    global _device_epoch, _last_reseat_count
    with _prov_lock:
        _provenance.clear()
        _columns_by_data.clear()
    with _epoch_lock:
        _device_epoch = 0
    _last_reseat_count = 0


from modin_tpu_torch.config import RecoveryMode as _RecoveryMode  # noqa: E402

_RecoveryMode.subscribe(_on_recovery_param)
