"""The write-ahead log: the record codec and a feed's segment writer.

The port's counterpart of ``modin_tpu/durability/wal.py``; the two write
the same bytes, so either package recovers the other's log.  One record an
admitted micro-batch or view registration (little-endian):

    [u32 body_len][u32 crc32(body)] [u64 wal_seq][u8 opcode][payload]
    \\------ header (8 bytes) -----/ \\----------- body ------------/

The CRC covers the whole body (sequence number and opcode too), so a
flipped byte anywhere is caught, and a short header or body is a torn tail.
``wal_seq`` grows by one a record within a feed; recovery replays the
records past the newest checkpoint's and skips the rest, which makes the
replay idempotent.  A payload is a pickle of host objects only (a pandas
frame, a plan dict), made outside every lock; under the feed's lock run
only the header, the one ``write`` and the policy's fsync: the record is on
disk before the change in memory it describes.

Segments are ``wal_<first_seq>.seg``; the writer starts the next past
``MODIN_TPU_TORCH_WAL_SEGMENT_BYTES``, and a checkpoint deletes every
closed segment it covers.

Failures:

- **ENOSPC** on a write: the manager's reclaim deletes covered segments
  and older checkpoints, and the write is tried once more; failing again
  raises a typed :class:`~modin_tpu_torch.durability.errors.DurabilityError`
  before anything in memory changed;
- **EIO or any other OSError** (a write or an fsync): the feed's breaker
  opens into memory-only mode (``wal.degraded``): ingestion goes on, and
  no more writes are tried for the feed.
"""

from __future__ import annotations

import errno
import os
import pickle
import signal
import struct
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

from modin_tpu_torch.concurrency import named_lock
from modin_tpu_torch.durability.errors import DurabilityError

_HEADER = struct.Struct("<II")  # body_len, crc32(body)
_BODY_PREFIX = struct.Struct("<QB")  # wal_seq, opcode

OP_APPEND = 0
OP_UPSERT = 1
OP_REGISTER = 2

SEGMENT_PREFIX = "wal_"
SEGMENT_SUFFIX = ".seg"

#: test seam (``testing/faults.DiskFaultInjector``): called before every disk
#: operation as ``hook(op)`` with op one of ``wal.write`` / ``wal.fsync``
#: / ``wal.truncate`` / ``checkpoint.write`` / ``checkpoint.truncate``.
#: It may raise ``OSError`` (the fault) or return an ``int`` N — valid
#: only for ``wal.write``: the first N bytes of the record land on disk
#: and the process SIGKILLs itself, a real torn write.
_disk_fault_hook: Optional[Callable[[str], Optional[int]]] = None


def disk_op(op: str) -> Optional[int]:
    """Run the injected-disk-fault seam for ``op`` (None in production)."""
    hook = _disk_fault_hook
    if hook is None:
        return None
    return hook(op)


def schema_tag(schema: Dict[str, Any]) -> int:
    """Stable CRC32 tag of a feed schema (column order and dtypes), in
    every record and checkpoint, so that another feed's state is refused
    instead of replayed."""
    import numpy as np

    text = ";".join(f"{col}={np.dtype(dt).str}" for col, dt in schema.items())
    return zlib.crc32(text.encode("utf-8")) & 0xFFFFFFFF


def encode_batch(tag: int, pdf: Any, is_upsert: bool) -> Tuple[int, bytes]:
    """``(opcode, payload)`` for one normalized micro-batch: a pickle of
    the schema-exact pandas frame (a bit-exact round trip; the replay
    re-enters the ingest path with the very frame it admitted)."""
    opcode = OP_UPSERT if is_upsert else OP_APPEND
    return opcode, pickle.dumps((tag, pdf), protocol=pickle.HIGHEST_PROTOCOL)


def encode_register(tag: int, name: str, plan: Dict[str, Any]) -> Tuple[int, bytes]:
    """``(opcode, payload)`` for one view registration, so a view
    registered after the newest checkpoint survives a crash too."""
    return OP_REGISTER, pickle.dumps(
        (tag, name, dict(plan)), protocol=pickle.HIGHEST_PROTOCOL
    )


def decode_payload(opcode: int, payload: bytes) -> Any:
    return pickle.loads(payload)


def segment_path(feed_dir: str, first_seq: int) -> str:
    return os.path.join(feed_dir, f"{SEGMENT_PREFIX}{first_seq:016d}{SEGMENT_SUFFIX}")


def list_segments(feed_dir: str) -> List[Tuple[int, str]]:
    """``[(first_seq, path)]`` ascending; ignores foreign files."""
    out: List[Tuple[int, str]] = []
    try:
        names = os.listdir(feed_dir)
    except OSError:
        return out
    for fname in names:
        if not (fname.startswith(SEGMENT_PREFIX) and fname.endswith(SEGMENT_SUFFIX)):
            continue
        digits = fname[len(SEGMENT_PREFIX):-len(SEGMENT_SUFFIX)]
        try:
            first = int(digits)
        except ValueError:
            continue
        out.append((first, os.path.join(feed_dir, fname)))
    out.sort()
    return out


def read_segment(path: str) -> Tuple[List[Tuple[int, int, bytes]], int, bool]:
    """Decode one segment file.

    Returns ``(records, valid_bytes, torn)`` where ``records`` is
    ``[(wal_seq, opcode, payload)]`` in file order, ``valid_bytes`` is
    the byte offset of the end of the last intact record, and ``torn``
    is True when the file ends in a short header, short body, or a
    CRC/length mismatch — everything from ``valid_bytes`` on is garbage
    a crashed writer left behind and must be truncated, never replayed.
    """
    records: List[Tuple[int, int, bytes]] = []
    valid = 0
    torn = False
    with open(path, "rb") as f:
        data = f.read()
    size = len(data)
    offset = 0
    while offset < size:
        if offset + _HEADER.size > size:
            torn = True  # short header: the write died mid-record
            break
        body_len, crc = _HEADER.unpack_from(data, offset)
        body_start = offset + _HEADER.size
        body_end = body_start + body_len
        if body_len < _BODY_PREFIX.size or body_end > size:
            torn = True  # short body / absurd length
            break
        body = data[body_start:body_end]
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            torn = True  # flipped byte(s): CRC mismatch
            break
        seq, opcode = _BODY_PREFIX.unpack_from(body, 0)
        records.append((seq, opcode, body[_BODY_PREFIX.size:]))
        offset = body_end
        valid = offset
    return records, valid, torn


class SegmentWriter:
    """One feed's WAL appender: active segment file + fsync policy.

    All mutable state is guarded by the ``durability.wal`` named lock
    (nested under ``ingest.feed`` on the append path; the group-commit
    flusher thread takes it alone).  No metric goes out under it: callers
    pass an ``events`` list and emit after their locks are released.
    """

    def __init__(
        self,
        feed_name: str,
        feed_dir: str,
        next_seq: int,
        policy: str,
        segment_bytes: int,
        reclaim: Callable[[List[Tuple[str, int]]], int],
    ) -> None:
        from modin_tpu_torch.durability import _note_alloc

        _note_alloc()
        self.feed_name = feed_name
        self.feed_dir = feed_dir
        self.policy = policy
        self.segment_bytes = int(segment_bytes)
        self.next_seq = int(next_seq)
        self.degraded = False
        self._reclaim = reclaim
        self._lock = named_lock("durability.wal")
        self._fh: Optional[Any] = None
        self._fh_path: Optional[str] = None
        self._fh_bytes = 0
        self._dirty = False  # unsynced bytes (GroupCommit)

    # -- segment lifecycle (callers hold self._lock) -------------------- #

    def _open_segment_locked(self, first_seq: int) -> None:
        path = segment_path(self.feed_dir, first_seq)
        fh = open(path, "ab", buffering=0)
        self._fh = fh
        self._fh_path = path
        self._fh_bytes = fh.tell()

    def adopt_segment(self, first_seq: int) -> None:
        """Resume appending to an existing (recovered, possibly
        truncated) segment file."""
        with self._lock:
            self._open_segment_locked(first_seq)

    def _close_fh_locked(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
        self._fh = None
        self._fh_path = None
        self._fh_bytes = 0
        self._dirty = False

    # -- the append path ------------------------------------------------ #

    def append(
        self, opcode: int, payload: bytes, events: List[Tuple[str, int]]
    ) -> Optional[int]:
        """Append one record; returns its wal_seq, or None when the feed
        is (or just became) degraded.  Raises
        :class:`~modin_tpu_torch.durability.errors.DurabilityError` only for
        ENOSPC that a reclaim pass could not cure — the one refusal."""
        with self._lock:
            if self.degraded:
                return None
            seq = self.next_seq
            body = _BODY_PREFIX.pack(seq, opcode) + payload
            record = _HEADER.pack(len(body), zlib.crc32(body) & 0xFFFFFFFF) + body
            if (
                self._fh is not None
                and self._fh_bytes + len(record) > self.segment_bytes
                and self._fh_bytes > 0
            ):
                self._close_fh_locked()
                events.append(("wal.segment.roll", 1))
            if self._fh is None and not self._open_with_reclaim_locked(
                seq, events
            ):
                return None
            self._write_record_locked(record, events)
            if self.degraded:
                return None
            self.next_seq = seq + 1
            if self.policy == "PerBatch":
                self._fsync_locked(events)
            elif self.policy == "GroupCommit":
                self._dirty = True
            events.append(("wal.append", 1))
            events.append(("wal.append.bytes", len(record)))
            return seq

    def _open_with_reclaim_locked(
        self, first_seq: int, events: List[Tuple[str, int]]
    ) -> bool:
        """Open a fresh segment, reclaiming once on ENOSPC.  Returns True
        when a segment is open; False means the writer degraded (EIO
        class).  Exhausted ENOSPC raises the typed refusal."""
        try:
            self._open_segment_locked(first_seq)
            return True
        except OSError as err:
            if err.errno != errno.ENOSPC:
                self._degrade_locked(events)
                return False
        events.append(("wal.enospc.reclaim", 1))
        self._reclaim(events)
        try:
            self._open_segment_locked(first_seq)
            return True
        except OSError as err:
            if err.errno == errno.ENOSPC:
                raise DurabilityError(
                    self.feed_name,
                    "enospc",
                    "could not open a WAL segment after reclaim; batch "
                    "refused before any in-memory mutation",
                )
            self._degrade_locked(events)
            return False

    def _write_record_locked(
        self, record: bytes, events: List[Tuple[str, int]]
    ) -> None:
        for attempt in (0, 1):
            try:
                torn_n = disk_op("wal.write")
                if torn_n is not None:
                    # injected torn write: a prefix lands, the process dies
                    # — the genuine crash shape the recovery tests replay
                    self._fh.write(record[: max(0, int(torn_n))])
                    os.fsync(self._fh.fileno())
                    os.kill(os.getpid(), signal.SIGKILL)
                self._fh.write(record)
                self._fh_bytes += len(record)
                return
            except OSError as err:
                if err.errno == errno.ENOSPC and attempt == 0:
                    # retention-driven reclaim: drop checkpoint-covered
                    # segments + stale checkpoints, then retry once
                    events.append(("wal.enospc.reclaim", 1))
                    self._reclaim(events)
                    continue
                if err.errno == errno.ENOSPC:
                    raise DurabilityError(
                        self.feed_name,
                        "enospc",
                        "WAL write hit ENOSPC and reclaim freed nothing; "
                        "batch refused before any in-memory mutation",
                    )
                # EIO-class: trip the breaker, keep serving memory-only
                self._degrade_locked(events)
                return

    def _fsync_locked(self, events: List[Tuple[str, int]]) -> None:
        try:
            disk_op("wal.fsync")
            os.fsync(self._fh.fileno())
            self._dirty = False
            events.append(("wal.fsync", 1))
        except OSError:
            # an fsync that fails is durability already lost: degrade
            self._degrade_locked(events)

    def _degrade_locked(self, events: List[Tuple[str, int]]) -> None:
        if not self.degraded:
            self.degraded = True
            events.append(("wal.degraded", 1))
        self._close_fh_locked()

    # -- group-commit flusher ticks ------------------------------------- #

    def flush_if_dirty(self, events: List[Tuple[str, int]]) -> None:
        with self._lock:
            if self._dirty and not self.degraded and self._fh is not None:
                self._fsync_locked(events)

    def close(self) -> None:
        events: List[Tuple[str, int]] = []
        with self._lock:
            if self._dirty and not self.degraded and self._fh is not None:
                self._fsync_locked(events)
            self._close_fh_locked()

    def active_path(self) -> Optional[str]:
        with self._lock:
            return self._fh_path
