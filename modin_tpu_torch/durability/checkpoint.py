"""Checkpoints: crash-consistent snapshots of a feed and its views.

The port's counterpart of ``modin_tpu/durability/checkpoint.py``, in the
same format.  ``ckpt_<wal_seq>.ckpt`` holds one pickled snapshot of what a
crash would lose: the retained host mirror, the key index, the batch log
(sequence numbers, rows, first row ids; the rows are in the mirror) and
every view's fold state (bootstrap partial, per-batch partials, running
state).  Host objects only: pandas frames and series, numpy scalars,
dicts and tuples, never a device tensor nor a class of either package, so
a file ties itself to no CUDA context and either package loads it.
``wal_seq`` is the newest WAL record the snapshot covers: recovery loads
the newest valid checkpoint and replays only the records past it.

The file is ``[u32 crc32(payload)][payload]``, written through
``utils/atomic_io.py`` (temporary file, fsync, rename, directory fsync):
a reader sees a whole old checkpoint or a whole new one.  A CRC or
unpickling failure at load returns None (``checkpoint.invalid``) and
recovery tries the next older file.
"""

from __future__ import annotations

import os
import pickle
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

from modin_tpu_torch.durability import wal as _wal
from modin_tpu_torch.utils.atomic_io import atomic_write_bytes

CKPT_PREFIX = "ckpt_"
CKPT_SUFFIX = ".ckpt"

_CKPT_HEADER = struct.Struct("<I")  # crc32(payload)


def checkpoint_path(feed_dir: str, wal_seq: int) -> str:
    return os.path.join(feed_dir, f"{CKPT_PREFIX}{wal_seq:016d}{CKPT_SUFFIX}")


def list_checkpoints(feed_dir: str) -> List[Tuple[int, str]]:
    """``[(wal_seq, path)]`` ascending; ignores foreign files."""
    out: List[Tuple[int, str]] = []
    try:
        names = os.listdir(feed_dir)
    except OSError:
        return out
    for fname in names:
        if not (fname.startswith(CKPT_PREFIX) and fname.endswith(CKPT_SUFFIX)):
            continue
        digits = fname[len(CKPT_PREFIX):-len(CKPT_SUFFIX)]
        try:
            seq = int(digits)
        except ValueError:
            continue
        out.append((seq, os.path.join(feed_dir, fname)))
    out.sort()
    return out


def serialize_snapshot(snapshot: Dict[str, Any]) -> bytes:
    """The snapshot pickled (outside every lock)."""
    return pickle.dumps(snapshot, protocol=pickle.HIGHEST_PROTOCOL)


def write_checkpoint(feed_dir: str, wal_seq: int, payload: bytes) -> str:
    """Atomically write one checkpoint; returns its path.  Raises OSError
    on disk failure (the caller decides: reclaim-and-retry or give up —
    the WAL still holds every record, so a failed checkpoint loses
    nothing but replay time)."""
    _wal.disk_op("checkpoint.write")
    path = checkpoint_path(feed_dir, wal_seq)
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    atomic_write_bytes(
        path, _CKPT_HEADER.pack(crc) + payload, durable_rename=True
    )
    return path


def load_checkpoint(path: str) -> Optional[Dict[str, Any]]:
    """The snapshot dict, or None when the file is unreadable, fails its
    CRC, or does not unpickle — recovery treats None as 'try the next
    older checkpoint', never a crash."""
    try:
        with open(path, "rb") as f:
            data = f.read()
        if len(data) < _CKPT_HEADER.size:
            return None
        (crc,) = _CKPT_HEADER.unpack_from(data, 0)
        payload = data[_CKPT_HEADER.size:]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            return None
        snapshot = pickle.loads(payload)
    except (OSError, ValueError, EOFError, pickle.UnpicklingError, AttributeError, ImportError, IndexError):
        return None
    return snapshot if isinstance(snapshot, dict) else None
