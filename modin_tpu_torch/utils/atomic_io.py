"""Crash-safe file writes: one temp-file + fsync + atomic-rename helper.

The port's counterpart of ``modin_tpu/utils/atomic_io.py``.  A file the
port keeps across process lifetimes (a flight-recorder dump, a feed's
``meta.json``, a checkpoint of ``durability/``) is written in three steps:

1. the whole payload goes to a temporary file in the same directory (the
   same filesystem, so the rename below is atomic);
2. ``flush`` and ``os.fsync`` put the data on disk before the name;
3. ``os.replace`` moves it onto the destination: a reader sees the old
   complete file or the new complete file, never a prefix.

``durable_rename=True`` also fsyncs the parent directory, so that the
rename itself survives a power loss (checkpoints need that; recomputable
caches do not).

A leaf: the standard library only.
"""

from __future__ import annotations

import json
import os
from typing import Any


def fsync_dir(path: str) -> None:
    """fsync the directory that holds ``path`` (the rename's durability)."""
    dirpath = os.path.dirname(os.path.abspath(path)) or "."
    fd = os.open(dirpath, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes, durable_rename: bool = False) -> None:
    """Write ``data`` to ``path`` through a temporary file, fsync and rename.

    On any failure the temporary file is removed and the destination is
    untouched."""
    path = os.fspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if durable_rename:
        fsync_dir(path)


def atomic_write_text(path: str, text: str, durable_rename: bool = False) -> None:
    """:func:`atomic_write_bytes` of UTF-8 text."""
    atomic_write_bytes(path, text.encode("utf-8"), durable_rename=durable_rename)


def atomic_write_json(path: str, obj: Any, durable_rename: bool = False, **dumps_kwargs: Any) -> None:
    """:func:`atomic_write_bytes` of a JSON document, serialized first: an
    object that does not serialize fails before the disk changes."""
    text = json.dumps(obj, **dumps_kwargs)
    atomic_write_bytes(path, text.encode("utf-8"), durable_rename=durable_rename)
