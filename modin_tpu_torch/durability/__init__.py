"""Durable ingestion: the write-ahead log, checkpoints and crash recovery.

The port's counterpart of ``modin_tpu/durability/``, writing the same
files: a WAL or a checkpoint directory that either package wrote, the
other recovers.  Entry points:

- ``modin_tpu_torch.ingest.open_feed(name, ..., durable=True)``: the door;
  it imports this package on first use, so a process that opens no
  durable feed loads none of it (:data:`DURABILITY_ON` and
  :func:`durability_alloc_count` stay put);
- :func:`recover_feeds`: open every durable feed under a root directory;
- :class:`DurabilityError`: the one typed refusal.
"""

from __future__ import annotations

#: True from the first durable feed's open on
DURABILITY_ON = False

_alloc_count = 0


def _note_alloc() -> None:
    """Count a durability object made (the zero-allocation check)."""
    global _alloc_count
    _alloc_count += 1


def durability_alloc_count() -> int:
    return _alloc_count


def _mark_active() -> None:
    global DURABILITY_ON
    DURABILITY_ON = True


from modin_tpu_torch.durability.errors import DurabilityError  # noqa: E402
from modin_tpu_torch.durability.manager import (  # noqa: E402
    FeedDurability,
    open_durable_feed,
    recover_feeds,
    resolve_root_dir,
)

__all__ = [
    "DURABILITY_ON",
    "DurabilityError",
    "FeedDurability",
    "durability_alloc_count",
    "open_durable_feed",
    "recover_feeds",
    "resolve_root_dir",
]
