"""Typed errors of durability.

The port's counterpart of ``modin_tpu/durability/errors.py``.  Nearly a
leaf: only the ingest error types (a leaf) are imported.
"""

from __future__ import annotations

from modin_tpu_torch.ingest.errors import IngestError


class DurabilityError(IngestError):
    """A durability operation failed in a way the layer does not hide.
    ``reason`` is a stable slug:

    - ``enospc``: a WAL write hit ENOSPC and the reclaim of covered
      segments freed too little; the batch was refused before any change
      in memory (retry once the disk has room);
    - ``schema_mismatch``: ``open_feed`` was given a schema that
      contradicts the feed's ``meta.json`` (or a WAL record's schema tag
      contradicts the feed it replays into);
    - ``corrupt_meta``: the feed's ``meta.json`` does not read, so the
      feed cannot be rebuilt without a schema;
    - ``not_durable``: a durability operation on a feed with no WAL.

    EIO-class write failures do not raise this: they open the feed's WAL
    breaker (``wal.degraded``) and ingestion goes on in memory only.
    """

    def __init__(self, feed: str, reason: str, detail: str = "") -> None:
        self.feed = feed
        self.reason = reason
        msg = f"feed {feed!r} durability failure: {reason}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)
