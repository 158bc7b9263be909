"""Continuous ingestion with live views.

The port's counterpart of ``modin_tpu/ingest/``: named
:class:`~modin_tpu_torch.ingest.feed.Feed` objects take append and upsert
micro-batches with schema validation, grow one port frame on the device
through the port's ``concat`` (the views registry's append links keep
ad-hoc queries on it folding), and maintain registered live views
(filtered, top-k, windowed, scalar and groupby aggregates) on every batch
through the fold algebra of ``live.py``.  Reads are bounded in staleness
(``fresh_within_ms``) and, like the batches, go through the serving gate.

``MODIN_TPU_TORCH_INGEST=0`` (the default): :func:`create_feed` refuses,
nothing else reads this package, and :func:`ingest_alloc_count` stays put
over any workload.  ``open_feed(..., durable=True)`` adds the write-ahead
log, checkpoints and crash recovery of ``durability/``.
"""

from __future__ import annotations

from typing import Any

#: True while MODIN_TPU_TORCH_INGEST=1: the one attribute read before any
#: ingestion work
INGEST_ON: bool = False


def _on_ingest_enabled(param: Any) -> None:
    global INGEST_ON
    INGEST_ON = bool(param.get())


from modin_tpu_torch.config import IngestEnabled as _IngestEnabled  # noqa: E402

_IngestEnabled.subscribe(_on_ingest_enabled)

from modin_tpu_torch.ingest.errors import (  # noqa: E402,F401
    IngestError,
    IngestRejected,
    ViewNotIncrementalizable,
)
from modin_tpu_torch.ingest.feed import (  # noqa: E402,F401
    Feed,
    ViewRead,
    create_feed,
    drop_feed,
    feeds,
    get_feed,
    max_fold_lag_ms,
    open_feed,
    reset,
)
from modin_tpu_torch.ingest.live import LiveView, ingest_alloc_count  # noqa: E402,F401

__all__ = [
    "Feed",
    "INGEST_ON",
    "IngestError",
    "IngestRejected",
    "LiveView",
    "ViewNotIncrementalizable",
    "ViewRead",
    "create_feed",
    "drop_feed",
    "feeds",
    "get_feed",
    "ingest_alloc_count",
    "max_fold_lag_ms",
    "open_feed",
    "reset",
]
