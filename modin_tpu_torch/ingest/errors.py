"""Typed errors of continuous ingestion.

The port's counterpart of ``modin_tpu/ingest/errors.py``, with the same
``reason`` slugs.  A leaf (no import of the port), so the serving and
durability layers may name these types without loading the ingest
machinery.
"""

from __future__ import annotations

from typing import Any, Optional


class IngestError(Exception):
    """Base class of every ingestion error."""


class IngestRejected(IngestError):
    """A micro-batch failed admission: schema or dtype validation, a
    malformed payload, or a key violation.  ``reason`` is a stable slug
    (``missing_column`` / ``extra_column`` / ``dtype`` / ``malformed`` /
    ``unsupported_type`` / ``duplicate_key`` / ``key_exists`` /
    ``not_keyed``), so a caller branches without parsing the message."""

    def __init__(
        self,
        feed: str,
        reason: str,
        detail: str = "",
        column: Optional[str] = None,
        expected: Any = None,
        got: Any = None,
    ) -> None:
        self.feed = feed
        self.reason = reason
        self.column = column
        self.expected = expected
        self.got = got
        bits = [f"feed {feed!r} rejected batch: {reason}"]
        if column is not None:
            bits.append(f"column={column!r}")
        if expected is not None:
            bits.append(f"expected={expected}")
        if got is not None:
            bits.append(f"got={got}")
        if detail:
            bits.append(detail)
        super().__init__(" ".join(bits))


class ViewNotIncrementalizable(IngestError):
    """``register_view`` refused the plan: it has no exact fold under
    appends.  Never recomputed behind the caller's back: the caller changes
    the plan or runs the query ad hoc.  ``reason`` is a stable slug
    (``unknown_kind`` / ``unknown_column`` / ``non_foldable_agg`` /
    ``unknown_agg`` / ``row_view_unbounded`` / ``bad_predicate`` /
    ``bad_k`` / ``bad_column_dtype`` / ``bad_window``)."""

    def __init__(self, name: str, reason: str, detail: str = "") -> None:
        self.name = name
        self.reason = reason
        msg = f"view {name!r} is not incrementalizable: {reason}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)
