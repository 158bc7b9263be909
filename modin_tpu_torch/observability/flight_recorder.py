"""Flight recorder: dump the span ring when the card degrades.

The port's counterpart of ``modin_tpu/observability/flight_recorder.py``.
While tracing is on, every finished span also lands in a bounded ring
(``spans._RING``, ``MODIN_TPU_TORCH_TRACE_FLIGHT_RECORDER_SIZE``).  When the
resilience layer meets a breaker opening, or a failure it will raise on the
card, it calls :func:`dump_flight_record` *before* raising: the last spans
are written as a chrome://tracing-loadable file under ``TraceDir``, with
the meter snapshot at dump time under ``otherData.metrics`` and the counter
samples.  The device events of the ring are resolved first (one
synchronize), unless the failure is one that poisons the CUDA context.

Best effort: it never raises into the failure path, does nothing while
tracing is off, and dumps at most once every :data:`MIN_DUMP_INTERVAL_S`.
"""

from __future__ import annotations

import os
import pathlib
import re
import time
from typing import List, Optional

from modin_tpu_torch.concurrency import named_lock
from modin_tpu_torch.observability import spans as _spans
from modin_tpu_torch.observability.chrome_trace import to_chrome_trace
from modin_tpu_torch.utils import atomic_io

#: least seconds between two dumps (tests lower it)
MIN_DUMP_INTERVAL_S = 5.0

# "no dump yet": -inf, not 0.0 (monotonic time is the machine's uptime)
_NEVER_DUMPED = float("-inf")
_last_dump = _NEVER_DUMPED
_dump_lock = named_lock("flight.dump")

_REASON_SANITIZE = re.compile(r"[^A-Za-z0-9_.-]+")


def flight_snapshot() -> List[object]:
    """The spans in the ring (oldest first); empty while tracing is off."""
    ring = _spans._RING
    return list(ring) if ring is not None else []


def claim_dump_window() -> Optional[float]:
    """Claim the dump rate-limit window; None while it is closed."""
    global _last_dump
    with _dump_lock:
        now = time.monotonic()
        if now - _last_dump < MIN_DUMP_INTERVAL_S:
            return None
        _last_dump = now
        return now


def release_dump_claim(claimed: float) -> None:
    """Give back our claim after a failed write (only our own)."""
    global _last_dump
    with _dump_lock:
        if _last_dump == claimed:
            _last_dump = _NEVER_DUMPED


def reset_for_tests() -> None:
    """Clear the ring, the counter samples and the rate limiter."""
    global _last_dump
    ring = _spans._RING
    if ring is not None:
        ring.clear()
    counters = _spans._COUNTERS
    if counters is not None:
        counters.clear()
    _last_dump = _NEVER_DUMPED


def dump_flight_record(reason: str, detail: str = "", resolve_device: bool = True) -> Optional[str]:
    """Write the ring to a trace file; the path, or None (tracing off, an
    empty ring, the rate limit, a failed write).  Never raises.
    ``resolve_device=False`` skips the synchronize that would resolve the
    ring's device events (a lost context would raise it again)."""
    if not _spans.TRACE_ON:
        return None
    ring = _spans._RING
    if not ring:
        return None
    claimed = claim_dump_window()
    if claimed is None:
        return None
    if resolve_device:
        try:
            from modin_tpu_torch.observability import compile_ledger

            compile_ledger.resolve_events()
        except Exception:
            pass  # the spans still go out, with their host clock only
    with _dump_lock:
        snapshot = list(ring)
        counters = list(_spans._COUNTERS or ())
    try:
        # the counters at dump time (an empty series while meters are off:
        # recorded all the same, so the dump says so)
        from modin_tpu_torch.observability import meters as _meters

        metrics_snapshot = _meters.snapshot()
    except Exception:
        metrics_snapshot = None
    try:
        from modin_tpu_torch.config import TraceDir

        outdir = pathlib.Path(TraceDir.get())
        outdir.mkdir(parents=True, exist_ok=True)
        safe_reason = _REASON_SANITIZE.sub("_", reason) or "fault"
        path = outdir / f"flightrec_{safe_reason}_{os.getpid()}_{int(time.time() * 1e3)}.trace.json"
        trace = to_chrome_trace(
            snapshot,
            other_data={"reason": reason, "detail": detail, "spans": len(snapshot), "metrics": metrics_snapshot},
            counters=counters,
        )
        # temporary file, fsync, rename: a dump that dies mid-write leaves
        # no truncated trace behind
        atomic_io.atomic_write_json(str(path), trace)
        return str(path)
    except Exception:
        # a failed dump must not worsen the fault, nor spend the window
        release_dump_claim(claimed)
        return None
