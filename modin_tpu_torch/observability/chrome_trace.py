"""Chrome Trace Event Format export of spans.

The port's counterpart of ``modin_tpu/observability/chrome_trace.py``: the
JSON Object Format that ``chrome://tracing`` and Perfetto load,
``{"traceEvents": [...], "displayTimeUnit": "ms"}``.  Each finished span is
one complete event (``"ph": "X"``, microsecond ``ts``/``dur`` on the host
clock, the layer as category, ids and attributes under ``args``: a launch's
event-timed ``device_ms`` rides there); thread-name metadata events label
the lanes, and counter samples become counter tracks (``"ph": "C"``).
"""

from __future__ import annotations

import json
import os
import pathlib
from typing import Any, Iterable, List, Optional


def _json_safe(value: Any) -> Any:
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    return str(value)


#: counter-track names, in sample-tuple order (``spans.counter_samples``);
#: ``zip`` stops at the shorter side, so an older sample omits a newer track
COUNTER_TRACKS = (
    "memory.device.resident_bytes",
    "memory.host.cache_bytes",
    "spans.live",
    "engine.cost.padding_waste_bytes",
    "engine.cost.achieved_bw_bytes_s",
    # the serving gate's queue depth and queries in flight
    "serving.gate.queued",
    "serving.gate.running",
)


def to_chrome_trace(
    spans: Iterable[Any],
    other_data: Optional[dict] = None,
    counters: Optional[Iterable[tuple]] = None,
) -> dict:
    """Finished spans as a chrome://tracing-loadable trace object;
    ``counters`` are ``(ts_us, values)`` samples, one "C" event per track."""
    pid = os.getpid()
    events: List[dict] = []
    thread_names = {}
    for sp in spans:
        thread_names.setdefault(sp.thread_id, sp.thread_name)
        # dict() copies at C level: safe against a worker still adding an
        # attribute to a finished span
        args = {str(k): _json_safe_tree(v) if isinstance(v, dict) else _json_safe(v) for k, v in dict(sp.attrs).items()}
        args["span_id"] = sp.span_id
        if sp.parent_id:
            args["parent_id"] = sp.parent_id
        if sp.status != "ok":
            args["status"] = sp.status
        events.append(
            {
                "name": sp.name,
                "cat": sp.layer,
                "ph": "X",
                "ts": round(sp.start_us, 3),
                "dur": round(sp.dur_us, 3),
                "pid": pid,
                "tid": sp.thread_id,
                "args": args,
            }
        )
    for ts, values in counters or ():
        for track, value in zip(COUNTER_TRACKS, values):
            events.append({"name": track, "ph": "C", "ts": round(ts, 3), "pid": pid, "args": {"value": value}})
    for tid, tname in sorted(thread_names.items()):
        events.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid, "args": {"name": tname}})
    trace = {"traceEvents": events, "displayTimeUnit": "ms"}
    if other_data:
        trace["otherData"] = {str(k): _json_safe_tree(v) for k, v in other_data.items()}
    return trace


def _json_safe_tree(value: Any) -> Any:
    if isinstance(value, dict):
        return {str(k): _json_safe_tree(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_json_safe_tree(v) for v in value]
    return _json_safe(value)


def export_chrome_trace(
    spans: Iterable[Any],
    path: Any,
    other_data: Optional[dict] = None,
    counters: Optional[Iterable[tuple]] = None,
) -> str:
    """Write the trace JSON to ``path`` (parent directories made)."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(to_chrome_trace(spans, other_data=other_data, counters=counters)))
    return str(p)
