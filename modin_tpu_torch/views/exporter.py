"""Exporting and ingesting view artifacts across processes.

The port's counterpart of ``modin_tpu/views/exporter.py``.  The registry
(``views/registry.py``) keys artifacts by in-process identity: the column's
token, a weak reference to its tensor and the tensor's ``_version``, the
device epoch.  None of it survives a process.  A fleet replica that died
and respawned re-reads its datasets from the manifest
(``core/execution/recovery.py``), and then the coordinator replays a
healthy survivor's host-state artifacts onto the fresh frames, so the
respawned replica's first queries hit warm instead of recomputing.

Export is positional: an artifact travels as ``(column position, kind,
params, length, state)``, with no token, tensor or epoch; ``registry.store``
binds it on the ingesting side to that process's own column tensor.  Only
host state travels (the reduce results are numpy scalars, the groupby
tables pandas frames); an artifact with a device payload, or with a tensor
anywhere in its state, is skipped and rebuilds on demand, as after a
ledger drop.  The length is checked again at ingest: a frame of another
length (the dataset changed between export and ingest) skips the record.
A groupby state's column identities travel as ``registry.ADOPT_IDENTS``;
the ingest adds a guard on the frame it ingested onto
(``groupby_cache.adopt_guard``), and the groupby cache adopts this
process's identities on its first exact-length hit there.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List

import torch

from modin_tpu_torch.logging.metrics import emit_metric
from modin_tpu_torch.views import registry


def _frame_columns(frame: Any) -> List[Any]:
    """The columns of a port frame (empty for anything else)."""
    try:
        mf = frame._query_compiler._modin_frame
        return [mf.get_column(i) for i in range(mf.num_cols)]
    except Exception:
        return []


def _holds_tensor(value: Any) -> bool:
    """Whether ``value`` (a state, or anything inside one) holds a tensor."""
    if isinstance(value, torch.Tensor):
        return True
    if isinstance(value, dict):
        return any(_holds_tensor(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return any(_holds_tensor(v) for v in value)
    return False


def export_artifacts(frame: Any) -> List[dict]:
    """Picklable records of ``frame``'s live host-state artifacts:
    ``{"col": position, "kind", "params", "length", "state", "can_fold",
    "host_bytes"}``.  Device payloads, tensors in a state, empty states and
    states that do not pickle are skipped: they rebuild on demand."""
    candidates: List[dict] = []
    cols = _frame_columns(frame)
    # snapshot under the registry lock, pickle outside it: the probe of a
    # large table can take long, and every query's hit takes this lock
    with registry.LOCK:
        for pos, col in enumerate(cols):
            tok = getattr(col, "_view_token", None)
            if tok is None:
                continue
            for key in registry._by_token.get(tok, ()):
                art = registry._entries.get(key)
                if art is None or not art.live or art.state is None or art._payload is not None:
                    continue
                state = art.state
                if isinstance(state, dict) and ("idents" in state or "host_guards" in state):
                    # identities are process-local: the sentinel travels, and
                    # the ingesting side adopts its own on the first hit
                    state = dict(state)
                    state["idents"] = registry.ADOPT_IDENTS
                    state["host_guards"] = ()
                    state.pop("adopt_guard", None)
                candidates.append({
                    "col": pos,
                    "kind": art.kind,
                    "params": art.params,
                    "length": art.length,
                    "state": state,
                    "can_fold": art.can_fold,
                    "host_bytes": art.host_bytes,
                })
    records = []
    for record in candidates:
        if _holds_tensor(record["state"]):
            continue
        try:
            pickle.dumps(record)
        except Exception:
            continue
        records.append(record)
    emit_metric("view.export", len(records))
    return records


def ingest_artifacts(frame: Any, records: List[dict]) -> int:
    """Store exported ``records`` on ``frame``'s columns; how many were
    stored.  A record whose column position or length does not match the
    frame is skipped: an exported answer is never cached against other
    data."""
    from modin_tpu_torch.views.groupby_cache import adopt_guard

    cols = _frame_columns(frame)
    guard = None
    ingested = 0
    for record in records:
        pos = record["col"]
        if pos >= len(cols):
            continue
        col = cols[pos]
        if int(record["length"]) != int(col.length):
            continue
        state = record["state"]
        if isinstance(state, dict) and state.get("idents") == registry.ADOPT_IDENTS:
            if guard is None:
                guard = adopt_guard(frame._query_compiler._modin_frame)
            state = dict(state)
            state["adopt_guard"] = guard
        if registry.store(
            col, record["kind"], record["params"], state,
            can_fold=record.get("can_fold", False), host_bytes=int(record.get("host_bytes", 0)),
        ):
            ingested += 1
    if ingested:
        emit_metric("view.ingest", ingested)
    return ingested


def export_datasets(frames: Dict[str, Any]) -> Dict[str, List[dict]]:
    """``{dataset: records}`` over a whole dataset map."""
    return {name: export_artifacts(frame) for name, frame in frames.items()}


def ingest_datasets(frames: Dict[str, Any], exported: Dict[str, List[dict]]) -> int:
    """Ingest a multi-dataset export; the total stored."""
    total = 0
    for name, records in exported.items():
        frame = frames.get(name)
        if frame is not None:
            total += ingest_artifacts(frame, records)
    return total
