"""The replicated serving fleet.

The port's counterpart of ``modin_tpu/fleet/``.  A coordinator
(:mod:`modin_tpu_torch.fleet.coordinator`) supervises N replica serving
processes (:mod:`modin_tpu_torch.fleet.replica`), each with its own
admission gate and watch exporter on an ephemeral port, on the
coordinator's device (on one card, every replica shares ``cuda:0``, each
with its own CUDA context and its own copy of the datasets).  Tenant
queries route over local socket RPC with the deadline riding along; a lost
replica is detected three ways (heartbeat silence with a failed liveness
probe, process exit, a dead socket under a dispatch), its tenants drain
onto the survivors weighted by their shed rates, and a new generation
respawns and warms from the dataset manifest (the public readers again, so
io lineage, spans and costs see the replay) and a survivor's exported view
artifacts.

Off (``MODIN_TPU_TORCH_FLEET=0``, the default): no coordinator, no socket,
no thread; ``submit`` reads one attribute and runs the local serving path,
and ``fleet_alloc_count()`` stays 0.

    import modin_tpu_torch.fleet as fleet
    from modin_tpu_torch.config import FleetEnabled

    FleetEnabled.put(True)
    fleet.start_fleet(3)
    fleet.register_dataset("ds", "read_parquet", "/data/ds.parquet")
    fleet.submit("ds", "groupby_sum", tenant="alice")
"""

from __future__ import annotations

from typing import Any, Dict, Optional

#: True while MODIN_TPU_TORCH_FLEET is on: the one attribute a hook reads
FLEET_ON: bool = False

#: fleet objects ever made (the coordinator, its replica records)
_alloc_count: int = 0

#: this process's coordinator (one a fleet-enabled process)
_coordinator: Optional[Any] = None

#: the fleet-off working set: dataset name -> the frame read here, so the
#: two modes answer the same ``submit`` calls bit for bit
_local_frames: Dict[str, Any] = {}


def _note_alloc() -> None:
    global _alloc_count
    _alloc_count += 1


def fleet_alloc_count() -> int:
    """Fleet objects this process ever made (0 while the fleet never ran)."""
    return _alloc_count


def get_coordinator() -> Optional[Any]:
    """The live coordinator, or None (fleet off, never started, or a
    replica process)."""
    return _coordinator


def start_fleet(replicas: Optional[int] = None) -> Any:
    """Spawn and supervise the replicas; once a process.  Needs
    ``MODIN_TPU_TORCH_FLEET=1``; ``replicas`` defaults to
    ``MODIN_TPU_TORCH_FLEET_REPLICAS``.  Returns once every replica said
    hello (its device resolved, its serving layer imported, its ports
    bound); a replica that exits first raises ``RuntimeError``."""
    global _coordinator
    if not FLEET_ON:
        raise RuntimeError("MODIN_TPU_TORCH_FLEET is off; enable it (or FleetEnabled.enable()) before start_fleet()")
    if _coordinator is not None:
        return _coordinator
    from modin_tpu_torch.fleet.coordinator import Coordinator

    coord = Coordinator(replicas)
    try:
        coord.start()
    except Exception:
        coord.stop()
        raise
    _coordinator = coord
    return coord


def stop_fleet() -> None:
    """Tear the fleet down (kill the replicas, close the sockets)."""
    global _coordinator
    coord = _coordinator
    _coordinator = None
    if coord is not None:
        coord.stop()


def register_dataset(name: str, reader: str, *args: Any, **kwargs: Any) -> None:
    """Register a serving dataset: ``reader`` (a ``modin_tpu_torch.pandas``
    reader's name, e.g. ``"read_parquet"``) applied to ``args``/``kwargs``.

    The entry lands in the recovery manifest either way: a respawned
    replica warms from it.  Fleet on: every live replica reads it now.
    Fleet off: it is read here, through the same public reader."""
    if FLEET_ON and _coordinator is not None:
        _coordinator.register_dataset(name, reader, tuple(args), dict(kwargs))
        return
    from modin_tpu_torch.core.execution import recovery

    recovery.register_dataset(name, reader, tuple(args), dict(kwargs))
    import modin_tpu_torch.pandas as _tpd

    fn = getattr(_tpd, reader, None)
    if fn is None or not callable(fn):
        raise ValueError(f"unknown modin_tpu_torch.pandas reader {reader!r}")
    _local_frames[str(name)] = fn(*args, **kwargs)


def submit(
    dataset: str,
    query: Any,
    *args: Any,
    tenant: str = "default",
    deadline_ms: Optional[float] = None,
    label: Optional[str] = None,
    idempotent: bool = True,
    **kwargs: Any,
) -> Any:
    """Run one query on a registered dataset, routed by the fleet when on.

    ``query`` is a name of :mod:`modin_tpu_torch.fleet.queries` or a
    module-level picklable callable ``fn(frame, *args, **kwargs)``.  The
    outcome is typed: the (host) result, ``QueryRejected`` or
    ``DeadlineExceeded``, never a hang (the deadline rides along and the
    coordinator's join watchdog caps the rest) and never an untyped error.
    ``idempotent`` declares the query safe to send again to a survivor if
    its replica dies under it (every catalog query is); otherwise that
    death raises ``QueryRejected(reason="replica_lost")``."""
    from modin_tpu_torch.fleet import queries as _queries

    fn = _queries.resolve(query)
    if label is None and isinstance(query, str):
        label = query
    if FLEET_ON and _coordinator is not None:
        return _coordinator.submit(
            str(dataset), fn, args=tuple(args), kwargs=dict(kwargs), tenant=tenant, deadline_ms=deadline_ms,
            label=label, idempotent=idempotent,
        )
    frame = _local_frames.get(str(dataset))
    if frame is None:
        from modin_tpu_torch.serving.errors import QueryRejected

        raise QueryRejected(f"no dataset {dataset!r} registered", reason="unknown_dataset")
    from modin_tpu_torch.serving import gate as _gate

    return _gate.submit(fn, frame, *args, tenant=tenant, deadline_ms=deadline_ms, label=label, **kwargs)


def fleet_snapshot() -> dict:
    """The switch, the coordinator's replica table and routing counters
    (empty where no coordinator lives in this process)."""
    snap = {
        "enabled": FLEET_ON,
        "active": _coordinator is not None,
        "alloc_count": _alloc_count,
        "local_datasets": sorted(_local_frames),
    }
    if _coordinator is not None:
        snap.update(_coordinator.snapshot())
    return snap


def reset_for_tests() -> None:
    """Tear any fleet down and clear the local working set (the alloc count
    stays: it counts the process's lifetime)."""
    stop_fleet()
    _local_frames.clear()


def _on_fleet_enabled(param: Any) -> None:
    global FLEET_ON
    FLEET_ON = bool(param.get())


from modin_tpu_torch.config import FleetEnabled as _FleetEnabled  # noqa: E402

_FleetEnabled.subscribe(_on_fleet_enabled)
