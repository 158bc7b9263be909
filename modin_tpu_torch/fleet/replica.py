"""A fleet replica: one supervised serving process.

The port's counterpart of ``modin_tpu/fleet/replica.py``, run as
``python -m modin_tpu_torch.fleet.replica`` by the coordinator alone.  Its
contract with the coordinator, all over the wire protocol (``wire.py``):

0. **The device.**  Before anything else the replica resolves
   ``modin_tpu_torch.get_device()`` from ``MODIN_TPU_TORCH_DEVICE``, which
   the coordinator set to its own device.  A replica told ``cuda`` that
   finds no card exits with code 2 before its hello: it never serves from
   the CPU, and the coordinator reports a failed spawn.
1. **Hello.**  Connect the control socket to ``MODIN_TPU_TORCH_FLEET_COORD``
   and announce ``{index, generation, pid, rpc_port, watch_port}``.  The RPC
   port is bound ephemeral here; the watch exporter's port was made
   ephemeral by the coordinator (``MODIN_TPU_TORCH_WATCH_PORT=0``) and the
   bound one is read back, so replicas on one host never collide.
2. **Heartbeats.**  A daemon thread sends the gate's shed rate and counters
   every ``MODIN_TPU_TORCH_FLEET_HEARTBEAT_S`` on the control socket; the
   shed rate is the backpressure the coordinator weighs redistribution
   by.  A dead control socket means the coordinator is gone: the replica
   exits rather than serve unsupervised.
3. **RPC.**  One connection a request on the RPC listener: ``ping``,
   ``warm`` (the manifest's reads through the public readers, then the
   view artifacts' ingest, then the durable feeds' recovery when
   ``MODIN_TPU_TORCH_FLEET_DURABILITY_DIR`` is set), ``query`` (one catalog
   or pickled query through the local ``serving.submit`` with the
   coordinator's remaining deadline), ``export_views``, ``snapshot`` and
   ``shutdown``.

Every answer to a query is typed: a result, a serialized ``QueryRejected``
or ``DeadlineExceeded``, or, for an untyped error that escaped (itself a
fault), an ``internal`` record the coordinator raises as a typed
rejection.  No ``except`` here answers with pandas: a device error of the
query reaches the coordinator as that record.  The replica never answers
with silence; silence is what the coordinator's detection is for.

The ``snapshot`` RPC also carries, beside the reference's serving and meter
snapshots, the compiler's count of pandas defaults, the kernel wrappers'
launch counts and lockdep's violations, which the card's smoke checks.
"""

from __future__ import annotations

import os
import socket
import threading
from typing import Any, Dict, Optional

from modin_tpu_torch.concurrency import named_lock
from modin_tpu_torch.fleet import wire

#: dataset name -> warmed frame (this process's working set)
_frames: Dict[str, Any] = {}
_frames_lock = named_lock("fleet.frames")

#: the hello and the heartbeats share one socket: its writes are serialized
_control_lock = named_lock("fleet.control")
_control_sock: Optional[socket.socket] = None

#: the observability context the service threads adopt (taken in main()
#: once the serving layer is imported)
_obs_span_stack: Any = None
_obs_scopes: Any = None


def _watch_port() -> int:
    """The watch exporter's bound port (-1 while it serves nothing)."""
    try:
        from modin_tpu_torch.observability import watch

        port = watch.httpd_port()
        return int(port) if port is not None else -1
    except Exception:
        return -1


def _heartbeat_loop(index: int, generation: int) -> None:
    import time

    from modin_tpu_torch.config import FleetHeartbeatS
    from modin_tpu_torch.observability import meters as _meters
    from modin_tpu_torch.observability import spans as _spans
    from modin_tpu_torch.serving.gate import gate

    _spans.seed_thread(_obs_span_stack)
    _meters.seed_thread_scopes(_obs_scopes)
    while True:
        time.sleep(float(FleetHeartbeatS.get()))
        snap = gate.snapshot()
        beat = {
            "type": "heartbeat",
            "index": index,
            "generation": generation,
            "shed_rate": snap["shed_rate"],
            "running": snap["running"],
            "shed": snap["shed"],
            "admitted": snap["admitted"],
            "completed": snap["completed"],
            "watch_port": _watch_port(),
        }
        try:
            with _control_lock:  # the lock serializes this socket's frames
                wire.send_msg(_control_sock, beat)
        except wire.WireError:
            os._exit(0)  # the coordinator is gone: never serve unsupervised


def _run_query(req: dict) -> dict:
    from modin_tpu_torch.serving import gate as gate_mod
    from modin_tpu_torch.serving.errors import DeadlineExceeded, QueryRejected

    with _frames_lock:
        frame = _frames.get(req["dataset"])
    if frame is None:
        return {"ok": False, "error": "rejected", "message": f"replica has no dataset {req['dataset']!r}",
                "reason": "unknown_dataset", "retry_after_s": None}
    try:
        result = gate_mod.submit(
            req["fn"], frame, *req.get("args", ()), tenant=req.get("tenant", "default"),
            deadline_ms=req.get("deadline_ms"), label=req.get("label"), **req.get("kwargs", {}),
        )
        return {"ok": True, "result": result}
    except QueryRejected as err:
        return {"ok": False, "error": "rejected", "message": str(err), "reason": err.reason,
                "retry_after_s": err.retry_after_s}
    except DeadlineExceeded as err:
        return {"ok": False, "error": "deadline", "message": str(err), "deadline_s": err.deadline_s,
                "where": err.where}
    except Exception as err:
        # an untyped error is a fault, but the answer on the wire is typed
        return {"ok": False, "error": "internal", "message": f"{type(err).__name__}: {err}"[:500]}


def _snapshot() -> dict:
    from modin_tpu_torch.concurrency import lockdep
    from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
    from modin_tpu_torch.observability import meters
    from modin_tpu_torch.ops.cuda import fused_kernels, groupagg_kernels, groupby_kernels, scan_kernels
    from modin_tpu_torch.serving.gate import serving_snapshot

    return {
        "ok": True,
        "serving": serving_snapshot(),
        "meters": meters.snapshot(),
        "defaults_to_pandas": int(tqc.DEFAULTS_TO_PANDAS),
        "launches": {name: int(m.LAUNCHES) for name, m in (
            ("bincount", groupby_kernels), ("scan", scan_kernels), ("fused", fused_kernels),
            ("groupagg", groupagg_kernels))},
        "lockdep": {"enabled": lockdep.enabled(), "violations": len(lockdep.violations())},
        "device": str(_device),
    }


def _handle_request(req: dict) -> dict:
    kind = req.get("type")
    if kind == "ping":
        return {"ok": True, "pid": os.getpid(), "datasets": sorted(_frames)}
    if kind == "warm":
        from modin_tpu_torch.config import FleetDurabilityDir, FleetTestCrash

        if FleetTestCrash.get() == "warm":
            os._exit(3)  # ReplicaFaultInjector's crash during a respawn
        from modin_tpu_torch.core.execution import recovery
        from modin_tpu_torch.views import exporter

        frames = recovery.warm_from_manifest(req.get("manifest", []))
        with _frames_lock:
            _frames.update(frames)
        ingested = exporter.ingest_datasets(_frames, req.get("views") or {})
        feeds_recovered = 0
        dur_dir = FleetDurabilityDir.get()
        if dur_dir:
            # a respawned replica comes back with its durable feeds and live
            # views (checkpoint and WAL replay), not only the manifest's
            from modin_tpu_torch import durability

            feeds_recovered = durability.recover_feeds(dur_dir)
        return {"ok": True, "datasets": sorted(_frames), "views_ingested": ingested,
                "feeds_recovered": feeds_recovered}
    if kind == "query":
        return _run_query(req)
    if kind == "export_views":
        from modin_tpu_torch.views import exporter

        with _frames_lock:
            frames = dict(_frames)
        return {"ok": True, "views": exporter.export_datasets(frames)}
    if kind == "snapshot":
        return _snapshot()
    if kind == "shutdown":
        return {"ok": True, "bye": True}
    return {"ok": False, "error": "internal", "message": f"unknown rpc {kind!r}"}


def _serve_connection(conn: socket.socket) -> None:
    from modin_tpu_torch.observability import meters as _meters
    from modin_tpu_torch.observability import spans as _spans

    _spans.seed_thread(_obs_span_stack)
    _meters.seed_thread_scopes(_obs_scopes)
    try:
        conn.settimeout(30.0)
        req = wire.recv_msg(conn)
        conn.settimeout(None)
        reply = _handle_request(req)
        wire.send_msg(conn, reply)
        if reply.get("bye"):
            conn.close()
            os._exit(0)
    except wire.WireError:
        pass  # the peer (or its query) died: nothing to answer
    finally:
        try:
            conn.close()
        except OSError:
            pass
        _meters.seed_thread_scopes(None)
        _spans.seed_thread(None)


_device: Any = None


def main() -> int:
    global _control_sock, _device, _obs_span_stack, _obs_scopes
    import sys

    import modin_tpu_torch
    from modin_tpu_torch.config import FleetCoordAddress, FleetReplicaGeneration, FleetReplicaIndex

    # the device first: without its card a replica never says hello
    try:
        _device = modin_tpu_torch.get_device()
        if _device.type == "cuda":
            import torch

            torch.empty(1, device=_device)  # the context, before "ready"
    except Exception as err:
        print(f"modin_tpu_torch fleet replica: no device to serve on: {err}", file=sys.stderr)
        return 2

    coord = FleetCoordAddress.get()
    index = int(FleetReplicaIndex.get())
    generation = int(FleetReplicaGeneration.get())
    host, _, port_text = coord.rpartition(":")

    # the serving layer before the hello: "hello" means "ready"
    import modin_tpu_torch.pandas  # noqa: F401
    import modin_tpu_torch.serving  # noqa: F401
    from modin_tpu_torch.observability import meters as _meters
    from modin_tpu_torch.observability import spans as _spans

    _obs_span_stack = _spans.snapshot_stack()
    _obs_scopes = _meters.snapshot_scopes()

    rpc = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    rpc.bind(("127.0.0.1", 0))
    rpc.listen(64)
    rpc_port = rpc.getsockname()[1]

    _control_sock = wire.connect(host, int(port_text), timeout=10.0)
    _control_sock.settimeout(None)
    with _control_lock:  # the lock serializes this socket's frames
        wire.send_msg(_control_sock, {
            "type": "hello", "index": index, "generation": generation, "pid": os.getpid(),
            "rpc_port": rpc_port, "watch_port": _watch_port(),
        })
    threading.Thread(
        target=_heartbeat_loop, args=(index, generation), name=f"modin-tpu-torch-fleet-heartbeat-{index}",
        daemon=True,
    ).start()

    while True:
        try:
            conn, _addr = rpc.accept()
        except OSError:
            return 0
        threading.Thread(
            target=_serve_connection, args=(conn,), name=f"modin-tpu-torch-fleet-rpc-{index}", daemon=True,
        ).start()


if __name__ == "__main__":
    raise SystemExit(main())
