"""The fleet coordinator: supervision, routing, drain and respawn.

The port's counterpart of ``modin_tpu/fleet/coordinator.py``.  One
``Coordinator`` a fleet-enabled process.  It owns:

- **the replica table**: N supervised ``python -m
  modin_tpu_torch.fleet.replica`` processes, each announced by a hello on
  the coordinator's control listener and tracked as ``(pid, generation,
  rpc_port, watch_port, last_heartbeat, shed_rate, latencies)``.  A replica
  runs on the coordinator's device: the spawn environment carries
  ``MODIN_TPU_TORCH_DEVICE`` as the coordinator resolved it, and a replica
  that exits before its hello (no card where ``cuda`` was asked for) is a
  failed spawn, never a replica on the CPU;
- **routing**: tenants stick to a replica; a new tenant goes to the live
  replica with the lowest ``(tenants + 1) * (1 + shed_rate)``, and every
  query is dispatched on a connection of its own with the *remaining*
  deadline riding along;
- **failure detection**, three ways: the process exits (``proc.poll``),
  its heartbeats go silent for about 3 intervals and a fresh liveness
  probe times out (a SIGSTOPped replica: socket alive, process wedged), or
  a dispatch hits a dead socket (connect refused, reset, closed mid-frame);
- **loss handling**: the lost replica is SIGKILLed (a stopped process must
  not wake up and serve stale state), its in-flight queries are
  interrupted and re-dispatched to a survivor when idempotent, its tenants
  drain onto the survivors weighted by each survivor's shed rate, and with
  ``MODIN_TPU_TORCH_FLEET_RESPAWN`` on a new generation respawns and warms
  from the dataset manifest and a survivor's exported view artifacts.

Nothing joins without bound: a query with a deadline ends typed at its
deadline, one without is capped by the join watchdog
(:data:`JOIN_WATCHDOG_S`).
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from modin_tpu_torch.concurrency import named_lock, named_rlock
from modin_tpu_torch.fleet import wire
from modin_tpu_torch.logging.metrics import emit_metric
from modin_tpu_torch.observability import meters as _meters
from modin_tpu_torch.observability import spans as _spans
from modin_tpu_torch.serving.errors import DeadlineExceeded, QueryRejected

#: Global join watchdog (seconds) for queries submitted WITHOUT a
#: deadline: the hard cap on one routed query's join, so a wedged replica
#: can never hang a caller that asked for no budget.
JOIN_WATCHDOG_S = 60.0

#: How long a respawned replica gets to say hello before the attempt is
#: abandoned and retried (imports + mesh build dominate this).
_HELLO_TIMEOUT_S = 60.0

#: Poll tick for interruptible joins (state/deadline checks while blocked).
_POLL_S = 0.25

#: How long ``stop`` waits, in all, for the accept, monitor and control
#: threads to end.
_STOP_JOIN_S = 10.0


class _DeadSocket(ConnectionError):
    """Internal: the replica's socket died under a dispatch."""


class _SpawnFailed(_DeadSocket):
    """Internal: a spawned replica exited, or stayed silent, before its hello."""


def _percentile(values: List[float], q: float) -> Optional[float]:
    if not values:
        return None
    ordered = sorted(values)
    idx = min(int(q * len(ordered)), len(ordered) - 1)
    return ordered[idx]


class _Replica:
    """Supervision record for one replica slot (index is stable across
    generations; everything else belongs to the current generation)."""

    def __init__(self, index: int):
        from modin_tpu_torch import fleet as _fleet

        _fleet._note_alloc()
        self.index = index
        self.generation = 0
        self.proc: Optional[subprocess.Popen] = None
        self.pid: Optional[int] = None
        self.rpc_port: Optional[int] = None
        self.watch_port: int = -1
        self.state = "spawning"  # spawning | up | lost | respawning | stopped
        self.last_heartbeat = 0.0
        self.shed_rate = 0.0
        self.heartbeat_counters: dict = {}
        self.hello_event = threading.Event()
        #: when the current generation was spawned, and its spawn-to-hello
        #: seconds (the port's own field: import, device and ports)
        self.spawned_t = 0.0
        self.hello_s: Optional[float] = None
        self.latencies: deque = deque(maxlen=512)
        self.inflight_socks: set = set()
        self.lock = named_lock("fleet.replica_state")

    def note_inflight(self, sock: socket.socket) -> None:
        with self.lock:
            self.inflight_socks.add(sock)

    def forget_inflight(self, sock: socket.socket) -> None:
        with self.lock:
            self.inflight_socks.discard(sock)

    def interrupt_inflight(self) -> None:
        """Close every in-flight dispatch socket: blocked joins on this
        replica fail over NOW instead of at their next poll tick."""
        with self.lock:
            socks = list(self.inflight_socks)
        for sock in socks:
            try:
                sock.close()
            except OSError:
                pass


class Coordinator:
    """The fleet control plane (see module docstring)."""

    def __init__(self, replicas: Optional[int] = None,
                 durability_dir: Optional[str] = None):
        from modin_tpu_torch import fleet as _fleet
        from modin_tpu_torch.config import FleetDurabilityDir, FleetReplicas

        _fleet._note_alloc()
        count = int(replicas if replicas is not None else FleetReplicas.get())
        #: the durable-feed root the replicas recover from when they warm
        #: (spawn and respawn); '' recovers none
        self._durability_dir = str(
            durability_dir if durability_dir is not None
            else FleetDurabilityDir.get()
        )
        self._lock = named_rlock("fleet.coordinator")
        self._replicas = [_Replica(i) for i in range(count)]
        self._assignments: Dict[str, int] = {}  # tenant -> replica index
        self._listener: Optional[socket.socket] = None
        self._control_port: Optional[int] = None
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._obs_span_stack: Any = None
        self._obs_scopes: Any = None
        self.routed = 0
        self.redispatched = 0
        self.lost_count = 0
        self.respawned_count = 0
        self.redistributed_count = 0
        self.respawn_failures = 0
        self._test_crash_next_respawn = False

    # -- lifecycle ------------------------------------------------------- #

    def start(self) -> None:
        # service threads adopt the starter's observability context so
        # their fleet.* metrics bill whoever brought the fleet up
        self._obs_span_stack = _spans.snapshot_stack()
        self._obs_scopes = _meters.snapshot_scopes()
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.bind(("127.0.0.1", 0))
        listener.listen(64)
        self._listener = listener
        self._control_port = listener.getsockname()[1]
        accept = threading.Thread(
            target=self._accept_loop, name="modin-tpu-torch-fleet-accept",
            daemon=True,
        )
        accept.start()
        self._threads.append(accept)
        for rep in self._replicas:
            self._spawn(rep)
        deadline = time.monotonic() + _HELLO_TIMEOUT_S
        for rep in self._replicas:
            try:
                self._await_hello(rep, max(deadline - time.monotonic(), 0.1))
            except _SpawnFailed as err:
                raise RuntimeError(str(err)) from None
        monitor = threading.Thread(
            target=self._monitor_loop, name="modin-tpu-torch-fleet-monitor",
            daemon=True,
        )
        monitor.start()
        self._threads.append(monitor)

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            reps = list(self._replicas)
        for rep in reps:
            rep.state = "stopped"
            rep.interrupt_inflight()
            if rep.pid is not None:
                try:
                    os.kill(rep.pid, signal.SIGKILL)
                except (OSError, ProcessLookupError):
                    pass
            if rep.proc is not None:
                try:
                    rep.proc.wait(timeout=10)
                except Exception:
                    pass
        if self._listener is not None:
            try:
                # a shutdown wakes the accept loop's blocked accept(); a
                # close alone leaves that thread waiting
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        # the service threads end on the stop flag, the listener's shutdown
        # or their replica's closed socket; stop returns once they have
        deadline = time.monotonic() + _STOP_JOIN_S
        for t in list(self._threads):
            if t is not threading.current_thread():
                t.join(timeout=max(deadline - time.monotonic(), 0.0))

    # -- spawn / hello / heartbeats -------------------------------------- #

    def _spawn(self, rep: _Replica) -> None:
        import modin_tpu_torch
        from modin_tpu_torch.config import Device

        env = dict(os.environ)
        # the replica imports the coordinator's modin_tpu_torch, wherever it
        # came from, whatever the child's working directory
        import_root = os.path.dirname(os.path.dirname(os.path.abspath(modin_tpu_torch.__file__)))
        env["PYTHONPATH"] = import_root + os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else import_root
        # the replica serves on the coordinator's device: a test that set
        # the CPU in this process reaches the child too, and a card asked
        # for is a card or no replica
        env["MODIN_TPU_TORCH_DEVICE"] = str(Device.get())
        env["MODIN_TPU_TORCH_FLEET"] = "0"  # replicas never nest fleets
        env["MODIN_TPU_TORCH_SERVING"] = "1"
        env["MODIN_TPU_TORCH_WATCH"] = "1"  # per-replica SLO attribution
        # whatever port this environment pins, every replica binds its
        # exporter ephemeral and reports the bound port back
        env["MODIN_TPU_TORCH_WATCH_PORT"] = "0"
        env["MODIN_TPU_TORCH_FLEET_COORD"] = f"127.0.0.1:{self._control_port}"
        env["MODIN_TPU_TORCH_FLEET_INDEX"] = str(rep.index)
        env["MODIN_TPU_TORCH_FLEET_GEN"] = str(rep.generation)
        # both ends keep one cadence, also when it was set by put()
        env["MODIN_TPU_TORCH_FLEET_HEARTBEAT_S"] = str(self._heartbeat_s())
        if self._durability_dir:
            # the replica recovers its durable feeds (checkpoint and WAL
            # replay) from this root when it warms
            env["MODIN_TPU_TORCH_FLEET_DURABILITY_DIR"] = self._durability_dir
            env["MODIN_TPU_TORCH_INGEST"] = "1"
        else:
            env.pop("MODIN_TPU_TORCH_FLEET_DURABILITY_DIR", None)
        if self._test_crash_next_respawn:
            env["MODIN_TPU_TORCH_FLEET_TEST_CRASH"] = "warm"
            self._test_crash_next_respawn = False
        else:
            env.pop("MODIN_TPU_TORCH_FLEET_TEST_CRASH", None)
        rep.hello_event.clear()
        rep.spawned_t = time.monotonic()
        rep.hello_s = None
        rep.proc = subprocess.Popen([sys.executable, "-m", "modin_tpu_torch.fleet.replica"], env=env)
        rep.pid = rep.proc.pid
        emit_metric("fleet.replica.spawn", 1)

    @staticmethod
    def _await_hello(rep: _Replica, timeout_s: float) -> None:
        """Wait for ``rep``'s hello; a replica that exits first (its device
        missing, an import failing) is a failed spawn, raised at once."""
        deadline = time.monotonic() + timeout_s
        while not rep.hello_event.wait(min(_POLL_S, max(deadline - time.monotonic(), 0.0))):
            code = rep.proc.poll() if rep.proc is not None else None
            if code is not None:
                raise _SpawnFailed(f"fleet replica {rep.index} exited with code {code} before its hello "
                                   f"(pid {rep.pid})")
            if time.monotonic() >= deadline:
                raise _SpawnFailed(f"fleet replica {rep.index} never said hello (pid {rep.pid})")

    def _accept_loop(self) -> None:
        _spans.seed_thread(self._obs_span_stack)
        _meters.seed_thread_scopes(self._obs_scopes)
        try:
            while not self._stop.is_set():
                try:
                    conn, _addr = self._listener.accept()
                except OSError:
                    return
                reader = threading.Thread(
                    target=self._control_reader, args=(conn,),
                    name="modin-tpu-torch-fleet-control", daemon=True,
                )
                reader.start()
                self._threads.append(reader)
        finally:
            _meters.seed_thread_scopes(None)
            _spans.seed_thread(None)

    def _control_reader(self, conn: socket.socket) -> None:
        """One replica's control stream: a hello, then heartbeats."""
        _spans.seed_thread(self._obs_span_stack)
        _meters.seed_thread_scopes(self._obs_scopes)
        rep: Optional[_Replica] = None
        try:
            conn.settimeout(30.0)
            hello = wire.recv_msg(conn)
            if hello.get("type") != "hello":
                return
            with self._lock:
                index = int(hello["index"])
                if not 0 <= index < len(self._replicas):
                    return
                rep = self._replicas[index]
                if int(hello["generation"]) != rep.generation:
                    return  # a stale generation's hello; its process is dead
                rep.rpc_port = int(hello["rpc_port"])
                rep.watch_port = int(hello["watch_port"])
                rep.pid = int(hello["pid"])
                rep.last_heartbeat = time.monotonic()
                rep.hello_s = rep.last_heartbeat - rep.spawned_t
                if rep.state == "spawning":
                    # first generation goes routable at hello; a RESPAWN
                    # stays "respawning" until its warm RPC succeeds
                    rep.state = "up"
            rep.hello_event.set()
            conn.settimeout(None)
            while not self._stop.is_set():
                beat = wire.recv_msg(conn)
                if beat.get("type") != "heartbeat":
                    continue
                if int(beat.get("generation", -1)) != rep.generation:
                    return  # a SIGCONT-resumed corpse; its successor owns the slot
                rep.last_heartbeat = time.monotonic()
                rep.shed_rate = float(beat.get("shed_rate", 0.0))
                rep.watch_port = int(beat.get("watch_port", rep.watch_port))
                rep.heartbeat_counters = {
                    k: beat[k]
                    for k in ("running", "shed", "admitted", "completed")
                    if k in beat
                }
        except wire.WireError:
            pass  # silence: the monitor's heartbeat-age leg takes over
        finally:
            try:
                conn.close()
            except OSError:
                pass
            _meters.seed_thread_scopes(None)
            _spans.seed_thread(None)

    # -- datasets -------------------------------------------------------- #

    def register_dataset(
        self, name: str, reader: str, args: tuple = (),
        kwargs: Optional[dict] = None,
    ) -> None:
        """Record the manifest entry and warm it onto every live replica."""
        from modin_tpu_torch.core.execution import recovery

        recovery.register_dataset(name, reader, args, kwargs)
        entry = [
            e for e in recovery.dataset_manifest() if e["name"] == str(name)
        ]
        for rep in self._up_replicas():
            try:
                reply = self._call(
                    rep,
                    {"type": "warm", "manifest": entry, "views": {}},
                    timeout=JOIN_WATCHDOG_S,
                )
            except (_DeadSocket, DeadlineExceeded):
                # A replica dying (or wedging past the watchdog) mid-warm is
                # a supervision event, not a registration failure: the
                # manifest entry is already recorded, so the respawn path
                # re-warms the slot from it.  Registration never leaks the
                # internal dead-socket signal to the caller.
                self._declare_lost(rep, "dead_socket")
                continue
            if not reply.get("ok"):
                raise RuntimeError(
                    f"replica {rep.index} failed to warm {name!r}: "
                    f"{reply.get('message')}"
                )

    # -- dispatch -------------------------------------------------------- #

    def _up_replicas(self) -> List[_Replica]:
        with self._lock:
            return [r for r in self._replicas if r.state == "up"]

    def _route(self, tenant: str) -> _Replica:
        with self._lock:
            idx = self._assignments.get(tenant)
            if idx is not None:
                rep = self._replicas[idx]
                if rep.state == "up":
                    return rep
            up = [r for r in self._replicas if r.state == "up"]
            if not up:
                raise QueryRejected(
                    f"no live replicas to route tenant {tenant!r}",
                    reason="no_replicas",
                    retry_after_s=self._heartbeat_s() * 3,
                )
            loads: Dict[int, int] = {}
            for t, i in self._assignments.items():
                loads[i] = loads.get(i, 0) + 1
            rep = min(
                up,
                key=lambda r: (
                    (loads.get(r.index, 0) + 1) * (1.0 + r.shed_rate),
                    r.index,
                ),
            )
            self._assignments[tenant] = rep.index
            return rep

    @staticmethod
    def _heartbeat_s() -> float:
        from modin_tpu_torch.config import FleetHeartbeatS

        return float(FleetHeartbeatS.get())

    def _call(
        self,
        rep: _Replica,
        msg: dict,
        timeout: float,
        deadline_t: Optional[float] = None,
        track: bool = False,
    ) -> dict:
        """One connection-per-request RPC with an interruptible join.

        The join polls every :data:`_POLL_S`: replica declared lost ->
        :class:`_DeadSocket`; caller deadline passed -> typed
        :class:`DeadlineExceeded`; watchdog passed -> the same, tagged
        ``fleet.watchdog``.  Dead sockets at ANY stage (connect, send,
        recv) raise :class:`_DeadSocket` for the caller's failover.
        """
        watchdog_t = time.monotonic() + timeout
        generation = rep.generation
        try:
            sock = wire.connect("127.0.0.1", rep.rpc_port, timeout=2.0)
        except OSError as err:
            raise _DeadSocket(f"connect to replica {rep.index}: {err}") from err
        if track:
            rep.note_inflight(sock)
        try:
            sock.settimeout(_POLL_S)

            def poll() -> None:
                now = time.monotonic()
                if rep.state in ("lost", "stopped") or rep.generation != generation:
                    raise _DeadSocket(
                        f"replica {rep.index} declared lost mid-query"
                    )
                if deadline_t is not None and now >= deadline_t:
                    raise DeadlineExceeded(
                        f"deadline expired joining replica {rep.index}",
                        where="fleet.join",
                    )
                if now >= watchdog_t:
                    raise DeadlineExceeded(
                        f"global join watchdog expired on replica "
                        f"{rep.index} after {timeout:g}s",
                        deadline_s=timeout,
                        where="fleet.watchdog",
                    )

            try:
                wire.send_msg(sock, msg)
                return wire.recv_msg(sock, poll=poll)
            except wire.WireError as err:
                raise _DeadSocket(str(err)) from err
        finally:
            if track:
                rep.forget_inflight(sock)
            try:
                sock.close()
            except OSError:
                pass

    def submit(
        self,
        dataset: str,
        fn: Any,
        args: tuple = (),
        kwargs: Optional[dict] = None,
        tenant: str = "default",
        deadline_ms: Optional[float] = None,
        label: Optional[str] = None,
        idempotent: bool = True,
    ) -> Any:
        """Route one query; see ``fleet.submit`` for the public contract."""
        start = time.monotonic()
        deadline_t = (
            start + deadline_ms / 1e3
            if deadline_ms is not None and deadline_ms > 0
            else None
        )
        attempts = len(self._replicas) + 1
        for attempt in range(attempts):
            rep = self._route(tenant)
            remaining_ms = deadline_ms
            if deadline_t is not None:
                remaining_s = deadline_t - time.monotonic()
                if remaining_s <= 0:
                    raise DeadlineExceeded(
                        "deadline expired before dispatch",
                        where="fleet.dispatch",
                    )
                remaining_ms = remaining_s * 1e3
            msg = {
                "type": "query",
                "dataset": dataset,
                "fn": fn,
                "args": tuple(args),
                "kwargs": dict(kwargs or {}),
                "tenant": tenant,
                "deadline_ms": remaining_ms,
                "label": label,
            }
            t0 = time.monotonic()
            try:
                reply = self._call(
                    rep, msg, timeout=JOIN_WATCHDOG_S,
                    deadline_t=deadline_t, track=True,
                )
            except _DeadSocket:
                self._declare_lost(rep, "dead_socket")
                if idempotent and attempt + 1 < attempts:
                    emit_metric("fleet.query.redispatch", 1)
                    with self._lock:
                        self.redispatched += 1
                    continue
                raise QueryRejected(
                    f"replica {rep.index} died mid-query and the query is "
                    f"not idempotent-by-lineage",
                    reason="replica_lost",
                    retry_after_s=self._heartbeat_s() * 3,
                )
            wall_s = time.monotonic() - t0
            rep.latencies.append(wall_s)
            with self._lock:
                self.routed += 1
            emit_metric("fleet.query.routed", 1)
            self._observe_replica(rep, wall_s, reply)
            return self._decode(reply)
        raise QueryRejected(  # unreachable backstop: _route raises first
            "no replica completed the query", reason="no_replicas"
        )

    @staticmethod
    def _observe_replica(rep: _Replica, wall_s: float, reply: dict) -> None:
        """Per-replica SLO attribution: the coordinator's watch service
        tracks each replica as a pseudo-tenant (one module-attr check
        when watch is off, the established contract)."""
        from modin_tpu_torch.observability import watch as _watch

        if _watch.WATCH_ON:
            failure = None if reply.get("ok") else reply.get("error")
            _watch.observe_query(f"replica{rep.index}", wall_s, failure)

    @staticmethod
    def _decode(reply: dict) -> Any:
        if reply.get("ok"):
            return reply["result"]
        kind = reply.get("error")
        if kind == "rejected":
            raise QueryRejected(
                reply.get("message", "rejected by replica"),
                reason=reply.get("reason", "queue_full"),
                retry_after_s=reply.get("retry_after_s"),
            )
        if kind == "deadline":
            raise DeadlineExceeded(
                reply.get("message", "deadline exceeded on replica"),
                deadline_s=reply.get("deadline_s", 0.0),
                where=reply.get("where", ""),
            )
        raise QueryRejected(
            f"replica error: {reply.get('message', 'unknown')}",
            reason="replica_error",
        )

    # -- failure detection & recovery ------------------------------------ #

    def _declare_lost(self, rep: _Replica, reason: str) -> None:
        with self._lock:
            if rep.state != "up":
                return  # another observer already handled it
            rep.state = "lost"
            self.lost_count += 1
            # drain in the same critical section: a drained tenant's next
            # query would otherwise re-home it in _route first, and the
            # drain would find (and count) nothing
            moved = self._redistribute_locked(rep.index)
        # SIGKILL outside the lock: a SIGSTOPped replica must never SIGCONT
        # back to life and serve stale state (SIGKILL applies to stopped
        # processes too)
        if rep.pid is not None:
            try:
                os.kill(rep.pid, signal.SIGKILL)
            except (OSError, ProcessLookupError):
                pass
        emit_metric("fleet.replica.lost", 1)
        rep.interrupt_inflight()
        if moved:
            emit_metric("fleet.drain.redistributed", moved)

    def _redistribute(self, dead_index: int) -> None:
        """Drain the dead replica's tenants onto survivors, weighted-fair
        with each survivor's typed-shed rate as the backpressure signal:
        a shedding survivor absorbs fewer drained tenants."""
        with self._lock:
            moved = self._redistribute_locked(dead_index)
        if moved:
            emit_metric("fleet.drain.redistributed", moved)

    def _redistribute_locked(self, dead_index: int) -> int:
        """The drain of :meth:`_redistribute` (caller holds the lock); the
        tenants moved."""
        drained = sorted(t for t, i in self._assignments.items() if i == dead_index)
        survivors = [r for r in self._replicas if r.state == "up"]
        if not survivors:
            for tenant in drained:
                self._assignments.pop(tenant, None)
            return 0
        loads: Dict[int, int] = {}
        for t, i in self._assignments.items():
            if i != dead_index:
                loads[i] = loads.get(i, 0) + 1
        for tenant in drained:
            target = min(
                survivors,
                key=lambda r: ((loads.get(r.index, 0) + 1) * (1.0 + r.shed_rate), r.index),
            )
            self._assignments[tenant] = target.index
            loads[target.index] = loads.get(target.index, 0) + 1
        self.redistributed_count += len(drained)
        return len(drained)

    def _probe(self, rep: _Replica) -> bool:
        """Fresh-dial liveness probe: can the replica still answer a ping?
        (A SIGSTOPped process accepts the connect, on the kernel's backlog,
        and never answers: the wedge this catches.)"""
        timeout = max(self._heartbeat_s() * 2, 1.0)
        try:
            reply = self._call(rep, {"type": "ping"}, timeout=timeout)
            return bool(reply.get("ok"))
        except (_DeadSocket, DeadlineExceeded):
            return False

    def _monitor_loop(self) -> None:
        _spans.seed_thread(self._obs_span_stack)
        _meters.seed_thread_scopes(self._obs_scopes)
        try:
            while not self._stop.wait(self._heartbeat_s() / 2):
                hb = self._heartbeat_s()
                with self._lock:
                    reps = list(self._replicas)
                for rep in reps:
                    if self._stop.is_set():
                        return
                    if rep.state == "up":
                        if (
                            rep.proc is not None
                            and rep.proc.poll() is not None
                        ):
                            self._declare_lost(rep, "exit")
                        elif time.monotonic() - rep.last_heartbeat > 3 * hb:
                            emit_metric("fleet.replica.heartbeat_miss", 1)
                            if not self._probe(rep):
                                self._declare_lost(rep, "heartbeat")
                    elif rep.state == "lost" and self._respawn_enabled():
                        self._respawn(rep)
        finally:
            _meters.seed_thread_scopes(None)
            _spans.seed_thread(None)

    @staticmethod
    def _respawn_enabled() -> bool:
        from modin_tpu_torch.config import FleetRespawn

        return bool(FleetRespawn.get())

    def _export_views_from_survivor(self) -> Dict[str, List[dict]]:
        """A healthy survivor's view artifact export (best-effort:
        warm answers are an optimization, never a respawn blocker)."""
        for rep in self._up_replicas():
            try:
                reply = self._call(
                    rep, {"type": "export_views"}, timeout=JOIN_WATCHDOG_S
                )
                if reply.get("ok"):
                    return reply.get("views", {})
            except (_DeadSocket, DeadlineExceeded):
                continue
        return {}

    def _respawn(self, rep: _Replica) -> None:
        """Fresh generation: spawn, hello, warm (manifest + survivor's
        artifacts), then route to it again.  Any failure returns the slot
        to ``lost`` and the next monitor tick retries."""
        from modin_tpu_torch.core.execution import recovery

        with self._lock:
            if rep.state != "lost":
                return
            rep.state = "respawning"
            rep.generation += 1
            rep.shed_rate = 0.0
            rep.latencies.clear()
        if rep.proc is not None:
            try:
                rep.proc.wait(timeout=10)
            except Exception:
                pass
        try:
            self._spawn(rep)
            self._await_hello(rep, _HELLO_TIMEOUT_S)
            views = self._export_views_from_survivor()
            reply = self._call(
                rep,
                {
                    "type": "warm",
                    "manifest": recovery.dataset_manifest(),
                    "views": views,
                },
                timeout=JOIN_WATCHDOG_S,
            )
            if not reply.get("ok"):
                raise _DeadSocket(
                    f"respawned replica {rep.index} failed to warm: "
                    f"{reply.get('message')}"
                )
        except (_DeadSocket, DeadlineExceeded, OSError):
            with self._lock:
                rep.state = "lost"
                self.respawn_failures += 1
            if rep.pid is not None:
                try:
                    os.kill(rep.pid, signal.SIGKILL)
                except (OSError, ProcessLookupError):
                    pass
            return
        with self._lock:
            rep.state = "up"
            rep.last_heartbeat = time.monotonic()
            self.respawned_count += 1
        emit_metric("fleet.replica.respawned", 1)

    # -- introspection ---------------------------------------------------- #

    def snapshot(self) -> dict:
        """The replica table + routing counters (serving_snapshot and the
        /statusz fleet section render exactly this)."""
        with self._lock:
            rows = []
            for rep in self._replicas:
                lat = list(rep.latencies)
                p50 = _percentile(lat, 0.50)
                p99 = _percentile(lat, 0.99)
                rows.append(
                    {
                        "index": rep.index,
                        "state": rep.state,
                        "generation": rep.generation,
                        "pid": rep.pid,
                        "rpc_port": rep.rpc_port,
                        "watch_port": rep.watch_port,
                        "tenants": sum(
                            1
                            for i in self._assignments.values()
                            if i == rep.index
                        ),
                        "in_flight": len(rep.inflight_socks),
                        "shed_rate": rep.shed_rate,
                        "heartbeat_age_s": (
                            round(time.monotonic() - rep.last_heartbeat, 3)
                            if rep.last_heartbeat
                            else None
                        ),
                        "p50_ms": None if p50 is None else p50 * 1e3,
                        "p99_ms": None if p99 is None else p99 * 1e3,
                        "counters": dict(rep.heartbeat_counters),
                        "hello_s": rep.hello_s,
                    }
                )
            return {
                "replicas": rows,
                "assignments": dict(self._assignments),
                "routed": self.routed,
                "redispatched": self.redispatched,
                "lost": self.lost_count,
                "respawned": self.respawned_count,
                "redistributed": self.redistributed_count,
                "respawn_failures": self.respawn_failures,
                "control_port": self._control_port,
            }
