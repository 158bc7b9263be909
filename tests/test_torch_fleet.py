"""The port's replicated serving fleet against the JAX package's.

Held to the JAX package on the same seeded inputs: the wire frames byte for
byte, the catalog queries' answers on a seeded frame, routing,
redistribution and the typed decode, the exported view artifacts (kinds,
params, lengths, states) for the same frame and queries, and the dataset
manifest's entries.

The port's own legs: an exported record ingested onto a fresh frame
answers with no kernel call and never for a frame whose rows differ; the
spawn environment carries the coordinator's device and the durability
root; a replica told ``cuda`` with no card exits before its hello and the
coordinator reports a failed spawn; and one real fleet on the CPU (2
replicas, queries, a kill -9, the respawn and its re-warm from the
manifest and a survivor's views).  Every wait there has its own deadline,
and a ``finally`` stops the fleet and SIGKILLs any replica left.
"""

import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pandas
import pytest

import modin_tpu.fleet as j_fleet
import modin_tpu.pandas as mpd
from modin_tpu import config as jcfg
from modin_tpu.core.execution import recovery as j_recovery
from modin_tpu.fleet import coordinator as j_coord
from modin_tpu.fleet import queries as j_queries
from modin_tpu.fleet import wire as j_wire
from modin_tpu.serving.errors import DeadlineExceeded as JDeadline
from modin_tpu.serving.errors import QueryRejected as JRejected
from modin_tpu.views import exporter as j_exporter
from modin_tpu.views import registry as j_registry

import modin_tpu_torch
import modin_tpu_torch.fleet as t_fleet
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch import config as tcfg
from modin_tpu_torch.concurrency import lockdep as t_lockdep
from modin_tpu_torch.core.execution import recovery as t_recovery
from modin_tpu_torch.core.execution import resilience as t_res
from modin_tpu_torch.fleet import coordinator as t_coord
from modin_tpu_torch.fleet import queries as t_queries
from modin_tpu_torch.fleet import wire as t_wire
from modin_tpu_torch.ops.cuda import fused_kernels, groupagg_kernels, groupby_kernels
from modin_tpu_torch.serving.errors import DeadlineExceeded as TDeadline
from modin_tpu_torch.serving.errors import QueryRejected as TRejected
from modin_tpu_torch.serving.gate import gate as t_gate
from modin_tpu_torch.serving import tenants as t_tenants
from modin_tpu_torch.testing import ReplicaFaultInjector
from modin_tpu_torch.views import exporter as t_exporter
from modin_tpu_torch.views import registry as t_registry

JAX = types.SimpleNamespace(name="jax", fleet=j_fleet, coord=j_coord, queries=j_queries, wire=j_wire, cfg=jcfg,
                            recovery=j_recovery, exporter=j_exporter, registry=j_registry, pd=mpd,
                            Rejected=JRejected, Deadline=JDeadline)
PORT = types.SimpleNamespace(name="port", fleet=t_fleet, coord=t_coord, queries=t_queries, wire=t_wire, cfg=tcfg,
                             recovery=t_recovery, exporter=t_exporter, registry=t_registry, pd=tpd,
                             Rejected=TRejected, Deadline=TDeadline)
PACKAGES = (JAX, PORT)

_KNOBS = ("FleetEnabled", "FleetReplicas", "FleetHeartbeatS", "FleetRespawn", "ServingEnabled")

#: the real fleet's waits, each its own (the hello's is the coordinator's)
_RESPAWN_S = 60.0
_QUERY_TIMEOUT_S = 30.0


@pytest.fixture(autouse=True)
def _clean_state():
    modin_tpu_torch.set_device("cpu")
    saved = [(getattr(P.cfg, k), getattr(P.cfg, k).get()) for P in PACKAGES for k in _KNOBS]
    saved.append((tcfg.Device, tcfg.Device.get()))
    for P in PACKAGES:
        P.recovery.reset_for_tests()
        P.registry.reset()
    t_lockdep.enable(strict=True)
    yield
    recorded = t_lockdep.violations()
    t_lockdep.disable()
    t_lockdep.reset_violations()
    for P in PACKAGES:
        P.fleet.reset_for_tests()
        P.recovery.reset_for_tests()
        P.registry.reset()
    for p, v in saved:
        p.put(v)
    t_gate.reset_for_tests()
    t_tenants.registry.reset()
    t_res.reset_breakers()
    assert not recorded, "\n".join(v.render() for v in recorded)


def _fleet_threads():
    return [t.name for t in threading.enumerate() if t.name.startswith("modin-tpu-torch-fleet")]


def _frame(seed, n=3000):
    rng = np.random.default_rng(seed)
    return pandas.DataFrame({
        "k": rng.integers(0, 40, n).astype(np.int64),
        "i": rng.integers(-500, 500, n).astype(np.int64),
        "x": rng.normal(size=n),
    })


def _same(got, want, what):
    """Ints and counts exactly; float sums and means to rtol 1e-12."""
    if isinstance(want, pandas.DataFrame):
        pandas.testing.assert_frame_equal(got, want, check_exact=False, rtol=1e-12, atol=0, obj=what)
    else:
        pandas.testing.assert_series_equal(got, want, check_exact=False, rtol=1e-12, atol=0, obj=what)


# ---------------------------------------------------------------------- #
# the fleet off
# ---------------------------------------------------------------------- #


def test_off_is_the_local_serving_path_with_nothing_made(tmp_path):
    pdf = _frame(1)
    path = str(tmp_path / "ds.parquet")
    pdf.to_parquet(path)
    before = t_fleet.fleet_alloc_count()
    assert not t_fleet.FLEET_ON
    t_fleet.register_dataset("ds", "read_parquet", path)
    ref = pandas.read_parquet(path)
    frame = t_fleet._local_frames["ds"]
    for name, fn in t_queries.QUERIES.items():
        got = t_fleet.submit("ds", name, tenant="t0")
        local = fn(frame)
        (pandas.testing.assert_frame_equal if isinstance(got, pandas.DataFrame)
         else pandas.testing.assert_series_equal)(got, local, check_exact=True)
        _same(got, getattr(j_queries, fn.__name__)(ref), name)
    assert t_fleet.fleet_alloc_count() == before and _fleet_threads() == []
    assert [e["name"] for e in t_recovery.dataset_manifest()] == ["ds"]
    snap = t_fleet.fleet_snapshot()
    assert snap["enabled"] is False and snap["active"] is False and snap["local_datasets"] == ["ds"]


def test_off_refusals_are_typed():
    with pytest.raises(TRejected) as exc:
        t_fleet.submit("nope", "sum")
    assert exc.value.reason == "unknown_dataset"
    with pytest.raises(ValueError):
        t_fleet.register_dataset("ds", "read_nothing")
    with pytest.raises(KeyError):
        t_queries.resolve("no_such_query")
    with pytest.raises(RuntimeError):
        t_fleet.start_fleet()
    tcfg.FleetEnabled.put(True)
    assert t_fleet.FLEET_ON
    tcfg.FleetEnabled.put(False)
    assert not t_fleet.FLEET_ON


# ---------------------------------------------------------------------- #
# the wire, byte for byte
# ---------------------------------------------------------------------- #


def _payloads(seed):
    rng = np.random.default_rng(seed)
    return [
        {"type": "hello", "index": int(rng.integers(0, 9)), "generation": 0, "pid": 4242, "rpc_port": 50000,
         "watch_port": -1},
        {"type": "heartbeat", "shed_rate": float(rng.random()), "running": 2, "shed": 0, "admitted": 7},
        {"ok": True, "result": pandas.Series(rng.normal(size=5), index=list("abcde"))},
        {"ok": False, "error": "rejected", "message": "queue full", "reason": "queue_full", "retry_after_s": 0.5},
        {"x": rng.integers(0, 100, 1000), "s": "hello" * int(rng.integers(1, 50))},
    ]


def _frames_of(wire, payload):
    a, b = socket.socketpair()
    try:
        wire.send_msg(a, payload)
        a.close()
        chunks = []
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                break
            chunks.append(chunk)
        return b"".join(chunks)
    finally:
        b.close()


@pytest.mark.parametrize("seed", range(3))
def test_wire_frames_match_the_jax_package_byte_for_byte(seed):
    for payload in _payloads(seed):
        t_bytes, j_bytes = _frames_of(t_wire, payload), _frames_of(j_wire, payload)
        assert t_bytes == j_bytes
        assert t_wire._LEN.unpack(t_bytes[:4])[0] == len(t_bytes) - 4
        # each package reads the other's frame to the same object
        got = []
        for frame_bytes, reader in ((t_bytes, j_wire), (j_bytes, t_wire)):
            a, b = socket.socketpair()
            try:
                a.sendall(frame_bytes)
                got.append(pickle.dumps(reader.recv_msg(b)))
            finally:
                a.close()
                b.close()
        assert got[0] == got[1]


def test_wire_refuses_oversize_and_dead_peers_and_polls():
    a, b = socket.socketpair()
    try:
        a.sendall(t_wire._LEN.pack(t_wire.MAX_FRAME_BYTES + 1))
        with pytest.raises(t_wire.WireError, match="cap exceeded"):
            t_wire.recv_msg(b)
    finally:
        a.close()
        b.close()
    a, b = socket.socketpair()
    a.sendall(t_wire._LEN.pack(1 << 20) + b"partial")
    a.close()
    with pytest.raises(t_wire.WireError, match="closed mid-frame"):
        t_wire.recv_msg(b)
    b.close()
    a, b = socket.socketpair()
    try:
        b.settimeout(0.01)

        class Lost(Exception):
            pass

        def poll():
            raise Lost()

        with pytest.raises(Lost):
            t_wire.recv_msg(b, poll=poll)
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------- #
# the catalog, both packages on one seeded frame
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("name", sorted(t_queries.QUERIES))
def test_catalog_answers_match_the_jax_package_and_pandas(name):
    pdf = _frame(7)
    got = t_queries.QUERIES[name](tpd.DataFrame(pdf))
    jax = j_queries.QUERIES[name](mpd.DataFrame(pdf))
    want = j_queries.QUERIES[name](pdf)
    assert type(got) is type(want)
    _same(got, jax, f"{name} against the JAX package")
    _same(got, want, f"{name} against pandas")
    # by reference across the socket
    assert pickle.loads(pickle.dumps(t_queries.QUERIES[name])) is t_queries.QUERIES[name]


# ---------------------------------------------------------------------- #
# routing, redistribution, decode: the same scenarios through both
# ---------------------------------------------------------------------- #


def _coordinator(P, n=3, up=(), shed=None):
    coord = P.coord.Coordinator(replicas=n)
    for idx in up:
        coord._replicas[idx].state = "up"
    for idx, rate in (shed or {}).items():
        coord._replicas[idx].shed_rate = rate
    return coord


def _routing(P, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 6))
    shed = {i: float(rng.choice([0.0, 0.0, 0.5, 0.9, 3.0])) for i in range(n)}
    coord = _coordinator(P, n=n, up=range(n), shed=shed)
    tenants = [f"t{int(rng.integers(0, 12))}" for _ in range(30)]
    routed = [coord._route(t).index for t in tenants]
    dead = int(rng.integers(0, n))
    coord._replicas[dead].state = "lost"
    coord._redistribute(dead)
    after = [coord._route(t).index for t in tenants]
    snap = coord.snapshot()
    rows = [{k: r[k] for k in ("index", "state", "generation", "tenants", "in_flight", "shed_rate")}
            for r in snap["replicas"]]
    return routed, after, dict(coord._assignments), coord.redistributed_count, rows


@pytest.mark.parametrize("seed", range(6))
def test_routing_and_redistribution_match_the_jax_package(seed):
    assert _routing(PORT, seed) == _routing(JAX, seed)


@pytest.mark.parametrize("P", PACKAGES, ids=lambda P: P.name)
def test_redistribution_weighs_shed_rates(P):
    coord = _coordinator(P, up=(0, 1, 2), shed={1: 0.9})
    coord._assignments = {"a": 0, "b": 0}
    coord._replicas[0].state = "lost"
    coord._redistribute(0)
    assert coord._assignments == {"a": 2, "b": 1}
    coord = _coordinator(P, up=(0,))
    coord._assignments = {"a": 0}
    coord._replicas[0].state = "lost"
    coord._redistribute(0)
    assert coord._assignments == {}
    with pytest.raises(P.Rejected) as exc:
        _coordinator(P, up=())._route("tA")
    assert exc.value.reason == "no_replicas" and exc.value.retry_after_s > 0


_REPLIES = [
    {"ok": True, "result": 42},
    {"ok": False, "error": "rejected", "message": "queue full on replica", "reason": "queue_full",
     "retry_after_s": 1.5},
    {"ok": False, "error": "deadline", "message": "blew the budget", "deadline_s": 0.25, "where": "gate.dispatch"},
    {"ok": False, "error": "internal", "message": "boom"},
    {"ok": False, "error": "rejected"},
]


def _decoded(P, reply):
    try:
        return ("ok", P.coord.Coordinator._decode(reply))
    except P.Rejected as err:
        return ("rejected", str(err), err.reason, err.retry_after_s)
    except P.Deadline as err:
        return ("deadline", str(err), err.deadline_s, err.where)


@pytest.mark.parametrize("i", range(len(_REPLIES)))
def test_decode_matches_the_jax_package(i):
    assert _decoded(PORT, _REPLIES[i]) == _decoded(JAX, _REPLIES[i])


def test_a_drained_tenant_routed_during_the_loss_is_counted(monkeypatch):
    """The loss and the drain are one critical section: a drained tenant's
    query routed while the loss is being handled (here: at the loss's own
    metric) finds it already re-homed, and the drain counts it.  The JAX
    package drains after the lock is released, so such a query re-homes
    the tenant itself and the drain counts nothing."""
    coord = _coordinator(PORT, up=(0, 1, 2))
    coord._assignments = {"a": 0, "b": 1}
    routed = []
    real_emit = t_coord.emit_metric

    def emit(name, value):
        if name == "fleet.replica.lost":
            routed.append(coord._route("a").index)
        real_emit(name, value)

    monkeypatch.setattr(t_coord, "emit_metric", emit)
    coord._replicas[0].pid = None
    coord._declare_lost(coord._replicas[0], "test")
    assert routed == [2] and coord._assignments == {"a": 2, "b": 1}
    assert coord.redistributed_count == 1 and coord.lost_count == 1


def test_lost_is_declared_once_and_a_dead_warm_never_leaks():
    coord = _coordinator(PORT, up=(0, 1))
    rep = coord._replicas[0]
    coord._declare_lost(rep, "test")
    coord._declare_lost(rep, "test")
    assert rep.state == "lost" and coord.lost_count == 1
    coord = _coordinator(PORT, up=(0,))
    rep = coord._replicas[0]
    probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    probe.bind(("127.0.0.1", 0))
    rep.rpc_port = probe.getsockname()[1]
    probe.close()  # nothing listens: the connect dies like a killed peer's
    coord.register_dataset("warm_death_ds", "read_csv", ("/nonexistent.csv",), {})
    assert rep.state == "lost" and coord.lost_count == 1
    assert "warm_death_ds" in [e["name"] for e in t_recovery.dataset_manifest()]


# ---------------------------------------------------------------------- #
# the manifest and the exported artifacts, both packages
# ---------------------------------------------------------------------- #


def test_manifest_entries_match_the_jax_package(tmp_path):
    entries = [("a", "read_csv", (str(tmp_path / "a.csv"),), {"sep": ","}),
               ("b", "read_parquet", (str(tmp_path / "b.parquet"),), {}),
               ("a", "read_csv", (str(tmp_path / "a2.csv"),), {})]
    for P in PACKAGES:
        for name, reader, args, kwargs in entries:
            P.recovery.register_dataset(name, reader, args, kwargs)
        with pytest.raises(TypeError):
            P.recovery.register_dataset("bad", "read_csv", (threading.Lock(),))
    assert t_recovery.dataset_manifest() == j_recovery.dataset_manifest()
    assert [e["name"] for e in t_recovery.dataset_manifest()] == ["a", "b"]


def test_warm_from_manifest_replays_the_public_readers(tmp_path):
    pdf = _frame(3, n=500)
    pdf.to_csv(tmp_path / "ds.csv", index=False)
    pdf.to_parquet(tmp_path / "ds.parquet")
    entries = [{"name": "c", "reader": "read_csv", "args": (str(tmp_path / "ds.csv"),), "kwargs": {}},
               {"name": "p", "reader": "read_parquet", "args": (str(tmp_path / "ds.parquet"),), "kwargs": {}}]
    frames = t_recovery.warm_from_manifest(entries)
    for name in ("c", "p"):
        pandas.testing.assert_frame_equal(frames[name]._to_pandas(), pdf)
    assert sorted(e["name"] for e in t_recovery.dataset_manifest()) == ["c", "p"]
    with pytest.raises(ValueError):
        t_recovery.warm_from_manifest([{"name": "z", "reader": "read_nothing", "args": (), "kwargs": {}}])


_EXPORT_QUERIES = ("sum", "mean", "min", "max", "count", "groupby_sum")


def _exported(P, pdf):
    frame = P.pd.DataFrame(pdf)
    for name in _EXPORT_QUERIES:
        P.queries.QUERIES[name](frame)
    frame["x"].median()
    return P.exporter.export_artifacts(frame)


def _normalize(records):
    out = {}
    for r in records:
        state = dict(r["state"])
        out[(r["col"], r["kind"], r["params"])] = (r["length"], r["can_fold"], state)
    return out


@pytest.mark.parametrize("seed", range(2))
def test_exported_records_match_the_jax_package(seed):
    pdf = _frame(20 + seed)
    t_rec, j_rec = _normalize(_exported(PORT, pdf)), _normalize(_exported(JAX, pdf))
    assert t_rec.keys() == j_rec.keys()
    assert {k[1] for k in t_rec} >= {"reduce", "groupby"}
    for key in t_rec:
        (t_len, t_fold, t_state), (j_len, j_fold, j_state) = t_rec[key], j_rec[key]
        assert (t_len, t_fold) == (j_len, j_fold), key
        assert t_state.keys() == j_state.keys(), key
        for field in t_state:
            a, b = t_state[field], j_state[field]
            if isinstance(b, pandas.DataFrame):
                _same(a, b, f"{key} {field}")
            elif field == "r" and np.asarray(b).dtype.kind == "f":
                np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12)
            elif field == "shape_hint":
                continue  # each compiler's own hint
            else:
                assert np.array_equal(np.asarray(a, dtype=object), np.asarray(b, dtype=object)), (key, field)
    groupby = [v for k, v in t_rec.items() if k[1] == "groupby"]
    assert groupby and all(s["idents"] == t_registry.ADOPT_IDENTS and s["host_guards"] == () for _, _, s in groupby)


def _plain_calls(monkeypatch):
    calls = {"n": 0}
    for mod, name in ((groupby_kernels, "bincount_plain"), (groupagg_kernels, "groupagg_plain"),
                      (fused_kernels, "run_program_plain")):
        real = getattr(mod, name)

        def counted(*args, _real=real, **kwargs):
            calls["n"] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(mod, name, counted)
    return calls


def test_ingested_records_hit_with_no_kernel_call(monkeypatch):
    pdf = _frame(30)
    source = tpd.DataFrame(pdf)
    want = {name: t_queries.QUERIES[name](source) for name in _EXPORT_QUERIES}
    records = t_exporter.export_artifacts(source)
    assert records
    fresh = tpd.DataFrame(pdf)
    fresh._query_compiler._modin_frame
    assert t_exporter.ingest_artifacts(fresh, records) == len(records)
    calls = _plain_calls(monkeypatch)
    hits0, misses0 = t_registry.COUNTS["view.hit"], t_registry.COUNTS["view.miss"]
    for name in _EXPORT_QUERIES:
        got = t_queries.QUERIES[name](fresh)
        (pandas.testing.assert_frame_equal if isinstance(got, pandas.DataFrame)
         else pandas.testing.assert_series_equal)(got, want[name], check_exact=True)
    assert calls["n"] == 0
    assert t_registry.COUNTS["view.hit"] - hits0 >= len(_EXPORT_QUERIES)
    assert t_registry.COUNTS["view.miss"] == misses0


def test_ingested_records_never_answer_for_other_rows(monkeypatch):
    pdf = _frame(31)
    source = tpd.DataFrame(pdf)
    for name in _EXPORT_QUERIES:
        t_queries.QUERIES[name](source)
    records = t_exporter.export_artifacts(source)
    # another length: nothing is stored
    shorter = tpd.DataFrame(pdf.iloc[:-1].reset_index(drop=True))
    shorter._query_compiler._modin_frame
    assert t_exporter.ingest_artifacts(shorter, records) == 0
    # the same length, other rows: stored on one frame, never answering
    # for another
    other_pdf = _frame(32)
    target, other = tpd.DataFrame(pdf), tpd.DataFrame(other_pdf)
    target._query_compiler._modin_frame
    assert t_exporter.ingest_artifacts(target, records) == len(records)
    calls = _plain_calls(monkeypatch)
    for name in _EXPORT_QUERIES:
        _same(t_queries.QUERIES[name](other), j_queries.QUERIES[name](other_pdf), name)
    assert calls["n"] > 0
    # a frame sharing the key column but with other value columns computes
    # its groupby, never adopting the ingested table
    mixed = target[["k", "x"]]
    _same(t_queries.q_groupby_sum(mixed), pdf[["k", "x"]].groupby("k").sum(), "mixed groupby")
    # export strips the guard: an ingested, unadopted record travels again
    again = t_exporter.export_artifacts(target)
    assert all("adopt_guard" not in r["state"] for r in again if isinstance(r["state"], dict))


def test_export_skips_tensors_in_states(monkeypatch):
    import torch

    pdf = _frame(33, n=200)
    frame = tpd.DataFrame(pdf)
    float(frame["x"].sum())
    col = frame._query_compiler._modin_frame.get_column(2)
    t_registry.store(col, "unit", ("t",), {"r": torch.zeros(2)}, host_bytes=16)
    kinds = {r["kind"] for r in t_exporter.export_artifacts(frame)}
    assert "unit" not in kinds and "reduce" in kinds


# ---------------------------------------------------------------------- #
# spawning: the device and the durability root
# ---------------------------------------------------------------------- #


def test_spawn_environment_carries_the_device_and_durability_root(monkeypatch, tmp_path):
    captured = {}

    class _FakeProc:
        pid = 12345

    def fake_popen(cmd, env=None, **kwargs):
        captured["cmd"], captured["env"] = cmd, env
        return _FakeProc()

    monkeypatch.setattr(t_coord.subprocess, "Popen", fake_popen)
    coord = t_coord.Coordinator(replicas=1, durability_dir=str(tmp_path))
    coord._control_port = 0
    coord._spawn(coord._replicas[0])
    env = captured["env"]
    assert captured["cmd"][-1] == "modin_tpu_torch.fleet.replica"
    assert env["MODIN_TPU_TORCH_DEVICE"] == "cpu"
    assert env["MODIN_TPU_TORCH_FLEET_DURABILITY_DIR"] == str(tmp_path)
    assert env["MODIN_TPU_TORCH_INGEST"] == "1"
    assert env["MODIN_TPU_TORCH_FLEET"] == "0" and env["MODIN_TPU_TORCH_WATCH_PORT"] == "0"
    # without a root the replica's environment carries none, whatever this
    # process's environment holds; the device follows a later set_device
    monkeypatch.setenv("MODIN_TPU_TORCH_FLEET_DURABILITY_DIR", "/stale")
    tcfg.Device.put("cuda")
    coord = t_coord.Coordinator(replicas=1, durability_dir="")
    coord._control_port = 0
    coord._spawn(coord._replicas[0])
    assert "MODIN_TPU_TORCH_FLEET_DURABILITY_DIR" not in captured["env"]
    assert captured["env"]["MODIN_TPU_TORCH_DEVICE"] == "cuda"


def test_a_replica_without_its_card_exits_before_hello():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the replica would serve")
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    listener.settimeout(0.2)
    env = dict(os.environ, MODIN_TPU_TORCH_DEVICE="cuda",
               MODIN_TPU_TORCH_FLEET_COORD=f"127.0.0.1:{listener.getsockname()[1]}")
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(modin_tpu_torch.__file__)))
    try:
        proc = subprocess.run([sys.executable, "-m", "modin_tpu_torch.fleet.replica"], env=env,
                              capture_output=True, text=True, timeout=60)
        assert proc.returncode == 2, proc.stderr
        assert "no device" in proc.stderr
        with pytest.raises(socket.timeout):
            listener.accept()  # no hello ever came
    finally:
        listener.close()
    # through the coordinator: a failed spawn, no fleet
    tcfg.Device.put("cuda")
    tcfg.FleetEnabled.put(True)
    with pytest.raises(RuntimeError, match="before its hello"):
        t_fleet.start_fleet(1)
    assert t_fleet.get_coordinator() is None
    _wait(lambda: _fleet_threads() == [], 10.0, "the failed fleet's threads to end")


# ---------------------------------------------------------------------- #
# one real fleet on the CPU
# ---------------------------------------------------------------------- #


def _wait(predicate, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout_s}s waiting for {what}")


def test_a_real_fleet_routes_loses_respawns_and_rewarms(tmp_path, monkeypatch):
    pdf = _frame(40, n=20_000)
    path = str(tmp_path / "ds.parquet")
    pdf.to_parquet(path)
    want = {name: fn(pandas.read_parquet(path)) for name, fn in j_queries.QUERIES.items()}
    monkeypatch.setenv("MODIN_TPU_TORCH_LOCKDEP", "1")
    monkeypatch.setenv("MODIN_TPU_TORCH_METERS", "1")
    tcfg.FleetEnabled.put(True)
    tcfg.FleetHeartbeatS.put(0.3)
    coord = None
    try:
        coord = t_fleet.start_fleet(2)
        t_fleet.register_dataset("ds", "read_parquet", path)
        rows = coord.snapshot()["replicas"]
        assert [r["state"] for r in rows] == ["up", "up"]
        assert len({r["rpc_port"] for r in rows}) == 2 and all(r["watch_port"] > 0 for r in rows)
        for tenant in ("a", "b", "c"):
            for name in sorted(t_queries.QUERIES):
                _same(t_fleet.submit("ds", name, tenant=tenant, deadline_ms=_QUERY_TIMEOUT_S * 1e3),
                      want[name], f"{tenant}:{name}")
        snap = t_fleet.fleet_snapshot()
        assert snap["routed"] == 21 and set(snap["assignments"].values()) == {0, 1}
        for rep in coord._replicas:
            reply = coord._call(rep, {"type": "snapshot"}, timeout=_QUERY_TIMEOUT_S)
            assert reply["device"] == "cpu" and reply["defaults_to_pandas"] == 0
            assert reply["lockdep"] == {"enabled": True, "violations": 0}
        victim = snap["assignments"]["a"]
        ReplicaFaultInjector(coord).kill(victim)
        # the next query of a drained tenant completes on the survivor
        _same(t_fleet.submit("ds", "sum", tenant="a", deadline_ms=_QUERY_TIMEOUT_S * 1e3), want["sum"], "after kill")
        _wait(lambda: coord.snapshot()["respawned"] >= 1
              and all(r["state"] == "up" for r in coord.snapshot()["replicas"]), _RESPAWN_S, "the respawn")
        final = coord.snapshot()
        assert final["lost"] == 1 and final["redistributed"] >= 1
        rep = coord._replicas[victim]
        assert rep.generation == 1
        reply = coord._call(rep, {"type": "snapshot"}, timeout=_QUERY_TIMEOUT_S)
        series = reply["meters"]["series"]
        assert series.get("view.ingest", {}).get("total", 0) > 0
        hits0 = series.get("view.hit", {}).get("total", 0)
        direct = coord._call(rep, {"type": "query", "dataset": "ds", "fn": t_queries.QUERIES["groupby_sum"],
                                   "args": (), "kwargs": {}, "tenant": "warm", "deadline_ms": None,
                                   "label": "warm_check"}, timeout=_QUERY_TIMEOUT_S)
        assert direct["ok"], direct
        _same(direct["result"], want["groupby_sum"], "respawned groupby_sum")
        after = coord._call(rep, {"type": "snapshot"}, timeout=_QUERY_TIMEOUT_S)
        assert after["meters"]["series"]["view.hit"]["total"] > hits0
        assert after["lockdep"]["violations"] == 0 and after["defaults_to_pandas"] == 0
        from modin_tpu_torch import serving as t_serving

        assert t_serving.serving_snapshot()["fleet"]["respawned"] == final["respawned"]
    finally:
        procs = [r.proc for r in coord._replicas] if coord is not None else []
        t_fleet.stop_fleet()
        for proc in procs:
            if proc is not None and proc.poll() is None:
                proc.send_signal(signal.SIGKILL)
                proc.wait(timeout=10)
    # the stop returns once its accept, monitor and control threads have ended
    assert t_fleet.get_coordinator() is None and _fleet_threads() == []


def test_fleet_metric_families_are_registered():
    from modin_tpu_torch.logging.metrics import METRICS

    names = {m[0] for m in METRICS}
    for family in ("fleet.replica.spawn", "fleet.replica.lost", "fleet.replica.heartbeat_miss",
                   "fleet.replica.respawned", "fleet.query.routed", "fleet.query.redispatch",
                   "fleet.drain.redistributed", "fleet.warm.dataset", "view.export", "view.ingest"):
        assert family in names, family
