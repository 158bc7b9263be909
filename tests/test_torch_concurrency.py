"""Shared state of the torch port under concurrent queries, and its lockdep.

The port's counterpart of ``tests/test_concurrency.py``: the caches that
concurrent queries share (the sorted representations, the fused-program
LRU, the plan's scan read cache), the query-stats scope seeding of pooled
workers, the flight recorder's rate limit under simultaneous dumps, the
reseat-once handshake of lineage recovery, the views registry's commit
races, and the runtime lockdep validator.  Every case runs under the
port's strict lockdep.  The validator's cases run the same script through
both packages' ``concurrency.lockdep`` (on lock names both declare) and
compare what each saw; the registry's cases hold the port's declared order
to the JAX package's on the names the two share, and every lock the port
builds to a declaration.
"""

import ast
import pathlib
import sys
import threading
import time
import types

import numpy as np
import pandas
import pytest
import torch

from modin_tpu import concurrency as j_concurrency
from modin_tpu.concurrency import lockdep as j_lockdep
from modin_tpu.logging import add_metric_handler as j_add_handler
from modin_tpu.logging import clear_metric_handler as j_clear_handler
from modin_tpu.observability import meters as j_meters

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
import modin_tpu_torch.serving as t_serving
from modin_tpu_torch import concurrency as t_concurrency
from modin_tpu_torch.concurrency import lockdep as t_lockdep
from modin_tpu_torch.config import (
    FusedCacheSize,
    PlanScanCacheBytes,
    RecoveryMode,
    ResilienceBackoffS,
    ServingEnabled,
    TraceDir,
    TraceEnabled,
    TraceFlightRecorderSize,
)
from modin_tpu_torch.core.dataframe.torch.dataframe import DeviceColumn
from modin_tpu_torch.core.execution import recovery, resilience
from modin_tpu_torch.core.execution.resilience import engine_call, reset_breakers
from modin_tpu_torch.logging import add_metric_handler, clear_metric_handler
from modin_tpu_torch.logging.metrics import emit_metric
from modin_tpu_torch.observability import flight_recorder, meters
from modin_tpu_torch.ops import lazy as ops_lazy
from modin_tpu_torch.ops import sorted_cache
from modin_tpu_torch.serving import context as serving_context
from modin_tpu_torch.serving.gate import gate
from modin_tpu_torch.testing import make_device_error

THREADS = 8
PORT_ROOT = pathlib.Path(modin_tpu_torch.__file__).parent


@pytest.fixture(autouse=True)
def _lockdep_validated():
    """Every case runs under the port's strict validator; a violation a
    worker thread recorded (where the raise may be swallowed) fails the
    case here."""
    t_lockdep.enable(strict=True)
    yield
    recorded = t_lockdep.violations()
    t_lockdep.disable()
    assert not recorded, "\n".join(v.render() for v in recorded)


@pytest.fixture(autouse=True)
def _clean_state():
    modin_tpu_torch.set_device("cpu")
    saved = [(p, p.get()) for p in (RecoveryMode, ResilienceBackoffS, ServingEnabled, FusedCacheSize)]
    reset_breakers()
    gate.reset_for_tests()
    ResilienceBackoffS.put(0.0)
    yield
    for p, v in saved:
        p.put(v)
    reset_breakers()
    gate.reset_for_tests()
    recovery.reset_for_tests()


def _run_threads(workers, timeout_s=120):
    """Run callables concurrently; re-raise the first failure; no hangs."""
    errors = []
    lock = threading.Lock()

    def wrap(fn):
        try:
            fn()
        except BaseException as err:  # noqa: BLE001 - surfaced to the test
            with lock:
                errors.append(err)

    threads = [threading.Thread(target=wrap, args=(fn,), daemon=True) for fn in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout_s)
    assert not any(t.is_alive() for t in threads), "worker thread hung"
    if errors:
        raise errors[0]


# ---------------------------------------------------------------------- #
# sorted-representation cache under mixed load
# ---------------------------------------------------------------------- #


def test_sorted_cache_stress_no_torn_pairs():
    """Attachers, invalidators and readers on one column's rep: a reader
    never sees a (data, n_valid) pair mixed from two attaches."""
    col = DeviceColumn.from_numpy(np.arange(1024, dtype=np.float64))
    base = torch.sort(col.data).values
    base0 = float(base[0])
    payloads = {t: (base + float(t), 1000 + t) for t in range(3)}
    stop = time.monotonic() + 3.0

    def attacher(t):
        def fn():
            while time.monotonic() < stop:
                xs, n = payloads[t]
                sorted_cache.attach(col, xs, n)
        return fn

    def invalidator():
        while time.monotonic() < stop:
            sorted_cache.invalidate(col)

    def reader():
        while time.monotonic() < stop:
            got = sorted_cache.get(col)
            if got is None:
                continue
            data, n = got
            assert data is not None and n is not None, "torn rep: dropped half"
            tag = n - 1000
            assert tag in payloads, f"unknown n_valid {n}"
            assert float(data[0]) == pytest.approx(base0 + tag), "torn pair"

    _run_threads([attacher(t) for t in range(3)] + [invalidator, invalidator] + [reader, reader, reader])
    sorted_cache.attach(col, base, 1000)
    data, n = sorted_cache.get(col)
    assert n == 1000 and torch.equal(data, base)
    sorted_cache.invalidate(col)


def test_sorted_cache_spill_races_reader():
    """The ledger's spill drops reps while readers hold the pair: a reader
    keeps valid tensors, never half a pair."""
    col = DeviceColumn.from_numpy(np.arange(512, dtype=np.float64))
    xs = torch.sort(col.data).values
    stop = time.monotonic() + 2.0

    def spiller():
        while time.monotonic() < stop:
            rep = getattr(col, "_sorted_rep", None)
            if rep is not None:
                rep.spill()

    def attacher():
        while time.monotonic() < stop:
            sorted_cache.attach(col, xs, 512)

    def reader():
        while time.monotonic() < stop:
            got = sorted_cache.get(col)
            if got is not None:
                data, n = got
                assert data is not None and n == 512

    _run_threads([spiller, attacher, reader, reader])


# ---------------------------------------------------------------------- #
# fused-program LRU under mixed load
# ---------------------------------------------------------------------- #


def test_fused_cache_lru_stress_direct():
    """Raw get/put with a tiny bound: the OrderedDict's linkage survives
    and the bound holds."""
    with FusedCacheSize.context(4):
        evict0 = ops_lazy.fused_cache_evictions()
        stop = time.monotonic() + 2.0

        def worker(t):
            def fn():
                i = 0
                while time.monotonic() < stop:
                    key = ("stress", t, i % 7)
                    if ops_lazy._fused_cache_get(key) is None:
                        ops_lazy._fused_cache_put(key, object())
                    i += 1
            return fn

        _run_threads([worker(t) for t in range(THREADS)])
        assert ops_lazy.fused_cache_len() <= 4
        assert ops_lazy.fused_cache_evictions() > evict0


def test_fused_chains_exact_under_concurrent_submit():
    """Concurrent served queries of several chain depths stay exact while
    the bounded cache evicts and compiles again."""
    rng = np.random.default_rng(11)
    n = 2048
    base = rng.integers(0, 100, n).astype(np.int64)
    df = tpd.DataFrame({"b": base})
    df._query_compiler._modin_frame
    expected_base = int(base.sum())
    ServingEnabled.put(True)
    with FusedCacheSize.context(2):

        def worker(t):
            def query(depth):
                def fn():
                    s = df["b"]
                    for _ in range(depth):
                        s = s + 1
                    return int(s.sum())
                return fn

            def fn():
                for i in range(6):
                    depth = 1 + (t + i) % 4
                    got = t_serving.submit(query(depth), tenant=f"t{t}", deadline_ms=0)
                    assert got == expected_base + depth * n, f"depth {depth}: {got}"
            return fn

        _run_threads([worker(t) for t in range(6)])
        assert ops_lazy.fused_cache_len() <= 2
    assert gate.snapshot()["completed"] == 36


# ---------------------------------------------------------------------- #
# plan scan read cache under mixed load
# ---------------------------------------------------------------------- #


def test_scan_cache_stress_shared_origin(tmp_path):
    """Threads force pruned scans sharing ONE origin: the byte-bounded read
    cache stays coherent (right columns out, bound held)."""
    from modin_tpu_torch.core.execution.torch_engine.io import TorchCSVDispatcher
    from modin_tpu_torch.plan import ir
    from modin_tpu_torch.plan.lowering import lower

    rng = np.random.default_rng(5)
    path = tmp_path / "scan.csv"
    cols = list("abcdef")
    pandas.DataFrame({c: rng.integers(0, 100, 512) for c in cols}).to_csv(path, index=False)
    origin = ir.Scan(TorchCSVDispatcher, {"filepath_or_buffer": str(path)}, pandas.Index(cols))
    projections = [("a", "b"), ("b", "c"), ("c", "d"), ("d", "e"), ("e", "f"), ("a", "f"), ("b", "e")]

    def worker(t):
        def fn():
            for i in range(6):
                keep = projections[(t + i) % len(projections)]
                scan = ir.Scan(TorchCSVDispatcher, {"filepath_or_buffer": str(path)}, pandas.Index(cols),
                               pruned=keep, colarg="usecols", pushed=True, origin=origin)
                qc = lower(scan)
                assert list(qc.get_columns()) == list(keep), f"thread {t} iter {i}: {list(qc.get_columns())}"
        return fn

    _run_threads([worker(t) for t in range(THREADS)])
    assert origin.cache is not None
    assert sum(b for _qc, b in origin.cache.values()) <= int(PlanScanCacheBytes.get())


# ---------------------------------------------------------------------- #
# query-stats scope seeding (pooled-worker reuse)
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("clear_with", [None, []], ids=["none", "empty_list"])
def test_seed_thread_scopes_clears_stale_seeding(clear_with):
    with meters.query_stats("owner") as qs:
        snap = meters.snapshot_scopes()
        assert snap and snap[0] is qs
        seen = {}

        def reused_worker():
            meters.seed_thread_scopes(snap)
            meters.seed_thread_scopes(clear_with)
            seen["scopes"] = meters.snapshot_scopes()
            emit_metric("engine.dispatch", 1)

        t = threading.Thread(target=reused_worker)
        t.start()
        t.join(timeout=10)
    assert seen["scopes"] is None
    assert qs.dispatches == 0, "a worker re-seeded empty still routed into the stale scope"
    with meters.query_stats("owner2") as qs2:
        snap2 = meters.snapshot_scopes()

        def seeded_worker():
            meters.seed_thread_scopes(snap2)
            emit_metric("engine.dispatch", 1)

        t = threading.Thread(target=seeded_worker)
        t.start()
        t.join(timeout=10)
    assert qs2.dispatches == 1


# ---------------------------------------------------------------------- #
# flight-recorder rate limiting under simultaneous dumps
# ---------------------------------------------------------------------- #


@pytest.fixture
def _traced(tmp_path):
    with TraceEnabled.context(True), TraceFlightRecorderSize.context(64), \
            TraceDir.context(str(tmp_path / "traces")):
        flight_recorder.reset_for_tests()
        from modin_tpu_torch.observability import spans

        for i in range(4):
            with spans.span(f"engine.warm{i}.attempt", "TORCH-ENGINE"):
                pass
        yield tmp_path
    flight_recorder.reset_for_tests()


def test_simultaneous_breaker_open_dumps_write_exactly_one(_traced):
    saved = flight_recorder.MIN_DUMP_INTERVAL_S
    flight_recorder.MIN_DUMP_INTERVAL_S = 3600.0
    try:
        barrier = threading.Barrier(THREADS, timeout=30)
        paths, lock = [], threading.Lock()

        def opener(t):
            def fn():
                barrier.wait()
                path = flight_recorder.dump_flight_record(f"breaker_open_x{t}", resolve_device=False)
                with lock:
                    paths.append(path)
            return fn

        _run_threads([opener(t) for t in range(THREADS)])
        assert len([p for p in paths if p is not None]) == 1, "the rate limiter raced"
    finally:
        flight_recorder.MIN_DUMP_INTERVAL_S = saved


def test_failed_dump_releases_only_its_own_claim(_traced):
    """A slow failing dump must not zero a NEWER successful claim."""
    saved_interval = flight_recorder.MIN_DUMP_INTERVAL_S
    real_to_chrome = flight_recorder.to_chrome_trace
    flight_recorder.MIN_DUMP_INTERVAL_S = 0.05
    slow_entered, slow_release = threading.Event(), threading.Event()

    def hooked(*args, **kwargs):
        if threading.current_thread().name == "slow-failing-dump":
            slow_entered.set()
            assert slow_release.wait(timeout=30)
            raise RuntimeError("disk full")
        return real_to_chrome(*args, **kwargs)

    flight_recorder.to_chrome_trace = hooked
    try:
        results = {}
        t = threading.Thread(target=lambda: results.update(
            slow=flight_recorder.dump_flight_record("slow_fail", resolve_device=False)),
            name="slow-failing-dump", daemon=True)
        t.start()
        assert slow_entered.wait(timeout=30)
        time.sleep(0.06)
        assert flight_recorder.dump_flight_record("newer_claim", resolve_device=False) is not None
        slow_release.set()
        t.join(timeout=30)
        assert results["slow"] is None
        assert flight_recorder.dump_flight_record("third", resolve_device=False) is None
    finally:
        flight_recorder.to_chrome_trace = real_to_chrome
        flight_recorder.MIN_DUMP_INTERVAL_S = saved_interval


# ---------------------------------------------------------------------- #
# reseat-once under concurrent observers
# ---------------------------------------------------------------------- #


@pytest.fixture
def metrics():
    seen = []
    handler = lambda name, value: seen.append(name)  # noqa: E731
    add_metric_handler(handler)
    yield seen
    clear_metric_handler(handler)


def test_reseat_once_piggyback_semantics():
    RecoveryMode.put("Enable")
    values = np.arange(256, dtype=np.float64)
    col = DeviceColumn.from_numpy(values)
    e0 = recovery.current_epoch()
    n1 = recovery.reseat_all("first_observer", observed_epoch=e0)
    assert recovery.current_epoch() == e0 + 1 and n1 >= 1
    assert recovery.reseat_all("second_observer", observed_epoch=e0) == n1
    assert recovery.current_epoch() == e0 + 1
    assert recovery.reseat_all("new_loss", observed_epoch=e0 + 1) >= 1
    assert recovery.current_epoch() == e0 + 2
    assert np.array_equal(col.to_numpy(), values)


def test_reseat_with_dispatch_lock_held_no_deadlock():
    """A device path reaches reseat_all holding the dispatch lock while
    another thread re-seats: the order dispatch -> reseat converges."""
    RecoveryMode.put("Enable")
    DeviceColumn.from_numpy(np.arange(128, dtype=np.float64))
    e0 = recovery.current_epoch()

    def holder_path():
        with serving_context.dispatch_lock:
            recovery.reseat_all("holder", observed_epoch=e0)

    _run_threads([holder_path, lambda: recovery.reseat_all("observer", observed_epoch=e0)], timeout_s=60)
    assert recovery.current_epoch() == e0 + 1
    assert ("resilience.dispatch", "recovery.reseat") in t_lockdep.observed_edges()


def test_reseat_clears_the_callers_deadline_for_the_pass():
    """The pass is shared work: an expired caller's deadline neither aborts
    it nor is lost after it."""
    RecoveryMode.put("Enable")
    col = DeviceColumn.from_numpy(np.arange(64, dtype=np.float64))
    clock = [100.0]
    real = serving_context._now
    serving_context._now = lambda: clock[0]
    try:
        token = serving_context.CancellationToken(0.01, "late")
        previous = serving_context.enter_context(serving_context.QueryContext(token))
        clock[0] += 1.0
        try:
            assert recovery.reseat_all("expired_caller") >= 1
            assert serving_context.current_token() is token
            assert col.to_numpy()[-1] == 63.0
            with pytest.raises(t_serving.DeadlineExceeded):
                serving_context.check_deadline("after")
        finally:
            serving_context.exit_context(previous)
    finally:
        serving_context._now = real


def test_reseat_once_concurrent_engine_calls(metrics):
    """Two threads fail the same epoch's deploys at once: one recovery
    pass, both calls succeed after it."""
    RecoveryMode.put("Enable")
    values = np.arange(512, dtype=np.float64)
    col = DeviceColumn.from_numpy(values)
    barrier = threading.Barrier(2, timeout=30)
    fired, fire_lock = [0], threading.Lock()

    def hook(op):
        if op != "deploy":
            return
        with fire_lock:
            if fired[0] >= 2:
                return
            fired[0] += 1
        barrier.wait()
        raise make_device_error("device_lost")

    assert resilience._fault_hook is None
    resilience._fault_hook = hook
    e0 = recovery.current_epoch()
    try:
        results = [None, None]

        def worker(i):
            def fn():
                results[i] = engine_call("deploy", lambda: 40 + i)
            return fn

        _run_threads([worker(0), worker(1)])
    finally:
        resilience._fault_hook = None
    assert results == [40, 41] and fired[0] == 2
    assert recovery.current_epoch() == e0 + 1, "two observers of one loss ran two passes"
    assert metrics.count("modin_tpu_torch.recovery.device_lost") == 1
    assert np.array_equal(col.to_numpy(), values)


# --------------------------------------------------------------------- #
# views: the lookup -> commit stale-read class
# --------------------------------------------------------------------- #


def test_view_artifact_commit_loses_to_concurrent_buffer_mutation():
    """Thread A holds an artifact between lookup and commit while thread B
    spills the column: A's commit is a no-op, never a stale artifact."""
    from modin_tpu_torch.views import registry as view_registry

    view_registry.reset()
    values = np.arange(4096, dtype=np.int64)
    col = DeviceColumn.from_numpy(values)
    params = ("sum", True, 1, False)
    assert view_registry.store(col, "reduce", params, {"r": np.int64(values.sum())}, can_fold=True)
    barrier, done = threading.Barrier(2, timeout=30), threading.Barrier(2, timeout=30)
    out = {}

    def reader():
        source = col._data
        outcome, state, _ = view_registry.lookup(col, "reduce", params)
        out["outcome"], out["state"] = outcome, dict(state) if state else None
        barrier.wait()
        done.wait()
        out["committed"] = view_registry.store(col, "reduce", params, out["state"], can_fold=True, source=source)

    def mutator():
        barrier.wait()
        out["freed"] = col.spill()
        done.wait()

    _run_threads([reader, mutator], timeout_s=60)
    assert out["outcome"] == "hit" and out["freed"] > 0
    assert out["committed"] is False, "a commit against a spilled tensor must decline"
    assert view_registry.lookup(col, "reduce", params)[0] == "miss"
    assert np.array_equal(col.to_numpy(), values)


def test_view_fold_lookup_race_with_append_branching():
    """Two threads fold one parent artifact into two appended children at
    a barrier: each commit lands under its own child with its own tail."""
    from modin_tpu_torch.views import incremental, registry as view_registry

    view_registry.reset()
    base = np.arange(1000, dtype=np.int64)
    parent = DeviceColumn.from_numpy(base)
    params = ("sum", True, 1, False)
    assert view_registry.store(parent, "reduce", params, {"r": np.int64(base.sum())}, can_fold=True)

    def make_child(tail):
        child = DeviceColumn.from_numpy(np.concatenate([base, tail]))
        view_registry.note_append(child, parent)
        return child

    tail_a, tail_b = np.full(100, 7, dtype=np.int64), np.full(250, -3, dtype=np.int64)
    child_a, child_b = make_child(tail_a), make_child(tail_b)
    barrier = threading.Barrier(2, timeout=30)
    out = {}

    def fold(name, child, tail):
        def fn():
            outcome, state, n0 = view_registry.lookup(child, "reduce", params)
            assert outcome == "fold" and n0 == len(base)
            barrier.wait()
            folded = incremental.combine_scalar("sum", True, state["r"], np.int64(tail.sum()))
            view_registry.store(child, "reduce", params, {"r": folded}, can_fold=True, folded=True)
            out[name] = folded
        return fn

    _run_threads([fold("a", child_a, tail_a), fold("b", child_b, tail_b)], timeout_s=60)
    assert out["a"] == base.sum() + tail_a.sum() and out["b"] == base.sum() + tail_b.sum()
    oa, sa, _ = view_registry.lookup(child_a, "reduce", params)
    ob, sb, _ = view_registry.lookup(child_b, "reduce", params)
    assert (oa, sa["r"]) == ("hit", out["a"]) and (ob, sb["r"]) == ("hit", out["b"])


# ---------------------------------------------------------------------- #
# the registry: declared, used, and the JAX package's order
# ---------------------------------------------------------------------- #


def _constructed_locks():
    """{(name, kind)} of every ``named_lock``/``named_rlock`` call with a
    literal name in the port's sources, and the bare ``threading`` locks
    built outside the validator."""
    built, bare = set(), []
    for path in PORT_ROOT.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else fn.attr if isinstance(fn, ast.Attribute) else None
            if name in ("named_lock", "named_rlock") and node.args and isinstance(node.args[0], ast.Constant):
                built.add((node.args[0].value, "lock" if name == "named_lock" else "rlock"))
            elif (name in ("Lock", "RLock") and isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name)
                  and fn.value.id == "threading" and path.name != "lockdep.py"):
                bare.append(f"{path.relative_to(PORT_ROOT)}:{node.lineno}")
    return built, bare


def test_every_port_lock_is_declared_and_every_declaration_built():
    t_concurrency.validate_registry()
    built, bare = _constructed_locks()
    assert bare == [], f"bare threading locks in the port: {bare}"
    declared = {(name, kind) for name, kind, _ in t_concurrency.LOCKS}
    assert built == declared


@pytest.mark.parametrize("kind", ["lock", "rlock"])
def test_lockdep_off_runs_the_raw_lock_methods(kind):
    """With lockdep off a named lock's ``acquire``/``release``/``with`` are
    its raw lock's own bound methods (no Python frame between a caller and
    the C lock); ``enable`` installs the validating ones for every lock
    already built, and ``disable`` puts the raw ones back."""
    build, name = ((t_lockdep.named_lock, "serving.gate") if kind == "lock"
                   else (t_lockdep.named_rlock, "resilience.dispatch"))
    lock, other = build(name), t_lockdep.named_lock("metrics.counted")
    t_lockdep.disable()
    raw_methods = (lock.acquire, lock.release, type(lock).__enter__.__get__(lock), type(lock).__exit__.__get__(lock))
    assert [m.__self__ for m in raw_methods] == [lock._raw] * 4
    assert not any(hasattr(m, "__func__") for m in raw_methods)  # builtin methods: no Python frame
    with lock:
        assert lock.locked() or kind == "rlock"
        assert lock.acquire(True, 0.01) is (kind == "rlock")
        if kind == "rlock":
            lock.release()
    assert not lock.locked()
    t_lockdep.enable(strict=True)
    try:
        assert lock.acquire.__func__ is t_lockdep.DepLock._checked_acquire
        with lock:
            with other:
                assert t_lockdep.held_locks() == [name, "metrics.counted"]
        assert (name, "metrics.counted") in t_lockdep.observed_edges()
    finally:
        t_lockdep.disable()
    assert lock.acquire.__self__ is lock._raw and t_lockdep.held_locks() == []


def test_shared_lock_names_keep_the_jax_kind_and_order():
    j_kinds, t_kinds = j_concurrency.declared_kinds(), t_concurrency.declared_kinds()
    shared = set(j_kinds) & set(t_kinds)
    assert {n: t_kinds[n] for n in shared} == {n: j_kinds[n] for n in shared}
    on_shared = lambda edges: {e for e in edges if set(e) <= shared}  # noqa: E731
    assert on_shared(t_concurrency.order_edges()) == on_shared(j_concurrency.order_edges())
    from modin_tpu.concurrency import registry as j_registry
    from modin_tpu_torch.concurrency import registry as t_registry

    assert t_registry.NESTABLE == j_registry.NESTABLE & set(t_kinds)
    assert t_registry.LEAF_LOCKS == j_registry.LEAF_LOCKS & set(t_kinds)


def test_serving_workload_observes_only_declared_directions():
    """A served mixed workload from several threads: no violation, and no
    observed edge contradicts the declared order."""
    rng = np.random.default_rng(2)
    df = tpd.DataFrame({"a": rng.normal(size=4096), "b": rng.integers(0, 9, 4096)})
    df._query_compiler._modin_frame
    ServingEnabled.put(True)
    queries = [lambda: float((df["a"] * 2 + 1).sum()), lambda: df.groupby("b").sum()._to_pandas(),
               lambda: df.sort_values("a").head(3)._to_pandas(), lambda: float(df[df["a"] > 0]["a"].mean())]

    def worker(t):
        return lambda: [t_serving.submit(q, tenant=f"t{t % 3}") for q in queries]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch threads often: more interleavings
    try:
        _run_threads([worker(t) for t in range(THREADS)])
    finally:
        sys.setswitchinterval(interval)
    closure = t_concurrency.transitive_order()
    for before, after in t_lockdep.observed_edges():
        assert before not in closure.get(after, ()), f"observed {before} -> {after} against the declared order"
    assert gate.snapshot()["completed"] == THREADS * len(queries)


# ---------------------------------------------------------------------- #
# the runtime lockdep validator, both packages on the same script
# ---------------------------------------------------------------------- #

J = types.SimpleNamespace(name="jax", c=j_concurrency, lockdep=j_lockdep, add=j_add_handler, clear=j_clear_handler,
                          meters=j_meters, prefix="modin_tpu.")
T = types.SimpleNamespace(name="port", c=t_concurrency, lockdep=t_lockdep, add=add_metric_handler,
                          clear=clear_metric_handler, meters=meters, prefix="modin_tpu_torch.")
#: two locks both packages declare, with no declared relation
X, Y = "plan.scan_cache", "io.chunker"


def _both_lockdep(script):
    """Run ``script(P)`` on each package's validator (fresh, strict) and
    hold the port's observations to the JAX package's."""
    seen = {}
    for P in (J, T):
        P.lockdep.enable(strict=True)
        try:
            seen[P.name] = script(P)
        finally:
            P.lockdep.enable(strict=True)
    j_lockdep.disable()
    assert seen["port"] == seen["jax"]
    return seen["port"]


def _kinds(P):
    return [v.kind for v in P.lockdep.violations()]


def _self_deadlock(P):
    lock = P.c.named_lock(X)
    lock.acquire()
    try:
        with pytest.raises(P.lockdep.LockdepViolation) as exc:
            lock.acquire()
    finally:
        lock.release()
    return {"raised": exc.value.kind, "recorded": _kinds(P)}


def _reentrant(P):
    r = P.c.named_rlock("recovery.provenance")
    with r:
        with r:
            inside = P.lockdep.held_locks()
    return {"inside": inside, "after": P.lockdep.held_locks(), "recorded": _kinds(P)}


def _instance_pair(P):
    a, b = P.c.named_lock(X), P.c.named_lock(X)
    with a:
        with pytest.raises(P.lockdep.LockdepViolation) as exc:
            b.acquire()
    P.lockdep.enable(strict=True)
    n1, n2 = P.c.named_lock("meters.query_stats"), P.c.named_lock("meters.query_stats")
    with n1:
        with n2:
            pass
    return {"raised": exc.value.kind, "nestable_recorded": _kinds(P)}


def _out_of_order(P):
    outer, inner = P.c.named_lock("serving.gate"), P.c.named_rlock("resilience.dispatch")
    outer.acquire()
    inner.acquire()
    outer.release()
    mid = P.lockdep.held_locks()
    inner.release()
    return {"mid": mid, "after": P.lockdep.held_locks(), "recorded": _kinds(P),
            "edge": ("serving.gate", "resilience.dispatch") in P.lockdep.observed_edges()}


def _declared_contradiction(P):
    names = []
    handler = lambda name, value: names.append(name[len(P.prefix):])  # noqa: E731
    P.add(handler)
    try:
        dispatch, gate_lock = P.c.named_rlock("resilience.dispatch"), P.c.named_lock("serving.gate")
        with dispatch:
            with pytest.raises(P.lockdep.LockdepViolation) as exc:
                gate_lock.acquire()
    finally:
        P.clear(handler)
    return {"raised": exc.value.kind, "names_gate": "serving.gate" in str(exc.value), "recorded": _kinds(P),
            "metered": "concurrency.lockdep.violation" in names}


def _observed_inversion(P):
    x, y = P.c.named_lock(X), P.c.named_lock(Y)

    def first_order():
        with x:
            with y:
                pass

    t = threading.Thread(target=first_order, name="lockdep-abba-witness", daemon=True)
    t.start()
    t.join()
    witnessed = (X, Y) in P.lockdep.observed_edges()
    with y:
        with pytest.raises(P.lockdep.LockdepViolation) as exc:
            x.acquire()
    return {"witnessed": witnessed, "raised": exc.value.kind}


def _per_thread(P):
    g = P.c.named_lock("serving.gate")
    observed = {}
    with g:
        t = threading.Thread(target=lambda: observed.update(held=P.lockdep.held_locks()), daemon=True)
        t.start()
        t.join()
        mine = P.lockdep.held_locks()
    return {"other": observed["held"], "mine": mine, "recorded": _kinds(P)}


def _disabled(P):
    P.lockdep.disable()
    lock = P.c.named_lock("serving.gate")
    before = P.lockdep.lockdep_alloc_count()
    for _ in range(1000):
        with lock:
            pass
    return {"enabled": P.lockdep.enabled(), "allocs": P.lockdep.lockdep_alloc_count() - before,
            "violations": P.lockdep.violations(), "edges": P.lockdep.observed_edges(), "held": P.lockdep.held_locks()}


def _construction(P):
    errors = []
    for build, name in ((P.c.named_lock, "app.never.declared"), (P.c.named_lock, "resilience.dispatch"),
                        (P.c.named_rlock, "serving.gate")):
        with pytest.raises(ValueError) as exc:
            build(name)
        errors.append("not declared" in str(exc.value))
    return {"undeclared_first": errors}


def _leaf(P):
    ledger, other = P.c.named_rlock("memory.device_ledger"), P.c.named_lock(X)
    with ledger:
        with other:
            pass
    out_edge = ("memory.device_ledger", X) in P.lockdep.observed_edges()
    with other:
        with ledger:
            pass
    return {"out_edge": out_edge, "in_edge": (X, "memory.device_ledger") in P.lockdep.observed_edges(),
            "recorded": _kinds(P)}


def _fanout(P):
    x, y = P.c.named_lock(X), P.c.named_lock(Y)

    def witness():
        with x:
            with y:
                pass

    t = threading.Thread(target=witness, daemon=True)
    t.start()
    t.join()
    outcome = {}

    def invert():
        with P.meters.query_stats("lockdep-fanout"):
            with y:
                try:
                    x.acquire()
                except P.lockdep.LockdepViolation as err:
                    outcome["kind"] = err.kind

    w = threading.Thread(target=invert, daemon=True)
    w.start()
    w.join(timeout=30)
    return {"hung": w.is_alive(), "kind": outcome.get("kind")}


def _gc_guard(P):
    outer, inner = P.c.named_lock(X), P.c.named_lock(Y)
    v = P.lockdep._validator
    v._tls.in_validator = True
    try:
        with outer:
            with inner:
                pass
    finally:
        v._tls.in_validator = False
    return {"edge": (X, Y) in P.lockdep.observed_edges(), "recorded": _kinds(P)}


LOCKDEP_CASES = {
    "self_deadlock_raises": (_self_deadlock, {"raised": "self-deadlock", "recorded": ["self-deadlock"]}),
    "reentrant_reacquire_clean": (_reentrant, {"inside": ["recovery.provenance"] * 2, "after": [], "recorded": []}),
    "instance_pair_unless_nestable": (_instance_pair, {"raised": "instance-pair", "nestable_recorded": []}),
    "release_out_of_order": (_out_of_order, {"mid": ["resilience.dispatch"], "after": [], "recorded": [],
                                             "edge": True}),
    "declared_contradiction_metered": (_declared_contradiction, {
        "raised": "declared-contradiction", "names_gate": True, "recorded": ["declared-contradiction"],
        "metered": True}),
    "observed_inversion_once": (_observed_inversion, {"witnessed": True, "raised": "observed-inversion"}),
    "per_thread_stacks": (_per_thread, {"other": [], "mine": ["serving.gate"], "recorded": []}),
    "disabled_zero_allocation": (_disabled, {"enabled": False, "allocs": 0, "violations": [], "edges": {},
                                             "held": []}),
    "construction_enforces_registry": (_construction, {"undeclared_first": [True, False, False]}),
    "leaf_out_edges_ignored": (_leaf, {"out_edge": False, "in_edge": True, "recorded": []}),
    "inversion_fanout_no_self_deadlock": (_fanout, {"hung": False, "kind": "observed-inversion"}),
    "gc_reentrancy_guard": (_gc_guard, {"edge": False, "recorded": []}),
}


@pytest.mark.parametrize("case", list(LOCKDEP_CASES))
def test_lockdep_matches_the_jax_validator(case):
    script, expected = LOCKDEP_CASES[case]
    assert _both_lockdep(script) == expected
