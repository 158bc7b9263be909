"""Multi-tenant serving of the torch port against the JAX package's.

The scenarios of ``tests/test_serving.py`` run through both packages: the
JAX package (TpuOnJax on the CPU mesh) and the port on the CPU, each under
its own strict lockdep.  Every scenario returns what it observed (results,
the typed errors with their reasons, the ``serving.*`` metric events, the
gate's snapshot and the tenants' states, normalized where a value is a
wall time or a cost the two packages estimate differently), and the two
packages' observations must be equal; results are also held to pandas.
Clocks advance through the ``_now`` seams of ``serving/tenants.py``.

The port's own leg, degraded mode on the card (a typed ``degraded`` shed
and no pandas default), runs here with ``resilience._on_card`` patched
true, as ``tests/test_torch_resilience.py`` runs the card's other legs.
"""

import collections
import threading
import time
import types

import numpy as np
import pandas
import pytest

import modin_tpu.pandas as mpd
import modin_tpu.serving as j_serving
from modin_tpu import config as jcfg
from modin_tpu.concurrency import lockdep as j_lockdep
from modin_tpu.core import memory as j_memory
from modin_tpu.core.execution import resilience as j_res
from modin_tpu.logging import add_metric_handler as j_add_handler
from modin_tpu.logging import clear_metric_handler as j_clear_handler
from modin_tpu.logging.metrics import emit_metric as j_emit
from modin_tpu.observability import meters as j_meters
from modin_tpu.serving import context as j_context
from modin_tpu.serving import gate as j_gate_mod
from modin_tpu.serving import tenants as j_tenants
from modin_tpu.testing import inject_faults as j_inject

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
import modin_tpu_torch.serving as t_serving
from modin_tpu_torch import config as tcfg
from modin_tpu_torch.concurrency import lockdep as t_lockdep
from modin_tpu_torch.core import memory as t_memory
from modin_tpu_torch.core.execution import resilience as t_res
from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
from modin_tpu_torch.logging import add_metric_handler as t_add_handler
from modin_tpu_torch.logging import clear_metric_handler as t_clear_handler
from modin_tpu_torch.logging.metrics import emit_metric as t_emit
from modin_tpu_torch.observability import meters as t_meters
from modin_tpu_torch.serving import context as t_context
from modin_tpu_torch.serving import gate as t_gate_mod
from modin_tpu_torch.serving import tenants as t_tenants
from modin_tpu_torch.testing import inject_faults as t_inject

_N = 2048
_KNOBS = (
    "ServingEnabled", "ServingMaxConcurrent", "ServingQueueDepth", "ServingDefaultDeadlineMs",
    "ServingTenantWeights", "ServingDegradedHighWater", "ResilienceMode", "ResilienceRetries",
    "ResilienceBackoffS", "ResilienceBreakerThreshold", "ResilienceBreakerCooldownS", "RecoveryMode",
)

JAX = types.SimpleNamespace(
    name="jax", serving=j_serving, gate=j_gate_mod.gate, gate_mod=j_gate_mod, tenants=j_tenants,
    ctx=j_context, cfg=jcfg, res=j_res, inject=j_inject, pd=mpd, lockdep=j_lockdep, memory=j_memory,
    meters=j_meters, emit=j_emit, add_handler=j_add_handler, clear_handler=j_clear_handler,
    prefix="modin_tpu.",
)
PORT = types.SimpleNamespace(
    name="port", serving=t_serving, gate=t_gate_mod.gate, gate_mod=t_gate_mod, tenants=t_tenants,
    ctx=t_context, cfg=tcfg, res=t_res, inject=t_inject, pd=tpd, lockdep=t_lockdep, memory=t_memory,
    meters=t_meters, emit=t_emit, add_handler=t_add_handler, clear_handler=t_clear_handler,
    prefix="modin_tpu_torch.",
)
PACKAGES = (JAX, PORT)


def _reset(P):
    P.res.reset_breakers()
    P.gate.reset_for_tests()
    P.tenants.registry.reset()


@pytest.fixture(autouse=True)
def _clean_state():
    modin_tpu_torch.set_device("cpu")
    saved = [(getattr(P.cfg, k), getattr(P.cfg, k).get()) for P in PACKAGES for k in _KNOBS]
    for P in PACKAGES:
        _reset(P)
        P.cfg.ResilienceBackoffS.put(0.0)
    yield
    for p, v in saved:
        p.put(v)
    for P in PACKAGES:
        _reset(P)


def _run(P, scenario, *args):
    """One scenario on one package under its strict lockdep; returns what
    it observed, with the ``serving.*`` metric events it emitted."""
    seen = []

    def handler(name, value):
        seen.append(name[len(P.prefix):])

    P.add_handler(handler)
    P.lockdep.enable(strict=True)
    try:
        observed = scenario(P, *args)
    finally:
        recorded = P.lockdep.violations()
        P.lockdep.disable()
        P.clear_handler(handler)
    assert not recorded, "\n".join(v.render() for v in recorded)
    observed = dict(observed or {})
    observed["serving_metrics"] = collections.Counter(n for n in seen if n.startswith("serving."))
    return observed


def _both(scenario, *args):
    """Run ``scenario`` on the JAX package, then on the port, and hold the
    port's observations to the JAX package's."""
    jax_seen = _run(JAX, scenario, *args)
    port_seen = _run(PORT, scenario, *args)
    assert port_seen == jax_seen
    return port_seen


def _frames(P, seed=3):
    rng = np.random.default_rng(seed)
    data = {
        "a": rng.normal(size=_N),
        "b": rng.integers(0, 50, _N).astype(np.int64),
        "key": rng.integers(0, 7, _N).astype(np.int64),
    }
    df = P.pd.DataFrame(data)
    if P is JAX:
        df._query_compiler.execute()
    else:
        df._query_compiler._modin_frame
    return df, pandas.DataFrame(data)


def _to_pandas(x):
    return x._to_pandas() if hasattr(x, "_to_pandas") else x


def _snapshot(P):
    """``serving_snapshot()`` without what depends on the clock or on each
    package's cost model."""
    snap = P.serving.serving_snapshot()
    gate = {k: snap[k] for k in ("enabled", "running", "queued", "admitted", "ever_queued", "shed", "degraded",
                                 "completed", "max_concurrent", "queue_depth")}
    tenants = {
        name: {**{k: t[k] for k in ("weight", "in_flight", "admitted", "shed", "breaker")},
               "has_wall": t["wall_ewma_s"] is not None}
        for name, t in snap["tenants"].items()
    }
    return {"gate": gate, "tenants": tenants}


def _submit_in_threads(P, jobs):
    """Run ``[(kwargs, fn)]`` each in its own thread; (results, errors)."""
    results = [None] * len(jobs)
    errors = [None] * len(jobs)

    def run(i, fn, kwargs):
        try:
            results[i] = P.serving.submit(fn, **kwargs)
        except Exception as err:  # noqa: BLE001 - compared by type and reason
            errors[i] = err

    threads = [threading.Thread(target=run, args=(i, fn, kwargs), daemon=True) for i, (kwargs, fn) in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "serving test hang"
    return results, errors


def _hold_slots(P, n, tenant="t"):
    """``n`` queries holding their slots until ``release`` is set; returns
    (release event, the holders' thread)."""
    release = threading.Event()
    started = threading.Barrier(n + 1, timeout=30)

    def blocker():
        started.wait()
        assert release.wait(timeout=30)
        return "held"

    holder = threading.Thread(target=lambda: _submit_in_threads(P, [({"tenant": tenant}, blocker)] * n), daemon=True)
    holder.start()
    started.wait()
    return release, holder


def _wait_queued(P, count):
    deadline = time.monotonic() + 10
    while P.gate.snapshot()["queued"] < count and time.monotonic() < deadline:
        time.sleep(0.01)
    return P.gate.snapshot()["queued"]


def _error(err):
    if err is None:
        return None
    return {"type": type(err).__name__, "reason": getattr(err, "reason", None),
            "hinted": (getattr(err, "retry_after_s", None) or 0) > 0, "where": getattr(err, "where", None)}


def _frozen_clock(P, start):
    clock = [start]
    real = P.tenants._now
    P.tenants._now = lambda: clock[0]
    return clock, real


# ---------------------------------------------------------------------- #
# serving off: a direct call, nothing allocated
# ---------------------------------------------------------------------- #


def _disabled_transparent(P):
    df, pdf = _frames(P)
    assert not P.cfg.ServingEnabled.get()
    direct = _to_pandas(df.groupby("key").sum())
    alloc0 = P.serving.context_alloc_count()
    via_submit = P.serving.submit(lambda: _to_pandas(df.groupby("key").sum()), tenant="anyone", deadline_ms=5)
    assert P.serving.context_alloc_count() == alloc0
    assert P.ctx.CONTEXT_ON is False
    pandas.testing.assert_frame_equal(via_submit, direct)
    pandas.testing.assert_frame_equal(via_submit, pdf.groupby("key").sum())
    return {"admitted": P.gate.snapshot()["admitted"], "alloc_delta": P.serving.context_alloc_count() - alloc0,
            "context_on": P.ctx.CONTEXT_ON, "token": P.ctx.current_token(), "degraded": P.ctx.degraded_active()}


def test_disabled_is_transparent_and_allocates_nothing():
    seen = _both(_disabled_transparent)
    assert seen["admitted"] == seen["alloc_delta"] == 0
    assert seen["token"] is None and seen["degraded"] is False


# ---------------------------------------------------------------------- #
# admission + backpressure
# ---------------------------------------------------------------------- #


def _cap_and_queue(P):
    P.cfg.ServingEnabled.put(True)
    P.cfg.ServingMaxConcurrent.put(2)
    P.cfg.ServingQueueDepth.put(2)
    release, holder = _hold_slots(P, 2)
    got = []
    waiter = threading.Thread(target=lambda: got.append(P.serving.submit(lambda: "queued-done", tenant="t")),
                              daemon=True)
    waiter.start()
    _wait_queued(P, 1)
    during = P.gate.snapshot()
    release.set()
    waiter.join(timeout=30)
    holder.join(timeout=30)
    return {"running": during["running"], "queued": during["queued"], "got": got,
            "after": _snapshot(P)}


def test_concurrency_cap_and_bounded_queue():
    seen = _both(_cap_and_queue)
    assert (seen["running"], seen["queued"], seen["got"]) == (2, 1, ["queued-done"])
    assert seen["after"]["gate"]["running"] == 0


def _queue_full(P):
    P.cfg.ServingEnabled.put(True)
    P.cfg.ServingMaxConcurrent.put(1)
    P.cfg.ServingQueueDepth.put(0)
    release, holder = _hold_slots(P, 1)
    with pytest.raises(P.serving.QueryRejected) as exc_info:
        P.serving.submit(lambda: 2, tenant="t")
    release.set()
    holder.join(timeout=30)
    return {"error": _error(exc_info.value), "snapshot": _snapshot(P)}


def test_queue_full_sheds_typed_with_retry_hint_and_metrics():
    seen = _both(_queue_full)
    assert seen["error"] == {"type": "QueryRejected", "reason": "queue_full", "hinted": True, "where": None}
    assert seen["snapshot"]["gate"]["shed"] == 1
    assert seen["serving_metrics"]["serving.shed"] == 1
    assert seen["serving_metrics"]["serving.tenant.t.queue_full"] == 1
    assert seen["serving_metrics"]["serving.admit"] == 1


# ---------------------------------------------------------------------- #
# deadlines + cancellation
# ---------------------------------------------------------------------- #


def _deadline_in_queue(P):
    P.cfg.ServingEnabled.put(True)
    P.cfg.ServingMaxConcurrent.put(1)
    P.cfg.ServingQueueDepth.put(4)
    release, holder = _hold_slots(P, 1)
    t0 = time.perf_counter()
    with pytest.raises(P.serving.DeadlineExceeded) as exc_info:
        P.serving.submit(lambda: None, tenant="t", deadline_ms=150)
    wall = time.perf_counter() - t0
    release.set()
    holder.join(timeout=30)
    assert wall < 5.0
    return {"error": _error(exc_info.value), "snapshot": _snapshot(P)}


def test_deadline_expires_in_queue_typed():
    seen = _both(_deadline_in_queue)
    assert seen["error"]["where"] == "serving.queue"
    assert seen["serving_metrics"]["serving.deadline_exceeded"] == 1


def _mul_sum(df):
    """A query that launches through the engine seam's ``deploy`` in both
    packages (a fused chain and its reduction)."""
    return _to_pandas((df * 2).sum())


def _backoff_budget(P):
    df, _pdf = _frames(P)
    P.cfg.ServingEnabled.put(True)
    P.cfg.ResilienceBackoffS.put(5.0)
    P.cfg.ResilienceRetries.put(3)
    P.cfg.RecoveryMode.put("Disable")
    with P.inject("transient", ops=("deploy",), times=None):
        t0 = time.perf_counter()
        with pytest.raises(P.serving.DeadlineExceeded) as exc_info:
            P.serving.submit(lambda: _mul_sum(df), tenant="t", deadline_ms=200)
        wall = time.perf_counter() - t0
    assert wall < 2.5, f"{wall:.2f}s: the 5s backoff outlived the 200ms budget"
    return {"type": type(exc_info.value).__name__}


def test_backoff_sleeps_never_outlive_the_budget():
    seen = _both(_backoff_budget)
    assert seen["serving_metrics"]["serving.deadline_exceeded"] == 1


def _overshoot(P):
    df, _pdf = _frames(P)
    P.cfg.ServingEnabled.put(True)
    with P.inject("slow_kernel", ops=("deploy",), times=None, slow_s=0.06):
        t0 = time.perf_counter()
        with pytest.raises(P.serving.DeadlineExceeded) as exc_info:
            P.serving.submit(lambda: _mul_sum(df), tenant="t", deadline_ms=30)
        wall = time.perf_counter() - t0
    assert wall < 1.5, f"overshoot {wall:.3f}s"
    return {"deadline_s": exc_info.value.deadline_s}


def test_deadline_overshoot_bounded_by_one_attempt():
    assert _both(_overshoot)["deadline_s"] == pytest.approx(0.03)


@pytest.mark.parametrize("how", ["deadline", "cancel"])
def test_dispatch_lock_wait_honors_the_deadline(how):
    """The port's own rule (the JAX package waits for the lock
    unconditionally): a query whose deadline passes, or which is
    cancelled, while another query's device path holds the dispatch lock
    raises ``DeadlineExceeded`` at the lock, long before the holder lets
    go."""
    df, _pdf = _frames(PORT)
    tcfg.ServingEnabled.put(True)
    tcfg.ServingMaxConcurrent.put(4)
    held, release = threading.Event(), threading.Event()

    def holder():
        with t_context.dispatch_lock:  # another query's device path
            held.set()
            assert release.wait(timeout=30)

    holding = threading.Thread(target=lambda: t_serving.submit(holder, tenant="a"), daemon=True)
    holding.start()
    assert held.wait(timeout=30)
    tokens = []

    def query():
        tokens.append(t_context.current_token())
        return _to_pandas(df.groupby("key").sum())

    if how == "cancel":
        threading.Timer(0.1, lambda: tokens[0].cancel()).start()
    t0 = time.perf_counter()
    try:
        with pytest.raises(t_serving.DeadlineExceeded) as exc_info:
            t_serving.submit(query, tenant="b", deadline_ms=100 if how == "deadline" else 60_000)
        wall = time.perf_counter() - t0
    finally:
        release.set()
        holding.join(timeout=30)
    assert wall < 5.0, f"{wall:.3f}s: the query waited for the holder"
    assert exc_info.value.where.startswith(("device_path.", "engine.")), exc_info.value.where
    snap = t_serving.serving_snapshot()
    assert (snap["running"], snap["completed"]) == (0, 2)
    assert t_serving.submit(query, tenant="b") is not None  # the lock came back whole


def _default_deadline(P):
    P.cfg.ServingEnabled.put(True)
    P.cfg.ServingDefaultDeadlineMs.put(40.0)
    with pytest.raises(P.serving.DeadlineExceeded) as exc_info:
        P.serving.submit(lambda: (time.sleep(0.1), P.ctx.check_deadline("test")))
    unbounded = P.serving.submit(lambda: "ok", deadline_ms=0)
    token = P.ctx.CancellationToken(None, "manual")
    before = token.remaining_s()
    token.cancel()
    with pytest.raises(P.serving.DeadlineExceeded):
        token.check("unit")
    return {"error": _error(exc_info.value), "unbounded": unbounded, "manual_before": before,
            "manual_expired": token.expired()}


def test_default_deadline_knob_and_manual_cancellation():
    seen = _both(_default_deadline)
    assert seen["error"]["where"] == "test" and seen["unbounded"] == "ok"
    assert seen["manual_before"] is None and seen["manual_expired"] is True


# ---------------------------------------------------------------------- #
# per-tenant fairness + health
# ---------------------------------------------------------------------- #


def _token_bucket(P):
    P.cfg.ServingEnabled.put(True)
    P.cfg.ServingMaxConcurrent.put(2)
    clock, real = _frozen_clock(P, 1000.0)
    try:
        burst = [P.serving.submit(lambda: 1, tenant="hammer") for _ in range(8)]
        with pytest.raises(P.serving.QueryRejected) as exc_info:
            P.serving.submit(lambda: 1, tenant="hammer")
        polite = P.serving.submit(lambda: 2, tenant="polite")
        clock[0] += 1.0
        refilled = P.serving.submit(lambda: 3, tenant="hammer")
        tokens = {n: t.tokens for n, t in P.tenants.registry._tenants.items()}
    finally:
        P.tenants._now = real
    return {"burst": burst, "error": _error(exc_info.value), "polite": polite, "refilled": refilled,
            "tokens": tokens, "snapshot": _snapshot(P)}


def test_tenant_token_bucket_throttles_only_the_hammering_tenant():
    seen = _both(_token_bucket)
    assert seen["burst"] == [1] * 8 and (seen["polite"], seen["refilled"]) == (2, 3)
    assert seen["error"]["reason"] == "throttled" and seen["error"]["hinted"]


def _weights(P):
    parsed = [P.tenants.parse_weights(s) for s in ("a=3,b=1.5, c = 2", "junk,=,x=nan2,ok=1", "junk", "z=0")]
    P.cfg.ServingTenantWeights.put("fat=4")
    P.cfg.ServingMaxConcurrent.put(2)
    fat = P.tenants.registry.get("fat")
    P.cfg.ServingTenantWeights.put("")
    alice = [P.tenants.registry.get("alice").refill_per_s]
    P.cfg.ServingTenantWeights.put("alice=8")
    alice.append(P.tenants.registry.get("alice").refill_per_s)
    P.cfg.ServingMaxConcurrent.put(4)
    alice.append(P.tenants.registry.get("alice").refill_per_s)
    P.cfg.ServingTenantWeights.put("alice=0.1")
    retuned = P.tenants.registry.get("alice")
    return {"parsed": parsed, "fat": (fat.refill_per_s, fat.capacity, P.tenants._BURST), "alice": alice,
            "clamped": retuned.tokens <= retuned.capacity}


def test_tenant_weights_parse_size_and_retune():
    seen = _both(_weights)
    assert seen["parsed"][0] == {"a": 3.0, "b": 1.5, "c": 2.0}
    assert seen["fat"] == (8.0, 8.0 * seen["fat"][2], seen["fat"][2])
    assert seen["alice"] == [2.0, 16.0, 32.0] and seen["clamped"]


def _quarantine(P):
    P.cfg.ServingEnabled.put(True)
    P.cfg.ResilienceBreakerThreshold.put(2)
    P.cfg.ResilienceBreakerCooldownS.put(60.0)

    def striking_query():
        P.emit("resilience.breaker.binary.strike", 1)
        return "answer"

    answers = [P.serving.submit(striking_query, tenant="sick") for _ in range(2)]
    sick_state = P.res.get_breaker("tenant_sick").state
    with pytest.raises(P.serving.QueryRejected) as exc_info:
        P.serving.submit(lambda: 1, tenant="sick")
    fine = P.serving.submit(lambda: 2, tenant="fine")
    return {"answers": answers, "sick": sick_state, "error": _error(exc_info.value),
            "hint": exc_info.value.retry_after_s, "fine": fine,
            "fine_breaker": P.res.get_breaker("tenant_fine").state, "snapshot": _snapshot(P)}


def test_unhealthy_tenant_quarantined_not_the_system():
    seen = _both(_quarantine)
    assert seen["sick"] == "open" and seen["error"]["reason"] == "unhealthy"
    assert seen["hint"] == pytest.approx(60.0) and (seen["fine"], seen["fine_breaker"]) == (2, "closed")
    assert seen["serving_metrics"]["serving.tenant.sick.unhealthy"] == 1


def _fair_wake(P):
    P.cfg.ServingEnabled.put(True)
    P.cfg.ServingMaxConcurrent.put(2)
    P.cfg.ServingQueueDepth.put(4)
    P.cfg.ServingTenantWeights.put("heavy=8,light=1")
    releases = [threading.Event(), threading.Event()]
    started = threading.Barrier(3, timeout=30)
    order, order_lock = [], threading.Lock()

    def blocker(i):
        def fn():
            started.wait()
            assert releases[i].wait(timeout=30)
        return fn

    def tagged(tag):
        def fn():
            with order_lock:
                order.append(tag)
        return fn

    holders = [threading.Thread(target=lambda i=i: P.serving.submit(blocker(i), tenant="light"), daemon=True)
               for i in range(2)]
    for h in holders:
        h.start()
    started.wait()
    light = threading.Thread(target=lambda: P.serving.submit(tagged("light"), tenant="light"), daemon=True)
    light.start()
    _wait_queued(P, 1)
    heavy = threading.Thread(target=lambda: P.serving.submit(tagged("heavy"), tenant="heavy"), daemon=True)
    heavy.start()
    _wait_queued(P, 2)
    releases[0].set()
    heavy.join(timeout=30)
    releases[1].set()
    light.join(timeout=30)
    for h in holders:
        h.join(timeout=30)
    return {"order": order, "snapshot": _snapshot(P)}


def test_weighted_fair_wake_order_under_saturation():
    assert _both(_fair_wake)["order"] == ["heavy", "light"]


def _registry_bound(P, monkeypatch):
    monkeypatch.setattr(P.tenants, "_MAX_TENANTS", 6)
    P.cfg.ServingEnabled.put(True)
    P.cfg.ResilienceBreakerThreshold.put(1)
    P.tenants.registry.get("sick")
    P.tenants.breaker_for("sick").record_failure()
    results = [P.serving.submit(lambda i=i: i, tenant=f"user{i}") for i in range(20)]
    names = set(P.tenants.registry.snapshot())
    tenant_breakers = {n for n in P.res.breaker_snapshot() if n.startswith("tenant_user")}
    return {"results": results, "names": sorted(names), "user_breakers": sorted(tenant_breakers),
            "sick": P.res.get_breaker("tenant_sick").state}


def test_tenant_registry_bounded_with_breaker_cleanup(monkeypatch):
    seen = _both(_registry_bound, monkeypatch)
    assert len(seen["names"]) <= 7 and "sick" in seen["names"]
    assert len(seen["user_breakers"]) <= 6 and seen["sick"] == "open"


def _cost_ewma(P):
    P.cfg.ServingEnabled.put(True)
    reg = P.tenants.registry
    reg.observe("known", 1_000_000.0, 0.5)
    first = reg.cost_estimate("known", 123.0)
    new = reg.cost_estimate("new", 123.0)
    reg.observe("known", 0.0, 0.1)
    unmoved = reg.cost_estimate("known", 0.0)
    reg.observe("known", 2_000_000.0, 0.5)
    return {"first": first, "new": new, "unmoved": unmoved, "moved": reg.cost_estimate("known", 0.0)}


def test_cost_ewma_feeds_admission_estimates():
    seen = _both(_cost_ewma)
    assert (seen["first"], seen["new"], seen["unmoved"]) == (1_000_000.0, 123.0, 1_000_000.0)
    assert 1_000_000.0 < seen["moved"] < 2_000_000.0


def _byte_headroom(P):
    P.cfg.ServingEnabled.put(True)
    P.cfg.ServingMaxConcurrent.put(4)
    P.cfg.ServingQueueDepth.put(0)
    budget = 1 << 20
    P.tenants.registry.observe("whale", float(budget), 0.1)
    with P.cfg.DeviceMemoryBudget.context(budget):
        release, holder = _hold_slots(P, 1, tenant="whale")
        with pytest.raises(P.serving.QueryRejected) as exc_info:
            P.serving.submit(lambda: "w2", tenant="whale")
        reserved = P.gate.snapshot()["reserved_bytes"]
        release.set()
        holder.join(timeout=30)
        alone = P.serving.submit(lambda: "w3", tenant="whale")
    return {"error": _error(exc_info.value), "reserved": reserved, "alone": alone, "snapshot": _snapshot(P)}


def test_byte_headroom_gates_admission_under_budget():
    seen = _both(_byte_headroom)
    assert seen["error"]["reason"] == "queue_full" and seen["alone"] == "w3"
    assert seen["reserved"] == float(1 << 20)


# ---------------------------------------------------------------------- #
# degraded mode (on the CPU: pandas answers, as in the JAX package)
# ---------------------------------------------------------------------- #


def _degraded_breaker(P):
    df, pdf = _frames(P)
    P.cfg.ServingEnabled.put(True)
    P.cfg.ResilienceBreakerThreshold.put(1)
    P.res.get_breaker("binary").record_failure()
    got = P.serving.submit(lambda: _to_pandas(df.groupby("key").sum()), tenant="t")
    pandas.testing.assert_frame_equal(got, pdf.groupby("key").sum())
    return {"degraded": P.gate.snapshot()["degraded"], "breaker": P.res.get_breaker("binary").state}


def test_degraded_routes_to_host_on_open_breaker():
    seen = _both(_degraded_breaker)
    assert seen["degraded"] == 1 and seen["breaker"] == "open"
    assert seen["serving_metrics"]["serving.degraded"] == 1
    assert seen["serving_metrics"]["serving.degraded.fallback"] >= 1


def _degraded_high_water(P, healthy):
    df, pdf = _frames(P)
    resident = P.memory.device_resident_bytes()
    assert resident > 0
    P.cfg.ServingEnabled.put(True)
    P.cfg.ServingDegradedHighWater.put(0.5)
    if healthy:
        got = P.serving.submit(lambda: float(df["a"].sum()), tenant="t")
    else:
        with P.cfg.DeviceMemoryBudget.context(int(resident * 1.5)):
            got = P.serving.submit(lambda: float(df["a"].sum()), tenant="t")
    assert got == pytest.approx(float(pdf["a"].sum()))
    return {"degraded": P.gate.snapshot()["degraded"]}


@pytest.mark.parametrize("healthy", [False, True], ids=["past_high_water", "healthy"])
def test_degraded_routes_on_ledger_high_water(healthy):
    seen = _both(_degraded_high_water, healthy)
    assert seen["degraded"] == (0 if healthy else 1)
    assert ("serving.degraded" in seen["serving_metrics"]) is not healthy


# ---------------------------------------------------------------------- #
# introspection + plumbing
# ---------------------------------------------------------------------- #


def _snapshot_shape(P):
    P.cfg.ServingEnabled.put(True)
    P.serving.submit(lambda: 1, tenant="alice")
    snap = P.serving.serving_snapshot()
    return {"keys": sorted(k for k in snap if k in ("running", "queued", "admitted", "shed", "degraded", "tenants")),
            "snapshot": _snapshot(P)}


def test_snapshot_shape_and_tenant_rollup():
    seen = _both(_snapshot_shape)
    assert len(seen["keys"]) == 6
    assert seen["snapshot"]["tenants"]["alice"] == {
        "weight": 1.0, "in_flight": 0, "admitted": 1, "shed": 0, "breaker": "closed", "has_wall": True}


def _seeding(P):
    ctx = P.ctx.QueryContext(P.ctx.CancellationToken(10.0, "q1"), degraded=True, tenant="a")
    seen = {}

    def worker():
        P.ctx.seed_thread_context(ctx)
        seen["first"] = P.ctx.degraded_active()
        P.ctx.seed_thread_context(None)
        seen["second"] = P.ctx.degraded_active()
        seen["token"] = P.ctx.current_token()

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=10)
    return seen


def test_context_seeding_replaces_stale_context():
    assert _both(_seeding) == {"first": True, "second": False, "token": None,
                               "serving_metrics": collections.Counter()}


def _nested(P):
    P.cfg.ServingEnabled.put(True)
    P.cfg.ServingMaxConcurrent.put(2)

    def outer():
        assert P.ctx.CONTEXT_ON
        return P.serving.submit(lambda: "inner", tenant="t2")

    got = P.serving.submit(outer, tenant="t1")
    return {"got": got, "context_on": P.ctx.CONTEXT_ON, "snapshot": _snapshot(P)}


def test_nested_submit_composes():
    seen = _both(_nested)
    assert (seen["got"], seen["context_on"], seen["snapshot"]["gate"]["running"]) == ("inner", False, 0)


def _nested_saturated(P):
    P.cfg.ServingEnabled.put(True)
    P.cfg.ServingMaxConcurrent.put(1)
    P.cfg.ServingQueueDepth.put(0)
    done = []

    def outer():
        done.append(P.serving.submit(lambda: "inner-ran", tenant="t"))
        return "outer-ran"

    t = threading.Thread(target=lambda: done.append(P.serving.submit(outer, tenant="t")), daemon=True)
    t.start()
    t.join(timeout=20)
    assert not t.is_alive(), "nested submit deadlocked at saturation"
    with pytest.raises(P.serving.DeadlineExceeded) as exc_info:
        P.serving.submit(
            lambda: P.serving.submit(lambda: (time.sleep(0.05), P.ctx.check_deadline("nested")), tenant="t",
                                     deadline_ms=10),
            tenant="t",
        )
    return {"done": done, "error": _error(exc_info.value), "snapshot": _snapshot(P)}


def test_nested_submit_at_saturation_does_not_deadlock():
    seen = _both(_nested_saturated)
    assert seen["done"] == ["inner-ran", "outer-ran"] and seen["error"]["where"] == "nested"
    assert seen["snapshot"]["gate"]["admitted"] == 2 and seen["snapshot"]["gate"]["running"] == 0


def _refund(P):
    P.cfg.ServingEnabled.put(True)
    P.cfg.ServingMaxConcurrent.put(1)
    P.cfg.ServingQueueDepth.put(0)
    clock, real = _frozen_clock(P, 500.0)
    try:
        release, holder = _hold_slots(P, 1)
        reasons = []
        for _ in range(10):
            with pytest.raises(P.serving.QueryRejected) as exc_info:
                P.serving.submit(lambda: None, tenant="t")
            reasons.append(exc_info.value.reason)
        release.set()
        holder.join(timeout=30)
        tokens = P.tenants.registry.get("t").tokens
    finally:
        P.tenants._now = real
    return {"reasons": reasons, "tokens": tokens}


def test_queue_full_shed_refunds_the_rate_token():
    seen = _both(_refund)
    assert seen["reasons"] == ["queue_full"] * 10 and seen["tokens"] == 3.0


def _module_attr(P):
    return {"gate_is_module": isinstance(P.serving.gate, types.ModuleType),
            "instance": type(P.serving.gate.gate).__name__,
            "tenants_is_module": isinstance(P.serving.tenants, types.ModuleType)}


def test_package_gate_attribute_is_always_the_module():
    assert _both(_module_attr) == {"gate_is_module": True, "instance": "AdmissionGate", "tenants_is_module": True,
                                   "serving_metrics": collections.Counter()}


def _tenant_strike_scope(P, name):
    """The meters' rule: which strikes count as a scope's breaker trips."""
    with P.meters.query_stats("strikes") as qs:
        P.emit(name, 1)
    return {"trips": qs.breaker_trips}


@pytest.mark.parametrize("name,trips", [("resilience.breaker.tenant_inner.strike", 0),
                                        ("resilience.breaker.binary.strike", 1)], ids=["tenant", "device_path"])
def test_query_stats_counts_device_strikes_only(name, trips):
    assert _both(_tenant_strike_scope, name)["trips"] == trips


def _nested_strike(P):
    P.cfg.ServingEnabled.put(True)
    P.cfg.ResilienceBreakerThreshold.put(1)

    def outer():
        P.emit("resilience.breaker.tenant_inner.strike", 1)
        return "ok"

    got = P.serving.submit(outer, tenant="outer_tenant")
    return {"got": got, "outer": P.res.get_breaker("tenant_outer_tenant").state}


def test_nested_tenant_strike_does_not_cascade_to_outer():
    assert _both(_nested_strike)["outer"] == "closed"


def _user_bug(P):
    P.cfg.ServingEnabled.put(True)

    class UserBug(ValueError):
        pass

    def bad():
        raise UserBug("semantic error, not the serving layer's business")

    with pytest.raises(UserBug):
        P.serving.submit(bad, tenant="t")
    return {"snapshot": _snapshot(P), "breaker": P.res.get_breaker("tenant_t").state}


def test_untyped_query_errors_propagate_and_release():
    seen = _both(_user_bug)
    assert seen["snapshot"]["gate"]["running"] == 0 and seen["snapshot"]["gate"]["completed"] == 1
    assert seen["breaker"] == "closed"


def _device_strike(P):
    df, _pdf = _frames(P)
    P.cfg.ServingEnabled.put(True)
    P.cfg.ResilienceMode.put("Disable")
    P.cfg.ResilienceBreakerThreshold.put(1)
    with P.inject("device_lost", ops=("deploy",), times=None):
        with pytest.raises(Exception) as exc_info:
            P.serving.submit(lambda: _mul_sum(df), tenant="crasher")
    classified = P.res.classify_device_error(exc_info.value)
    return {"kind": classified.kind if classified is not None else None,
            "breaker": P.res.get_breaker("tenant_crasher").state}


def test_device_failure_strikes_tenant_health():
    seen = _both(_device_strike)
    assert seen["kind"] == "device_lost" and seen["breaker"] == "open"
    assert seen["serving_metrics"]["serving.tenant.crasher.device_failure"] == 1


def _served_queries(P):
    """Mixed queries from sixteen threads at MaxConcurrent 2: every result
    equals the same query run alone with serving off.  Two held slots make
    all sixteen queue before any runs, so the counters do not depend on
    how the threads interleave."""
    df, pdf = _frames(P)
    queries = {
        "chain_sum": lambda: float((df["a"] * df["b"] + df["key"]).sum()),
        "filtered_mean": lambda: float(df[df["a"] > 0]["b"].mean()),
        "group_sum": lambda: _to_pandas(df.groupby("key").sum()),
        "group_size": lambda: _to_pandas(df.groupby("key").size()),
    }
    alone = {name: fn() for name, fn in queries.items()}
    P.cfg.ServingEnabled.put(True)
    P.cfg.ServingMaxConcurrent.put(2)
    P.cfg.ServingQueueDepth.put(16)
    jobs = [({"tenant": f"t{i % 3}"}, fn) for i in range(8) for fn in queries.values()][:16]
    release, holder = _hold_slots(P, 2)
    outcome = {}
    submitter = threading.Thread(
        target=lambda: outcome.update(zip(("results", "errors"), _submit_in_threads(P, jobs))), daemon=True)
    submitter.start()
    queued = _wait_queued(P, len(jobs))
    release.set()
    holder.join(timeout=60)
    submitter.join(timeout=60)
    assert queued == len(jobs) and not submitter.is_alive()
    results, errors = outcome["results"], outcome["errors"]
    assert errors == [None] * len(jobs)
    names = list(queries) * 4
    for name, got in zip(names, results):
        want = alone[name]
        if isinstance(want, (pandas.DataFrame, pandas.Series)):
            assert got.equals(want), name
        else:
            assert got == want, name
    pandas.testing.assert_frame_equal(alone["group_sum"], pdf.groupby("key").sum())
    return {"snapshot": _snapshot(P), "chain_sum": alone["chain_sum"]}


def test_concurrent_queries_equal_their_serial_runs():
    seen = _both(_served_queries)
    gate = seen["snapshot"]["gate"]
    assert (gate["completed"], gate["ever_queued"], gate["shed"]) == (18, 16, 0)
    assert seen["serving_metrics"]["serving.queued"] == 16


# ---------------------------------------------------------------------- #
# the port's own leg: degraded mode on the card sheds, typed
# ---------------------------------------------------------------------- #


class TestDegradedOnTheCard:
    """``resilience._on_card`` patched true runs the card's leg here: the
    gate does not admit into a device whose device-path breaker is open,
    ledger pressure alone admits (the ledger's spill makes the room), and
    pandas never answers."""

    @pytest.fixture(autouse=True)
    def _card(self, monkeypatch):
        monkeypatch.setattr(t_res, "_on_card", lambda qc, args, kwargs: True)
        t_lockdep.enable(strict=True)
        yield
        recorded = t_lockdep.violations()
        t_lockdep.disable()
        assert not recorded, "\n".join(v.render() for v in recorded)

    @pytest.fixture
    def metrics(self):
        seen = []
        handler = lambda name, value: seen.append(name[len("modin_tpu_torch."):])  # noqa: E731
        t_add_handler(handler)
        yield seen
        t_clear_handler(handler)

    @pytest.mark.parametrize("cause", ["breaker", "breaker_and_ledger"])
    def test_sick_device_sheds_typed_without_pandas(self, cause, metrics):
        df, _pdf = _frames(PORT)
        tcfg.ServingEnabled.put(True)
        tcfg.ResilienceBreakerCooldownS.put(45.0)
        # with the ledger at 95 % of its budget too, past the 0.9 high water
        budget = int(t_memory.device_resident_bytes() / 0.95) if cause == "breaker_and_ledger" else None
        tcfg.ResilienceBreakerThreshold.put(1)
        t_res.get_breaker("groupby").record_failure()
        defaults0, fallbacks0 = tqc.DEFAULTS_TO_PANDAS, t_res.fallback_count()
        ran = []
        with tcfg.DeviceMemoryBudget.context(budget):
            with pytest.raises(t_serving.QueryRejected) as exc_info:
                t_serving.submit(lambda: ran.append(df.groupby("key").sum()), tenant="t")
        assert exc_info.value.reason == "degraded"
        assert exc_info.value.retry_after_s == pytest.approx(45.0)  # the breaker's cooldown
        assert ran == [] and tqc.DEFAULTS_TO_PANDAS == defaults0 and t_res.fallback_count() == fallbacks0
        snap = t_serving.serving_snapshot()
        assert (snap["degraded"], snap["shed"], snap["admitted"], snap["running"]) == (1, 1, 0, 0)
        assert snap["tenants"]["t"]["shed"] == 1 and snap["tenants"]["t"]["in_flight"] == 0
        assert t_tenants.registry.get("t").tokens == t_tenants.registry.get("t").capacity  # the token came back
        counts = collections.Counter(n for n in metrics if n.startswith("serving."))
        assert counts["serving.degraded"] == counts["serving.shed"] == counts["serving.tenant.t.degraded"] == 1
        assert "serving.admit" not in counts and "serving.degraded.fallback" not in counts

    @pytest.mark.parametrize("max_concurrent", [1, 4])
    @pytest.mark.parametrize("share", [0.9, 1.0, 1.5], ids=["at_high_water", "at_budget", "past_budget"])
    def test_ledger_pressure_admits_on_the_card(self, share, max_concurrent, metrics):
        """The resident data at or past 0.9 of ``DeviceMemoryBudget`` (data
        larger than its budget keeps the ledger there after every query):
        every query is admitted, not degraded, answers on the device path
        and equals its run without a budget."""
        df, pdf = _frames(PORT)
        want = _to_pandas(df.groupby("key").sum())
        pandas.testing.assert_frame_equal(want, pdf.groupby("key").sum())
        resident = t_memory.device_resident_bytes()
        assert resident > 0
        budget = int(resident / share)
        tcfg.ServingEnabled.put(True)
        tcfg.ServingMaxConcurrent.put(max_concurrent)
        defaults0, fallbacks0 = tqc.DEFAULTS_TO_PANDAS, t_res.fallback_count()
        jobs = [({"tenant": f"t{i % 2}"}, lambda: _to_pandas(df.groupby("key").sum())) for i in range(6)]
        with tcfg.DeviceMemoryBudget.context(budget):
            results, errors = _submit_in_threads(PORT, jobs)
            resident_after = t_memory.device_resident_bytes()
        assert errors == [None] * len(jobs)
        assert all(got.equals(want) for got in results)
        assert tqc.DEFAULTS_TO_PANDAS == defaults0 and t_res.fallback_count() == fallbacks0
        snap = t_serving.serving_snapshot()
        assert (snap["degraded"], snap["shed"], snap["completed"], snap["running"]) == (0, 0, len(jobs), 0)
        assert "serving.degraded" not in metrics and "serving.degraded.fallback" not in metrics
        assert resident_after <= budget or share < 1.0

    def test_queued_admission_into_a_sick_device_sheds(self):
        tcfg.ServingEnabled.put(True)
        tcfg.ServingMaxConcurrent.put(1)
        tcfg.ResilienceBreakerThreshold.put(1)
        release, holder = _hold_slots(PORT, 1)
        out = {}

        def queued():
            try:
                t_serving.submit(lambda: "ran", tenant="q")
            except t_serving.QueryRejected as err:
                out["reason"] = err.reason

        waiter = threading.Thread(target=queued, daemon=True)
        waiter.start()
        _wait_queued(PORT, 1)
        t_res.get_breaker("merge").record_failure()  # the device falls sick while it waits
        release.set()
        waiter.join(timeout=30)
        holder.join(timeout=30)
        assert out == {"reason": "degraded"}
        snap = t_serving.serving_snapshot()
        assert (snap["admitted"], snap["completed"], snap["running"], snap["shed"]) == (1, 1, 0, 1)

    def test_healthy_device_admits_on_the_card(self):
        tcfg.ServingEnabled.put(True)
        assert t_serving.submit(lambda: 7, tenant="t") == 7
        assert t_serving.serving_snapshot()["degraded"] == 0
