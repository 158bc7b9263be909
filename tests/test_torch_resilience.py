"""Fault-tolerant execution of the torch port against the JAX package's.

The cases of ``tests/test_resilience.py`` run through both packages with the
same fault schedules: the JAX package (TpuOnJax on the CPU mesh, its own
``modin_tpu.testing.faults``) and the port on the CPU
(``modin_tpu_torch.testing.faults``, which raises real torch errors).  Each
comparison holds the port to the JAX package's classification, to its
counters (the JAX metric events, ``modin_tpu.`` stripped, against
``resilience.COUNTS``), to its breaker state sequence under the patched
``_now``/``_sleep`` seams, and the answers to pandas: ints bit for bit,
floats to rtol 1e-12.

Where the two packages reach their engine seams in different orders (the
port gathers a ``nlargest`` through ``deploy``, the JAX package fetches
first; the JAX ``resample`` uploads its codes through ``put``), the family's
breaker and fallback counters and the fault kinds are compared, and the
whole counter set where the seams line up.

A table holds the port's taxonomy: torch's error types and CUDA codes,
the four kernel wrappers' own messages, a launch-configuration error and
a build error that must propagate.  ``RecoveryMode`` is Disable here, as in
``tests/test_resilience.py``; the recovery legs are in
``tests/test_torch_recovery.py``.
"""

import collections
import re
import time

import numpy as np
import pandas
import pytest
import torch

import modin_tpu.pandas as mpd
from modin_tpu import config as jcfg
from modin_tpu.core.execution import resilience as jres
from modin_tpu.logging import add_metric_handler, clear_metric_handler
from modin_tpu.testing import inject_faults as j_inject
from modin_tpu.testing import make_device_error as j_make

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch import config as tcfg
from modin_tpu_torch.core import memory
from modin_tpu_torch.core.dataframe.torch.dataframe import DeviceColumn
from modin_tpu_torch.core.execution import recovery as trec
from modin_tpu_torch.core.execution import resilience as tres
from modin_tpu_torch.core.execution.resilience import (
    CircuitBreaker,
    DeviceFailure,
    DeviceLost,
    DeviceOOM,
    TransientDeviceError,
    WatchdogTimeout,
    classify_device_error,
    device_path,
    engine_call,
    get_breaker,
)
from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
from modin_tpu_torch.testing import inject_faults as t_inject
from modin_tpu_torch.testing import make_device_error as t_make

RTOL = 1e-12
_KNOBS = (
    "ResilienceMode", "ResilienceRetries", "ResilienceBackoffS", "ResilienceWatchdogS",
    "ResilienceBreakerThreshold", "ResilienceBreakerCooldownS", "ResilienceLatencyBudgetS",
    "RecoveryMode", "SpillRetries", "SpillTargetFraction",
)


def _both(name, value):
    """Put one knob to the same value in both packages."""
    getattr(jcfg, name).put(value)
    getattr(tcfg, name).put(value)


@pytest.fixture(autouse=True)
def _clean_state():
    modin_tpu_torch.set_device("cpu")
    saved = [(getattr(m, k), getattr(m, k).get()) for m in (jcfg, tcfg) for k in _KNOBS]
    jres.reset_breakers()
    tres.reset_breakers()
    tres.reset_counts()
    _both("ResilienceBackoffS", 0.0)
    _both("RecoveryMode", "Disable")
    yield
    for p, v in saved:
        p.put(v)
    jres.reset_breakers()
    tres.reset_breakers()


@pytest.fixture
def jax_metrics():
    """The JAX package's metric events, by name without ``modin_tpu.``."""
    seen = collections.Counter()

    def handler(name, value):
        seen[name[len("modin_tpu."):]] += 1

    add_metric_handler(handler)
    yield seen
    clear_metric_handler(handler)


def _port_counts(prefixes=("resilience.", "recovery.")):
    return collections.Counter({k: v for k, v in tres.COUNTS.items() if k.startswith(prefixes) and v})


def _jax_counts(seen, prefixes=("resilience.", "recovery.")):
    return collections.Counter({k: v for k, v in seen.items() if k.startswith(prefixes)})


# ====================================================================== #
# taxonomy
# ====================================================================== #


def _wrapper_message(module_file, code, text, **fmt):
    """A kernel wrapper's own error message: the f-string of its raise,
    read from its source, filled in."""
    import modin_tpu_torch.ops.cuda as cuda_pkg

    src = open(f"{cuda_pkg.__path__[0]}/{module_file}").read()
    m = re.search(r'raise RuntimeError\(f"([^"]*CUDA error \{err\}: \{msg\})"\)', src)
    assert m, f"no CUDA error raise in {module_file}"
    return m.group(1).format(err=code, msg=text, **fmt)


_ACCEL = getattr(torch, "AcceleratorError", RuntimeError)

TAXONOMY = [
    # (id, exception factory, expected class or None)
    ("torch_oom", lambda: torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), DeviceOOM),
    ("cuda_oom_text", lambda: _ACCEL("CUDA error: out of memory\nCUDA kernel errors might be ..."), DeviceOOM),
    ("illegal_address", lambda: _ACCEL("CUDA error: an illegal memory access was encountered"), DeviceLost),
    ("device_assert", lambda: RuntimeError("CUDA error: device-side assert triggered\nCompile with ..."), DeviceLost),
    ("launch_failure", lambda: _ACCEL("CUDA error: unspecified launch failure"), DeviceLost),
    ("ecc", lambda: RuntimeError("CUDA error: uncorrectable ECC error encountered"), DeviceLost),
    ("misaligned", lambda: _ACCEL("CUDA error: misaligned address"), DeviceLost),
    ("enum_name", lambda: RuntimeError("CUDA error: cudaErrorIllegalAddress"), DeviceLost),
    ("invalid_config", lambda: _ACCEL("CUDA error: invalid configuration argument"), None),
    ("invalid_function", lambda: RuntimeError("CUDA error: invalid device function"), None),
    ("no_kernel_image", lambda: _ACCEL("CUDA error: no kernel image is available for execution on the device"), None),
    ("out_of_resources", lambda: RuntimeError("CUDA error: too many resources requested for launch"), None),
    ("launch_timeout", lambda: _ACCEL("CUDA error: the launch timed out and was terminated"), DeviceLost),
    ("device_busy", lambda: _ACCEL("CUDA error: CUDA-capable device(s) is/are busy or unavailable"), TransientDeviceError),
    ("invalid_argument", lambda: _ACCEL("CUDA error: invalid argument"), None),
    ("invalid_ptx", lambda: RuntimeError("CUDA error: a PTX JIT compilation failed"), None),
    ("invalid_handle", lambda: _ACCEL("CUDA error: invalid resource handle"), None),
    ("cooperative_too_large", lambda: RuntimeError("CUDA error: cudaErrorCooperativeLaunchTooLarge"), None),
    ("unknown_cuda", lambda: RuntimeError("CUDA error: something novel"), TransientDeviceError),
    ("bincount_oom", lambda: RuntimeError(_wrapper_message("groupby_kernels.py", 2, "out of memory", what="launch")), DeviceOOM),
    ("scan_lost", lambda: RuntimeError(_wrapper_message(
        "scan_kernels.py", 700, "an illegal memory access was encountered", mode="seg_sum")), DeviceLost),
    ("groupagg_config", lambda: RuntimeError(_wrapper_message(
        "groupagg_kernels.py", 9, "invalid configuration argument")), None),
    ("groupagg_resources", lambda: RuntimeError(_wrapper_message(
        "groupagg_kernels.py", 701, "too many resources requested for launch")), None),
    ("fused_launch_failure", lambda: RuntimeError(_wrapper_message(
        "fused_kernels.py", 719, "unspecified launch failure")), DeviceLost),
    # an oversized shared-memory request: cudaFuncSetAttribute returns 1
    ("bincount_smem", lambda: RuntimeError(_wrapper_message("groupby_kernels.py", 1, "invalid argument",
                                                            what="launch")), None),
    ("scan_smem", lambda: RuntimeError(_wrapper_message("scan_kernels.py", 1, "invalid argument", mode="seg_sum")),
     None),
    ("groupagg_smem", lambda: RuntimeError(_wrapper_message("groupagg_kernels.py", 1, "invalid argument")), None),
    ("fused_smem", lambda: RuntimeError(_wrapper_message("fused_kernels.py", 1, "invalid argument")), None),
    ("fused_timeout", lambda: RuntimeError(_wrapper_message(
        "fused_kernels.py", 702, "the launch timed out and was terminated")), DeviceLost),
    ("fused_no_image", lambda: RuntimeError(_wrapper_message(
        "fused_kernels.py", 209, "no kernel image is available for execution on the device")), None),
    ("fused_other", lambda: RuntimeError(_wrapper_message("fused_kernels.py", 999, "unknown error")), TransientDeviceError),
    ("nvcc_build", lambda: RuntimeError("nvcc failed to build csrc/fused.cu (exit 1):\nerror: CUDA error 2"), None),
    ("nvcc_missing", lambda: RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin)"), None),
    ("param_block", lambda: RuntimeError("groupagg kernel: the C parameter block is 96 bytes, the kernel's 104"), None),
    ("value_error_text", lambda: ValueError("CUDA error: out of memory"), None),
    ("key_error", lambda: KeyError("x"), None),
    ("type_error", lambda: TypeError("x"), None),
    ("too_many_groups", lambda: __import__("modin_tpu_torch.ops.groupby", fromlist=["x"])._TooManyGroups(), None),
    ("donated", lambda: RuntimeError(f"the column's tensor {tres.DONATED_MARKER} and it has no host copy"), DeviceLost),
]


@pytest.mark.parametrize("make,expected", [t[1:] for t in TAXONOMY], ids=[t[0] for t in TAXONOMY])
def test_taxonomy_table(make, expected):
    got = classify_device_error(make())
    if expected is None:
        assert got is None
    else:
        assert type(got) is expected


def test_wrapper_messages_carry_their_codes():
    # the four wrappers: bincount's helper formats "<what> failed with ..."
    for module_file in ("groupby_kernels.py", "scan_kernels.py", "groupagg_kernels.py", "fused_kernels.py"):
        msg = _wrapper_message(module_file, 700, "an illegal memory access was encountered", what="launch",
                               mode="sum")
        assert tres.cuda_error_code(RuntimeError(msg)) == 700


def test_accelerator_error_code_attribute():
    if not hasattr(torch, "AcceleratorError"):
        pytest.skip("this torch has no AcceleratorError")
    err = torch.AcceleratorError("opaque")
    err.error_code = 700
    assert type(classify_device_error(err)) is DeviceLost
    err.error_code = 9
    assert classify_device_error(err) is None


class TestTaxonomy:
    @pytest.mark.parametrize("kind", ["oom", "device_lost", "transient"])
    def test_injected_kinds_classify_as_the_jax_package(self, kind):
        jax_kind = type(jres.classify_device_error(j_make(kind))).__name__
        err = t_make(kind)
        assert type(classify_device_error(err)).__name__ == jax_kind
        # real torch types, not stand-ins
        assert isinstance(err, torch.cuda.OutOfMemoryError if kind == "oom" else _ACCEL)

    def test_semantic_signals_are_not_device_failures(self):
        from modin_tpu.utils import ModinAssumptionError

        from modin_tpu_torch.ops.groupby import _TooManyGroups

        for exc in (ModinAssumptionError("nope"), _TooManyGroups(), ValueError("RESOURCE_EXHAUSTED"), TypeError("x")):
            assert classify_device_error(exc) is None
            assert jres.classify_device_error(exc) is None

    def test_device_failure_passthrough(self):
        oom = DeviceOOM("already classified")
        assert classify_device_error(oom) is oom

    def test_hierarchy(self):
        assert issubclass(WatchdogTimeout, DeviceLost)
        assert issubclass(DeviceOOM, DeviceFailure)
        for name in ("DeviceOOM", "DeviceLost", "WatchdogTimeout", "TransientDeviceError"):
            assert getattr(tres, name).kind == getattr(jres, name).kind

    def test_donated_column_read_classifies_lost(self):
        col = DeviceColumn.from_numpy(np.arange(16, dtype=np.int64))
        col.mark_donated()
        col.host_cache = None
        with pytest.raises(RuntimeError) as info:
            col.data
        assert type(classify_device_error(info.value)) is DeviceLost


# ====================================================================== #
# engine_call: retry, backoff, watchdog
# ====================================================================== #


def _engine_both(jax_metrics, op, make_thunk, watchdog=False):
    """Run one thunk through both seams; returns ((result or exception
    class, attempts) per package, counters per package)."""
    out = []
    for module, make in ((jres, j_make), (tres, t_make)):
        attempts = []
        thunk = make_thunk(make, attempts)
        try:
            res = module.engine_call(op, thunk, watchdog=watchdog)
        except Exception as err:  # compared by class name below
            res = type(err).__name__
        out.append((res, len(attempts)))
    return out, _jax_counts(jax_metrics), _port_counts()


class TestEngineCall:
    def test_transient_retried_to_success(self, jax_metrics):
        _both("ResilienceRetries", 2)

        def make_thunk(make, attempts):
            def flaky():
                attempts.append(1)
                if len(attempts) < 3:
                    raise make("transient")
                return "ok"
            return flaky

        (j, t), jc, tc = _engine_both(jax_metrics, "deploy", make_thunk)
        assert j == t == ("ok", 3)
        assert jc == tc and tc["resilience.engine.deploy.retry"] == 2

    def test_transient_exhausted_raises_classified(self, jax_metrics):
        _both("ResilienceRetries", 1)

        def make_thunk(make, attempts):
            def flaky():
                attempts.append(1)
                raise make("transient")
            return flaky

        (j, t), jc, tc = _engine_both(jax_metrics, "deploy", make_thunk)
        assert j == t == ("TransientDeviceError", 2)
        assert jc == tc

    @pytest.mark.parametrize("kind,op", [("oom", "deploy"), ("device_lost", "materialize")])
    def test_oom_and_loss_not_retried(self, jax_metrics, kind, op):
        _both("ResilienceRetries", 5)

        def make_thunk(make, attempts):
            def fail():
                attempts.append(1)
                raise make(kind)
            return fail

        (j, t), jc, tc = _engine_both(jax_metrics, op, make_thunk)
        assert j == t == ({"oom": "DeviceOOM", "device_lost": "DeviceLost"}[kind], 1)
        assert jc == tc == collections.Counter({f"resilience.engine.{op}.{kind}": 1})

    def test_non_device_error_propagates_unchanged(self):
        def bug():
            raise KeyError("not a device problem")

        with pytest.raises(KeyError):
            engine_call("deploy", bug)

    def test_launch_bug_propagates_unchanged(self):
        def bad_launch():
            raise RuntimeError(_wrapper_message("groupagg_kernels.py", 9, "invalid configuration argument"))

        with pytest.raises(RuntimeError, match="CUDA error 9"):
            engine_call("deploy", bad_launch)
        assert not _port_counts()

    def test_disable_mode_propagates_raw(self):
        tcfg.ResilienceMode.put("Disable")

        def oom():
            raise t_make("oom")

        with pytest.raises(torch.cuda.OutOfMemoryError) as info:
            engine_call("deploy", oom)
        assert not isinstance(info.value, DeviceFailure)

    def test_watchdog_times_out_blocking_fetch(self, jax_metrics):
        _both("ResilienceWatchdogS", 0.1)

        def make_thunk(make, attempts):
            def wedged():
                attempts.append(1)
                time.sleep(2.0)
                return "never"
            return wedged

        t0 = time.monotonic()
        (j, t), jc, tc = _engine_both(jax_metrics, "materialize", make_thunk, watchdog=True)
        assert time.monotonic() - t0 < 3.5  # neither waited its full 2 s
        assert j[0] == t[0] == "WatchdogTimeout"
        assert jc == tc
        assert tc["resilience.watchdog.materialize.timeout"] == 1

    def test_watchdog_off_by_default(self):
        assert tcfg.ResilienceWatchdogS.get() == 0.0
        assert engine_call("wait", lambda: "done", watchdog=True) == "done"

    def test_watchdog_returns_the_worker_result(self):
        import threading

        tcfg.ResilienceWatchdogS.put(5.0)
        caller = threading.get_ident()
        assert engine_call("materialize", lambda: threading.get_ident() != caller, watchdog=True)

    def test_retry_backoff_through_the_sleep_seam(self, monkeypatch):
        tcfg.ResilienceRetries.put(3)
        tcfg.ResilienceBackoffS.put(0.5)
        slept = []
        monkeypatch.setattr(tres, "_sleep", slept.append)
        state = []

        def flaky():
            state.append(1)
            if len(state) < 4:
                raise t_make("transient")
            return "ok"

        assert engine_call("put", flaky) == "ok"
        assert slept == [0.5, 1.0, 2.0]

    def test_retry_metrics(self, jax_metrics):
        _both("ResilienceRetries", 1)

        def make_thunk(make, attempts):
            def flaky_once():
                attempts.append(1)
                if len(attempts) == 1:
                    raise make("transient")
                return "ok"
            return flaky_once

        (j, t), jc, tc = _engine_both(jax_metrics, "put", make_thunk)
        assert j == t == ("ok", 2)
        assert jc == tc
        assert tc["resilience.engine.put.transient"] == 1 and tc["resilience.engine.put.retry"] == 1


# ====================================================================== #
# circuit breaker state machine (both packages, one script)
# ====================================================================== #


def _breaker_script(module, monkeypatch, steps, threshold, cooldown, budget=0.0):
    """Drive a fresh breaker of ``module`` through ``steps`` under a patched
    clock; returns the state after each step and what each step gave."""
    cfg = jcfg if module is jres else tcfg
    cfg.ResilienceBreakerThreshold.put(threshold)
    cfg.ResilienceBreakerCooldownS.put(cooldown)
    cfg.ResilienceLatencyBudgetS.put(budget)
    clock = [100.0]
    monkeypatch.setattr(module, "_now", lambda: clock[0])
    b = module.CircuitBreaker("unit")
    trace = []
    for step in steps:
        if step == "fail":
            got = b.record_failure()
        elif step.startswith("ok"):
            got = b.record_success(float(step[3:] or 0.0))
        elif step == "allow":
            got = b.allow()
        elif step == "abort":
            got = b.abort_probe()
        else:
            clock[0] += float(step)
            got = None
        trace.append((step, got, b.state))
    return trace


BREAKER_SCRIPTS = {
    "trips_after_threshold": (["fail", "allow", "fail", "allow", "fail", "allow"], 3, 30.0, 0.0),
    "success_resets_strikes": (["fail", "ok", "fail", "allow"], 2, 30.0, 0.0),
    "half_open_closes": (["fail", "allow", "11", "allow", "allow", "ok", "allow"], 1, 10.0, 0.0),
    "half_open_reopens": (["fail", "11", "allow", "fail", "allow", "11", "allow"], 1, 10.0, 0.0),
    "aborted_probe_reopens": (["fail", "11", "allow", "abort", "allow", "11", "allow"], 1, 10.0, 0.0),
    "latency_budget": (["ok:1.0", "ok:2.0", "allow"], 2, 30.0, 0.5),
}


@pytest.mark.parametrize("script", sorted(BREAKER_SCRIPTS))
def test_breaker_sequences_match_the_jax_package(script, monkeypatch, jax_metrics):
    steps, threshold, cooldown, budget = BREAKER_SCRIPTS[script]
    j = _breaker_script(jres, monkeypatch, steps, threshold, cooldown, budget)
    t = _breaker_script(tres, monkeypatch, steps, threshold, cooldown, budget)
    assert j == t
    assert _jax_counts(jax_metrics) == _port_counts()


class TestCircuitBreaker:
    def test_trips_after_threshold(self):
        tcfg.ResilienceBreakerThreshold.put(3)
        b = CircuitBreaker("unit")
        for _ in range(2):
            b.record_failure()
            assert b.allow()
        b.record_failure()
        assert b.state == "open" and not b.allow()
        assert tres.COUNTS["resilience.breaker.unit.open"] == 1

    def test_aborted_probe_reopens_instead_of_sticking(self, monkeypatch):
        tcfg.ResilienceBreakerThreshold.put(1)
        tcfg.ResilienceBreakerCooldownS.put(10.0)
        clock = [0.0]
        monkeypatch.setattr(tres, "_now", lambda: clock[0])

        class Probe:
            mode = "fail_device"

            @device_path("probe_unit")
            def _try_thing(self):
                if self.mode == "fail_device":
                    raise t_make("oom")
                raise TypeError("a bug, not the device")

        p = Probe()
        assert p._try_thing() is None
        b = get_breaker("probe_unit")
        assert b.state == "open"
        clock[0] += 11.0
        p.mode = "bug"
        with pytest.raises(TypeError):
            p._try_thing()
        assert b.state == "open"
        clock[0] += 11.0
        assert b.allow()

    def test_launch_bug_in_a_device_path_is_no_fallback(self):
        class Probe:
            @device_path("probe_bug")
            def _try_thing(self):
                raise RuntimeError(_wrapper_message("fused_kernels.py", 98, "invalid device function"))

        with pytest.raises(RuntimeError, match="CUDA error 98"):
            Probe()._try_thing()
        assert tres.fallback_count() == 0
        assert get_breaker("probe_bug").strikes == 0

    def test_concurrent_strikes_and_counts(self):
        import sys
        import threading

        tcfg.ResilienceBreakerThreshold.put(10**9)
        b = get_breaker("stress")
        per_thread = 500
        barrier = threading.Barrier(16)

        def striker():
            barrier.wait(timeout=10)
            for _ in range(per_thread):
                b.record_failure()

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=striker) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert b.strikes == 16 * per_thread
        assert tres.COUNTS["resilience.breaker.stress.strike"] == 16 * per_thread

    def test_registry(self):
        assert get_breaker("a") is get_breaker("a")
        assert get_breaker("a") is not get_breaker("b")

    def test_every_try_method_has_a_catalogued_family(self):
        methods = [n for n in dir(tqc.TorchQueryCompiler) if n.startswith("_try_")]
        assert len(methods) >= 28
        for name in methods:
            fam = getattr(getattr(tqc.TorchQueryCompiler, name), "_resilience_family", None)
            assert fam in tres.DEVICE_PATH_FAMILIES, name
        assert tres.DEVICE_PATH_FAMILIES == jres.DEVICE_PATH_FAMILIES


# ====================================================================== #
# the device_path OOM leg (the port's departure: no single dispatch seam)
# ====================================================================== #


class _OomOnce:
    """A stand-in compiler whose device path runs out of memory ``fails``
    times, the way a sort or a kernel launch inside it would."""

    def __init__(self, fails):
        self.fails = fails
        self.calls = 0
        self._frame = None

        @device_path("probe_oom")
        def _try(qc):
            qc.calls += 1
            if qc.calls <= qc.fails:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 4.00 GiB")
            return "device answer"

        self.run = lambda: _try(self)


class TestDevicePathOomLeg:
    @pytest.fixture(autouse=True)
    def _recovery_on(self):
        tcfg.RecoveryMode.put("Enable")
        tcfg.SpillTargetFraction.put(1.0)

    def test_evict_then_retry_answers_on_the_device(self):
        ballast = DeviceColumn.from_numpy(np.arange(4096, dtype=np.int64))
        spills = memory.device_ledger.spill_count()
        probe = _OomOnce(1)
        assert probe.run() == "device answer"
        assert probe.calls == 2
        assert memory.device_ledger.spill_count() > spills and ballast.is_spilled
        assert tres.COUNTS["recovery.retry.oom"] == 1
        assert tres.fallback_count() == 0
        np.testing.assert_array_equal(ballast.to_numpy(), np.arange(4096))

    def test_rounds_are_bounded_by_spill_retries(self):
        tcfg.SpillRetries.put(2)
        tcfg.SpillTargetFraction.put(0.25)  # each round spills some, not all
        cols = [DeviceColumn.from_numpy(np.arange(1024, dtype=np.int64)) for _ in range(4)]
        probe = _OomOnce(10)
        assert probe.run() is None
        assert probe.calls == 3  # 1 + SpillRetries
        assert tres.COUNTS["resilience.fallback.probe_oom.oom"] == 1
        del cols

    def test_spill_retries_zero_is_terminal(self):
        tcfg.SpillRetries.put(0)
        DeviceColumn.from_numpy(np.arange(1024, dtype=np.int64))
        probe = _OomOnce(1)
        assert probe.run() is None and probe.calls == 1
        assert "recovery.retry.oom" not in tres.COUNTS

    def test_the_call_s_own_inputs_stay_resident(self):
        tdf = tpd.DataFrame({"a": np.arange(2048, dtype=np.float64)})
        frame = tdf._query_compiler._modin_frame
        other = DeviceColumn.from_numpy(np.arange(2048, dtype=np.int64))
        keys = tres._input_storages(tdf._query_compiler, (), {})
        assert keys == {memory.storage_key(frame._columns[0]._data)}
        assert trec.evict_for_oom("probe", exclude_ids=keys) > 0
        assert other.is_spilled and not frame._columns[0].is_spilled


# ====================================================================== #
# on the card: a failure the legs did not absorb raises, never pandas
# ====================================================================== #


class _Failing:
    """A stand-in compiler whose device path raises ``make()`` for its
    first ``fails`` calls, then answers."""

    def __init__(self, make, fails, family="probe_card"):
        self.make, self.fails, self.calls = make, fails, 0
        self._frame = None

        @device_path(family)
        def _try(qc):
            qc.calls += 1
            if qc.calls <= qc.fails:
                raise qc.make()
            return "device answer"

        self.run = lambda: _try(self)


class TestOnTheCard:
    """The card's legs, run here with ``_on_card`` patched true: every
    classified failure that the legs do not absorb raises, an open breaker
    raises ``BreakerOpen``, and nothing goes to pandas."""

    @pytest.fixture(autouse=True)
    def _card(self, monkeypatch):
        monkeypatch.setattr(tres, "_on_card", lambda qc, args, kwargs: True)

    @pytest.mark.parametrize("kind,cls", [("oom", DeviceOOM), ("device_lost", DeviceLost)])
    def test_a_failure_raises_and_strikes(self, kind, cls):
        tcfg.ResilienceBreakerThreshold.put(5)
        probe = _Failing(lambda: t_make(kind), fails=1)
        with pytest.raises(cls) as info:
            probe.run()
        assert info.value.retried
        assert probe.calls == 1
        assert get_breaker("probe_card").strikes == 1
        assert tres.COUNTS[f"resilience.raised.probe_card.{cls.kind}"] == 1
        assert tres.fallback_count() == 0
        assert not any(k.startswith("resilience.fallback.") for k in tres.COUNTS)
        assert probe.run() == "device answer"
        assert get_breaker("probe_card").strikes == 0

    def test_an_open_breaker_raises_at_once_and_a_probe_closes_it(self, monkeypatch):
        tcfg.ResilienceBreakerThreshold.put(2)
        tcfg.ResilienceBreakerCooldownS.put(30.0)
        clock = [0.0]
        monkeypatch.setattr(tres, "_now", lambda: clock[0])
        probe = _Failing(lambda: t_make("device_lost"), fails=2)
        states = []
        for _ in range(2):
            with pytest.raises(DeviceLost):
                probe.run()
            states.append(get_breaker("probe_card").state)
        with pytest.raises(tres.BreakerOpen):
            probe.run()
        assert probe.calls == 2  # stopped before the device
        clock[0] += 31.0
        assert probe.run() == "device answer"
        states.append(get_breaker("probe_card").state)
        assert states == ["closed", "open", "closed"]
        assert tres.COUNTS["resilience.breaker.probe_card.short_circuit"] == 1
        assert tres.COUNTS["resilience.raised.probe_card.device_lost"] == 2
        assert tres.fallback_count() == 0

    def test_oom_rounds_then_raise(self):
        tcfg.RecoveryMode.put("Enable")
        tcfg.SpillRetries.put(2)
        tcfg.SpillTargetFraction.put(0.25)
        cols = [DeviceColumn.from_numpy(np.arange(1024, dtype=np.int64)) for _ in range(4)]
        probe = _OomOnce(10)
        with pytest.raises(DeviceOOM):
            probe.run()
        assert probe.calls == 3  # 1 + SpillRetries
        assert tres.COUNTS["recovery.retry.oom"] == 2
        assert tres.COUNTS["resilience.raised.probe_oom.oom"] == 1
        assert tres.fallback_count() == 0
        absorbed = _OomOnce(1)
        assert absorbed.run() == "device answer" and absorbed.calls == 2
        del cols

    def test_a_direct_transient_is_retried_in_bounds(self, monkeypatch):
        tcfg.ResilienceRetries.put(2)
        sleeps = []
        monkeypatch.setattr(tres, "_sleep", sleeps.append)
        tcfg.ResilienceBackoffS.put(0.5)
        wrapper = lambda: RuntimeError(_wrapper_message("groupagg_kernels.py", 46, "busy"))
        assert _Failing(wrapper, fails=2).run() == "device answer"
        assert sleeps == [0.5, 1.0]
        assert tres.COUNTS["resilience.device_path.probe_card.retry"] == 2
        probe = _Failing(wrapper, fails=3)
        with pytest.raises(TransientDeviceError):
            probe.run()
        assert probe.calls == 3

    def test_a_transient_the_seam_retried_is_not_retried_again(self):
        tcfg.ResilienceRetries.put(2)

        class Seam:
            _frame = None
            calls = 0

            @device_path("probe_seam")
            def _try(self):
                self.calls += 1
                return engine_call("materialize", lambda: "fetched")

        seam = Seam()
        with t_inject("transient", ops=("materialize",), times=None):
            with pytest.raises(TransientDeviceError):
                seam._try()
        assert seam.calls == 1
        assert tres.COUNTS["resilience.engine.materialize.retry"] == 2
        assert "resilience.device_path.probe_seam.retry" not in tres.COUNTS

    def test_a_launch_bug_propagates_unstruck(self):
        probe = _Failing(lambda: RuntimeError(_wrapper_message("fused_kernels.py", 1, "invalid argument")), fails=1)
        with pytest.raises(RuntimeError, match="CUDA error 1") as info:
            probe.run()
        assert not isinstance(info.value, DeviceFailure)
        assert get_breaker("probe_card").strikes == 0
        assert not any(k.startswith("resilience.raised.") for k in tres.COUNTS)

    def test_an_inner_open_breaker_does_not_strike_the_outer_family(self):
        tcfg.ResilienceBreakerThreshold.put(1)
        tcfg.ResilienceBreakerCooldownS.put(1e9)
        get_breaker("probe_inner").record_failure()

        class Nested:
            _frame = None

            @device_path("probe_inner")
            def _try_inner(self):
                return "inner"

            @device_path("probe_outer")
            def _try_outer(self):
                return self._try_inner()

        with pytest.raises(tres.BreakerOpen):
            Nested()._try_outer()
        assert get_breaker("probe_outer").strikes == 0

    def test_from_pandas_raises_an_upload_that_failed(self):
        from modin_tpu_torch.core.dataframe.torch.dataframe import TorchDataframe

        tcfg.ResilienceRetries.put(0)
        pdf = pandas.DataFrame({"a": np.arange(8.0)})
        with t_inject("transient", ops=("put",), times=None):
            with pytest.raises(TransientDeviceError):
                TorchDataframe.from_pandas(pdf, device=torch.device("cuda"))
            # on the CPU the column stays on the host, as in the JAX package
            frame = TorchDataframe.from_pandas(pdf, device=torch.device("cpu"))
        assert not frame._columns[0].is_device

    def test_a_device_failure_in_a_parallel_read_raises(self, monkeypatch, tmp_path):
        from modin_tpu_torch.core.io.file_dispatcher import FileDispatcher
        from modin_tpu_torch.core.io.text.csv_dispatcher import CSVDispatcher

        path = str(tmp_path / "t.csv")
        pandas.DataFrame({"a": np.arange(64)}).to_csv(path, index=False)
        monkeypatch.setattr(FileDispatcher, "MIN_PARALLEL_BYTES", 1)

        def failing(cls, path, kwargs):
            raise t_make("oom")

        monkeypatch.setattr(CSVDispatcher, "_read_parallel", classmethod(failing))
        with pytest.raises(torch.cuda.OutOfMemoryError):
            tpd.read_csv(path)._to_pandas()

        def parse_error(cls, path, kwargs):
            raise ValueError("a chunk the parallel parse refuses")

        monkeypatch.setattr(CSVDispatcher, "_read_parallel", classmethod(parse_error))
        pandas.testing.assert_frame_equal(tpd.read_csv(path)._to_pandas(), pandas.read_csv(path))


# ====================================================================== #
# fault injection end to end, both packages
# ====================================================================== #

_N = 512


def _frames(seed=0, datetime_index=False):
    rng = np.random.default_rng(seed)
    data = {
        "a": rng.normal(size=_N),
        "b": rng.integers(0, 1000, _N).astype(np.int64),
        "key": rng.integers(0, 7, _N).astype(np.int64),
    }
    kwargs = {}
    if datetime_index:
        kwargs["index"] = pandas.date_range("2024-01-01", periods=_N, freq="h")
    pdf = pandas.DataFrame(data, **kwargs)
    jdf = mpd.DataFrame(data, **kwargs)
    jdf._query_compiler.execute()  # ingest outside any fault window
    tdf = tpd.DataFrame(data, **kwargs)
    tdf._query_compiler._modin_frame
    return jdf, tdf, pdf


def _same_as_pandas(got, want):
    got = got._to_pandas() if hasattr(got, "_to_pandas") else got
    if isinstance(want, pandas.DataFrame):
        pandas.testing.assert_frame_equal(got, want, check_exact=False, rtol=RTOL)
    else:
        pandas.testing.assert_series_equal(got, want, check_exact=False, rtol=RTOL)


FAMILY_QUERIES = [
    ("top_k", False, lambda df: df.nlargest(5, "a")),
    ("reduce", False, lambda df: df.median(numeric_only=True)),
    ("groupby", False, lambda df: df.groupby("key").sum()),
    ("merge", False, lambda df: df.merge(df, on="key", suffixes=("_l", "_r"))),
    ("resample", True, lambda df: df.resample("D").sum()),
]
# the families whose seam calls come in the same order in both packages
_ALIGNED = {"reduce", "groupby", "merge"}


class TestFaultInjectionEndToEnd:
    @pytest.mark.parametrize("kind", ["oom", "device_lost", "transient"])
    @pytest.mark.parametrize("family,dt_index,query", FAMILY_QUERIES, ids=[f[0] for f in FAMILY_QUERIES])
    def test_family_fallback_matches_the_jax_package(self, family, dt_index, query, kind, jax_metrics):
        _both("ResilienceBreakerThreshold", 50)
        jdf, tdf, pdf = _frames(seed=hash((family, kind)) % 2**32, datetime_index=dt_index)
        expected = query(pdf)
        with j_inject(kind, times=4) as j_inj:
            _same_as_pandas(query(jdf), expected)
        with t_inject(kind, times=4) as t_inj:
            _same_as_pandas(query(tdf), expected)
        assert t_inj.injected == j_inj.injected >= 1
        jc, tc = _jax_counts(jax_metrics), _port_counts()
        fam = (f"resilience.fallback.{family}.", f"resilience.breaker.{family}.")
        assert collections.Counter({k: v for k, v in tc.items() if k.startswith(fam)}) == \
            collections.Counter({k: v for k, v in jc.items() if k.startswith(fam)})
        assert tc[f"resilience.fallback.{family}.{kind}"] == 1
        kinds = lambda c: sum(v for k, v in c.items() if k.startswith("resilience.engine.") and k.endswith(kind))
        assert kinds(tc) == kinds(jc) == t_inj.injected
        if family in _ALIGNED:
            assert tc == jc

    def test_transient_fault_retries_without_fallback(self, jax_metrics):
        _both("ResilienceRetries", 2)
        jdf, tdf, pdf = _frames(seed=7)
        with j_inject("transient", ops=("materialize",), times=1) as j_inj:
            _same_as_pandas(jdf.nlargest(5, "a"), pdf.nlargest(5, "a"))
        with t_inject("transient", ops=("materialize",), times=1) as t_inj:
            _same_as_pandas(tdf.nlargest(5, "a"), pdf.nlargest(5, "a"))
        assert j_inj.injected == t_inj.injected == 1
        assert _port_counts() == _jax_counts(jax_metrics)
        assert tres.COUNTS["resilience.engine.materialize.retry"] == 1
        assert tres.fallback_count() == 0

    def test_slow_kernel_trips_watchdog_then_falls_back(self, jax_metrics):
        # the median fetches inside its device path in both packages (the
        # port's nlargest fetches only when its result is read)
        _both("ResilienceWatchdogS", 0.1)
        _both("ResilienceBreakerThreshold", 50)
        jdf, tdf, pdf = _frames(seed=13)
        want = pdf.median(numeric_only=True)
        with j_inject("slow_kernel", ops=("materialize",), times=2, slow_s=1.0):
            _same_as_pandas(jdf.median(numeric_only=True), want)
        with t_inject("slow_kernel", ops=("materialize",), times=2, slow_s=1.0) as t_inj:
            _same_as_pandas(tdf.median(numeric_only=True), want)
        assert t_inj.injected >= 1
        tc, jc = _port_counts(), _jax_counts(jax_metrics)
        assert tc["resilience.watchdog.materialize.timeout"] == jc["resilience.watchdog.materialize.timeout"] >= 1
        assert tc["resilience.fallback.reduce.watchdog_timeout"] == jc["resilience.fallback.reduce.watchdog_timeout"] == 1

    def test_breaker_trips_short_circuits_and_recovers(self, monkeypatch, jax_metrics):
        _both("ResilienceBreakerThreshold", 2)
        _both("ResilienceBreakerCooldownS", 30.0)
        jdf, tdf, pdf = _frames(seed=21)
        expected = pdf.nlargest(5, "a")
        states = {}
        for name, module, inject, df, ops in (
            ("jax", jres, j_inject, jdf, ("materialize",)),
            ("port", tres, t_inject, tdf, ("deploy", "materialize")),
        ):
            seq = []
            with inject("oom", ops=ops, times=None) as inj:
                _same_as_pandas(df.nlargest(5, "a"), expected)
                seq.append(module.get_breaker("top_k").state)
                _same_as_pandas(df.nlargest(5, "a"), expected)
                seq.append(module.get_breaker("top_k").state)
                used = inj.injected
                _same_as_pandas(df.nlargest(5, "a"), expected)  # open: no device contact
                assert inj.injected == used
            real_now = module._now
            monkeypatch.setattr(module, "_now", lambda real_now=real_now: real_now() + 31.0)
            _same_as_pandas(df.nlargest(5, "a"), expected)
            seq.append(module.get_breaker("top_k").state)
            states[name] = seq
        assert states["port"] == states["jax"] == ["closed", "open", "closed"]
        fam = lambda c: collections.Counter({k: v for k, v in c.items() if k.startswith("resilience.breaker.top_k.")})
        assert fam(_port_counts()) == fam(_jax_counts(jax_metrics))
        assert tres.COUNTS["resilience.breaker.top_k.short_circuit"] == 1

    def test_latency_budget_degrades_slow_path(self, jax_metrics):
        _both("ResilienceBreakerThreshold", 2)
        _both("ResilienceLatencyBudgetS", 1e-9)
        jdf, tdf, pdf = _frames(seed=34)
        expected = pdf.nlargest(5, "a")
        for df, module in ((jdf, jres), (tdf, tres)):
            for _ in range(3):
                _same_as_pandas(df.nlargest(5, "a"), expected)
            assert module.get_breaker("top_k").state == "open"
        fam = lambda c: collections.Counter({k: v for k, v in c.items() if k.startswith("resilience.breaker.top_k.")})
        assert fam(_port_counts()) == fam(_jax_counts(jax_metrics))

    def test_disable_mode_bypasses_breakers(self):
        tcfg.ResilienceMode.put("Disable")
        _, tdf, pdf = _frames(seed=55)
        get_breaker("top_k").record_failure()
        defaults = tqc.DEFAULTS_TO_PANDAS
        _same_as_pandas(tdf.nlargest(5, "a"), pdf.nlargest(5, "a"))
        assert tqc.DEFAULTS_TO_PANDAS == defaults

    def test_clean_queries_count_nothing(self):
        _, tdf, pdf = _frames(seed=56)
        for q in (lambda d: d.groupby("key").mean(), lambda d: (d["a"] * 2 + d["b"]).sum(),
                  lambda d: d.sort_values("a"), lambda d: d[d.a > 0]):
            want = q(pdf)
            got = q(tdf)
            if np.isscalar(want):
                np.testing.assert_allclose(got, want, rtol=RTOL)
            else:
                _same_as_pandas(got, want)
        assert not _port_counts()
        assert set(tres.breaker_snapshot().values()) <= {"closed"}

    def test_injector_is_exclusive(self):
        with t_inject("oom"):
            with pytest.raises(RuntimeError):
                with t_inject("transient"):
                    pass

    def test_injector_restores_hook(self):
        with t_inject("oom", times=0):
            assert tres._fault_hook is not None
        assert tres._fault_hook is None
