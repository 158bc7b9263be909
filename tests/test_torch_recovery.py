"""Lineage recovery and OOM evict-then-retry of the torch port, against the
JAX package's.

The cases of ``tests/test_recovery.py`` through the port on the CPU, and
the chaos scenarios through both packages under the same schedules: a
mid-query loss re-seats the live columns from their lineage (host, io or
op replay) and the query answers as pandas does; an OOM burst is absorbed
by evict-then-retry with no fallback; ``SpillRetries=0`` keeps an OOM
terminal.  Lineage kinds along a chain past ``LineageMaxDepth`` are held
to the JAX package's, and so are the recovery counters where the two
packages hold the same live columns.

Injected faults leave every tensor intact; a real sticky CUDA error would
not, and then the re-seat's own uploads fail (the re-seat is exercised here
and on the card with injected faults, as the JAX package's tests do).
Answers: ints bit for bit, floats to rtol 1e-12 of pandas.
"""

import collections
import gc

import numpy as np
import pandas
import pytest
import torch

import modin_tpu.pandas as mpd
from modin_tpu import config as jcfg
from modin_tpu.core.execution import recovery as jrec
from modin_tpu.core.execution import resilience as jres
from modin_tpu.logging import add_metric_handler, clear_metric_handler
from modin_tpu.testing import midquery_device_loss as j_midquery
from modin_tpu.testing import oom_burst_until_eviction as j_burst

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch import config as tcfg
from modin_tpu_torch.core import memory
from modin_tpu_torch.core.dataframe.torch.dataframe import DeviceColumn
from modin_tpu_torch.core.execution import recovery, resilience
from modin_tpu_torch.core.execution.resilience import DeviceOOM, engine_call
from modin_tpu_torch.core.memory import device_ledger
from modin_tpu_torch.parallel.engine import TorchWrapper
from modin_tpu_torch.testing import (
    OomBurstInjector,
    SequencedFaultInjector,
    inject_faults,
    make_device_error,
    midquery_device_loss,
    oom_burst_until_eviction,
)

RTOL = 1e-12
_KNOBS = (
    "RecoveryMode", "ResilienceMode", "ResilienceRetries", "ResilienceBackoffS",
    "ResilienceBreakerThreshold", "LineageMaxDepth", "SpillRetries", "SpillTargetFraction",
)


@pytest.fixture(autouse=True)
def _clean_recovery_state():
    """Recovery on, fresh breakers and epoch, zero backoff, knobs restored
    (both packages)."""
    modin_tpu_torch.set_device("cpu")
    saved = [(getattr(m, k), getattr(m, k).get()) for m in (jcfg, tcfg) for k in _KNOBS]
    for res, rec, cfg in ((jres, jrec, jcfg), (resilience, recovery, tcfg)):
        res.reset_breakers()
        rec.reset_for_tests()
        cfg.ResilienceBackoffS.put(0.0)
        cfg.RecoveryMode.put("Enable")
    resilience.reset_counts()
    gc.collect()
    yield
    for p, v in saved:
        p.put(v)
    for res, rec in ((jres, jrec), (resilience, recovery)):
        res.reset_breakers()
        rec.reset_for_tests()


@pytest.fixture
def jax_metrics():
    seen = collections.Counter()

    def handler(name, value):
        seen[name[len("modin_tpu."):]] += 1

    add_metric_handler(handler)
    yield seen
    clear_metric_handler(handler)


def _counts(prefix=("resilience.", "recovery.")):
    return collections.Counter({k: v for k, v in resilience.COUNTS.items() if k.startswith(prefix) and v})


_N = 512


def _data(seed):
    rng = np.random.default_rng(seed)
    return {
        "a": rng.normal(size=_N),
        "b": rng.integers(0, 1000, _N).astype(np.int64),
        "key": rng.integers(0, 7, _N).astype(np.int64),
    }


def _frames(seed=0):
    data = _data(seed)
    pdf = pandas.DataFrame(data)
    jdf = mpd.DataFrame(data)
    jdf._query_compiler.execute()
    tdf = tpd.DataFrame(data)
    tdf._query_compiler._modin_frame  # ingest outside any fault window
    return jdf, tdf, pdf


def _same(got, want):
    got = got._to_pandas() if hasattr(got, "_to_pandas") else got
    if isinstance(want, pandas.DataFrame):
        pandas.testing.assert_frame_equal(got, want, check_exact=False, rtol=RTOL)
    elif isinstance(want, pandas.Series):
        pandas.testing.assert_series_equal(got, want, check_exact=False, rtol=RTOL)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL)


def _col(values):
    return DeviceColumn.from_numpy(np.asarray(values))


def _times3_plus1(x):
    return x * 3 + 1


def _plus1(x):
    return x + 1


# ====================================================================== #
# lineage records
# ====================================================================== #


class TestLineageAttachment:
    def test_host_materialization_kind(self):
        col = _col(np.arange(32, dtype=np.int64))
        assert col.lineage.kind == recovery.KIND_HOST

    def test_op_replay_kind_for_deployed_output(self):
        base = _col(np.arange(64, dtype=np.int64))
        out = TorchWrapper.deploy(_times3_plus1, (base.data,))
        col = DeviceColumn(out, np.dtype(np.int64), length=64)
        assert col.lineage.kind == recovery.KIND_OP
        assert col.lineage.depth == 1

    def test_lazy_column_gets_lineage_on_materialization(self):
        tdf = tpd.DataFrame(_data(3))
        result = tdf["a"] + tdf["b"]
        frame = result._query_compiler._modin_frame
        assert all(c.is_lazy for c in frame._columns)
        frame.materialize_device()
        assert all(c.lineage is not None and c.lineage.kind == recovery.KIND_OP for c in frame._columns)

    def test_depth_cut_point_matches_the_jax_package(self):
        import jax

        from modin_tpu.core.dataframe.tpu.dataframe import DeviceColumn as JaxColumn
        from modin_tpu.parallel.engine import JaxWrapper

        jcfg.LineageMaxDepth.put(2)
        tcfg.LineageMaxDepth.put(2)
        fn = jax.jit(lambda x: x + 1)
        arr = JaxColumn.from_numpy(np.arange(64, dtype=np.int64)).raw
        j_kinds = []
        for _ in range(4):
            arr = JaxWrapper.deploy(fn, (arr,))
            col = JaxColumn(arr, np.dtype(np.int64), length=64)
            j_kinds.append(col.lineage.kind)
            arr = col.raw
        t = _col(np.arange(64, dtype=np.int64)).data
        t_kinds = []
        for _ in range(4):
            t = TorchWrapper.deploy(_plus1, (t,))
            col = DeviceColumn(t, np.dtype(np.int64), length=64)
            t_kinds.append(col.lineage.kind)
            t = col.data
        # depths 1, 2 replay; 3 passes the bound and is host-checkpointed,
        # which restarts the chain
        assert t_kinds == j_kinds == ["op", "op", "host", "op"]
        assert resilience.COUNTS["recovery.checkpoint_cut"] == 1
        np.testing.assert_array_equal(col.to_numpy(), np.arange(64) + 4)

    def test_io_source_lineage_from_read(self, tmp_path):
        path = tmp_path / "lineage.csv"
        src = pandas.DataFrame({"x": np.arange(100, dtype=np.int64), "y": np.linspace(0, 1, 100)})
        src.to_csv(path, index=False)
        frame = tpd.read_csv(path)._query_compiler._modin_frame
        device_cols = [c for c in frame._columns if c.is_device]
        assert device_cols and all(c.lineage.kind == recovery.KIND_IO for c in device_cols)
        col = device_cols[0]
        expected = col.to_numpy().copy()
        col.host_cache = None
        assert recovery.recover_column(col, force=True) == recovery.KIND_IO
        np.testing.assert_array_equal(col.to_numpy(), expected)


# ====================================================================== #
# re-seat from lineage
# ====================================================================== #


class TestReseat:
    def test_reseat_all_is_bit_exact(self):
        values = np.random.default_rng(5).normal(size=256)
        col = _col(values)
        old = col._data
        assert recovery.reseat_all("unit") >= 1
        assert col._data is not old
        np.testing.assert_array_equal(col.to_numpy(), values)
        np.testing.assert_array_equal(TorchWrapper.materialize(col.data), values)
        assert resilience.COUNTS["recovery.reseat.host"] >= 1
        assert col._device_epoch == recovery.current_epoch() == 1

    def test_op_replay_reseat_without_host_cache(self):
        base = _col(np.arange(128, dtype=np.int64))
        out = TorchWrapper.deploy(_times3_plus1, (base.data,))
        col = DeviceColumn(out, np.dtype(np.int64), length=128)
        assert col.host_cache is None
        old = col._data
        assert recovery.recover_column(col, force=True) == recovery.KIND_OP
        assert col._data is not old
        np.testing.assert_array_equal(col.to_numpy(), np.arange(128) * 3 + 1)

    def test_fused_chain_replays(self):
        tdf = tpd.DataFrame(_data(6))
        pdf = pandas.DataFrame(_data(6))
        s = tdf["a"] * 2 + tdf["b"]
        col = s._query_compiler._modin_frame._columns[0]
        col.data  # one fused launch through deploy
        old = col._data
        assert recovery.recover_column(col, force=True) == recovery.KIND_OP
        assert col._data is not old
        np.testing.assert_array_equal(col.to_numpy(), (pdf["a"] * 2 + pdf["b"]).to_numpy())

    def test_gather_replays_while_its_positions_live(self):
        base = _col(np.arange(100, dtype=np.int64) * 7)
        host_positions = np.array([5, 1, 99, 0], dtype=np.int64)  # the put's origin, kept alive
        positions = TorchWrapper.put(host_positions)
        from modin_tpu_torch.ops.structural import gather_columns_device

        (out,) = gather_columns_device([base.data], positions)
        col = DeviceColumn(out, np.dtype(np.int64))
        assert col.lineage.kind == recovery.KIND_OP
        assert recovery.recover_column(col, force=True) == recovery.KIND_OP
        np.testing.assert_array_equal(col.to_numpy(), [35, 7, 693, 0])

    def test_unrecoverable_without_lineage(self):
        tcfg.RecoveryMode.put("Disable")  # adopt a tensor with no provenance
        col = DeviceColumn(torch.arange(32), np.dtype(np.int64))
        tcfg.RecoveryMode.put("Enable")
        assert col.lineage.kind == recovery.KIND_OPAQUE
        with pytest.raises(recovery.Unrecoverable):
            recovery.recover_column(col, force=True)

    def test_recovery_disabled_is_noop(self):
        tcfg.RecoveryMode.put("Disable")
        _col(np.arange(8))
        assert recovery.reseat_all("unit") == 0

    def test_reseat_once_for_an_epoch_already_recovered(self):
        col = _col(np.arange(64, dtype=np.int64))
        first = recovery.reseat_all("unit", observed_epoch=0)
        tensor = col._data
        # a second observer of the same loss takes the first pass's count
        assert recovery.reseat_all("unit", observed_epoch=0) == first
        assert col._data is tensor and recovery.current_epoch() == 1

    def test_concurrent_observers_share_one_pass(self):
        import sys
        import threading

        cols = [_col(np.arange(256, dtype=np.int64) + i) for i in range(4)]
        barrier = threading.Barrier(16)
        results = []

        def observer():
            barrier.wait(timeout=10)
            results.append(recovery.reseat_all("unit", observed_epoch=0))

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=observer) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert len(results) == 16 and len(set(results)) == 1 and results[0] >= 4
        assert recovery.current_epoch() == 1
        assert resilience.COUNTS["recovery.device_lost"] == 1
        for i, col in enumerate(cols):
            np.testing.assert_array_equal(col.to_numpy(), np.arange(256) + i)

    def test_derived_caches_are_dropped_not_replayed(self):
        tdf = tpd.DataFrame(_data(8))
        tdf.median()  # builds the sorted representations
        frame = tdf._query_compiler._modin_frame
        assert any(c._sorted_rep is not None for c in frame._columns)
        recovery.reseat_all("unit")
        assert all(c._sorted_rep is None for c in frame._columns)
        assert not any(getattr(h, "is_derived_cache", False) for h in device_ledger.live_columns())
        assert "recovery.unrecoverable" not in resilience.COUNTS


# ====================================================================== #
# chaos: a loss mid-query, both packages
# ====================================================================== #


class TestMidQueryDeviceLost:
    def test_groupby_merge_recovers_bit_exact(self, jax_metrics):
        jdf, tdf, pdf = _frames(seed=11)

        def q(df):
            return df.groupby("key").sum().merge(df.groupby("key").mean(), on="key", suffixes=("_s", "_m"))

        expected = q(pdf)
        with j_midquery(after_deploys=2, times=1, ops=("deploy", "materialize")) as j_inj:
            _same(q(jdf), expected)
        with midquery_device_loss(after_deploys=2, times=1, ops=("deploy", "materialize")) as t_inj:
            _same(q(tdf), expected)
        assert j_inj.injected == t_inj.injected == 1
        assert jax_metrics["recovery.device_lost"] == resilience.COUNTS["recovery.device_lost"] == 1
        assert resilience.COUNTS["recovery.reseat.host"] >= 3  # the frame's columns

    def test_retry_after_reseat_absorbs_the_loss(self, jax_metrics):
        jcfg.ResilienceBreakerThreshold.put(50)
        tcfg.ResilienceBreakerThreshold.put(50)
        jdf, tdf, pdf = _frames(seed=13)
        # an elementwise chain materializes in one fused deploy: the loss
        # lands on it, and the re-seat and the retry answer on the device
        with j_midquery(after_deploys=0, times=1) as j_inj:
            _same(jdf["a"] * 2 + jdf["b"], pdf["a"] * 2 + pdf["b"])
        with midquery_device_loss(after_deploys=0, times=1) as t_inj:
            _same(tdf["a"] * 2 + tdf["b"], pdf["a"] * 2 + pdf["b"])
        assert j_inj.injected == t_inj.injected == 1
        for name in ("recovery.device_lost", "recovery.retry.device_lost", "resilience.engine.deploy.device_lost"):
            assert resilience.COUNTS[name] == jax_metrics[name] == 1
        assert not any(".fallback." in n for n in resilience.COUNTS)
        assert not any(".fallback." in n for n in jax_metrics)
        assert "recovery.unrecoverable" not in resilience.COUNTS

    def test_sequenced_losses_across_phases(self, jax_metrics):
        jdf, tdf, pdf = _frames(seed=17)
        steps = [("clean", 1), ("device_lost", 1), ("clean", 2), ("device_lost", 1)]
        from modin_tpu.testing import SequencedFaultInjector as JSeq

        for df, inj_cls in ((jdf, JSeq), (tdf, SequencedFaultInjector)):
            with inj_cls(steps, ops=("deploy", "materialize")) as inj:
                _same(df.sum(numeric_only=True), pdf.sum(numeric_only=True))
                _same(df.groupby("key").sum(), pdf.groupby("key").sum())
            assert inj.injected >= 1
        assert resilience.COUNTS["recovery.device_lost"] >= 1 and jax_metrics["recovery.device_lost"] >= 1

    def test_read_path_recovery(self):
        tdf = tpd.DataFrame(_data(19))
        pdf = pandas.DataFrame(_data(19))
        s = tdf["a"] * 3
        col = s._query_compiler._modin_frame._columns[0]
        col.data
        with inject_faults("device_lost", ops=("materialize",), times=2):
            got = col.to_numpy()
        np.testing.assert_array_equal(got, (pdf["a"] * 3).to_numpy())
        assert resilience.COUNTS["recovery.reseat.op"] >= 1


# ====================================================================== #
# chaos: an OOM burst absorbed by evict-then-retry
# ====================================================================== #


class TestOomEvictThenRetry:
    def test_engine_call_evicts_and_retries(self):
        col = _col(np.random.default_rng(0).normal(size=4096))
        spills_before = device_ledger.spill_count()
        with oom_burst_until_eviction(ops=("deploy",)) as inj:
            assert engine_call("deploy", lambda: "computed") == "computed"
        assert inj.injected >= 1
        assert device_ledger.spill_count() > spills_before
        assert resilience.COUNTS["recovery.retry.oom"] >= 1
        assert memory.COUNTS["memory.device.spill"] >= 1
        np.testing.assert_array_equal(col.to_numpy(), col.to_numpy())

    def test_query_absorbs_burst_without_fallback(self, jax_metrics):
        jcfg.ResilienceBreakerThreshold.put(50)
        tcfg.ResilienceBreakerThreshold.put(50)
        jdf, tdf, pdf = _frames(seed=23)
        ballast_values = np.random.default_rng(1).normal(size=8192)
        from modin_tpu.core.dataframe.tpu.dataframe import DeviceColumn as JaxColumn

        j_ballast = JaxColumn.from_numpy(ballast_values)
        t_ballast = _col(ballast_values)
        want = (pdf["a"] * 2 + pdf["b"]).sum()
        with j_burst(ops=("deploy", "materialize")) as j_inj:
            _same((jdf["a"] * 2 + jdf["b"]).sum(), want)
        with oom_burst_until_eviction(ops=("deploy", "materialize")) as t_inj:
            _same((tdf["a"] * 2 + tdf["b"]).sum(), want)
        assert j_inj.injected >= 1 and t_inj.injected >= 1
        assert resilience.COUNTS["recovery.retry.oom"] >= 1 and jax_metrics["recovery.retry.oom"] >= 1
        assert not any(".fallback." in n for n in resilience.COUNTS)
        np.testing.assert_array_equal(t_ballast.to_numpy(), ballast_values)
        np.testing.assert_array_equal(j_ballast.to_numpy(), ballast_values)

    def test_spill_retries_zero_keeps_oom_terminal(self, jax_metrics):
        for cfg, res, make in ((jcfg, jres, __import__("modin_tpu.testing", fromlist=["x"]).make_device_error),
                               (tcfg, resilience, make_device_error)):
            cfg.SpillRetries.put(0)

            def oom(make=make):
                raise make("oom")

            with pytest.raises(res.DeviceOOM):
                res.engine_call("deploy", oom)
        _col(np.arange(1024, dtype=np.float64))
        with pytest.raises(DeviceOOM):
            engine_call("deploy", lambda: (_ for _ in ()).throw(make_device_error("oom")))
        assert "recovery.retry.oom" not in resilience.COUNTS
        assert "recovery.retry.oom" not in jax_metrics


# ====================================================================== #
# edges: spill safety, input protection, arg rebind, io purge
# ====================================================================== #


class TestRecoveryEdges:
    def test_spill_under_tight_host_budget_keeps_sole_copy(self):
        values = np.arange(1024, dtype=np.int64)
        with tcfg.Memory.context(1):
            col = _col(values)
            col.host_cache = None
            memory.ledger.forget(col)
            assert col.spill() > 0
            assert col.host_cache is not None
            np.testing.assert_array_equal(col.to_numpy(), values)

    def test_evict_for_oom_protects_op_inputs(self):
        cold = _col(np.arange(4096, dtype=np.int64))
        hot = _col(np.arange(4096, dtype=np.int64))
        tcfg.SpillTargetFraction.put(1.0)
        freed = recovery.evict_for_oom("deploy", exclude_ids={memory.storage_key(hot._data)})
        assert freed > 0
        assert cold.is_spilled and not hot.is_spilled

    def test_recover_args_rebinds_to_reseated_tensors(self):
        col = _col(np.arange(256, dtype=np.int64))
        old = col._data
        assert recovery.reseat_all("unit") >= 1
        fresh_args = recovery.recover_args(((old,), 2.0))
        assert fresh_args is not None
        (leaf,), scalar = fresh_args
        assert scalar == 2.0
        assert leaf is col._data and leaf is not old

    def test_io_replay_cache_purged_after_pass(self, tmp_path):
        path = tmp_path / "purge.csv"
        pandas.DataFrame({"x": np.arange(64, dtype=np.int64)}).to_csv(path, index=False)
        frame = tpd.read_csv(path)._query_compiler._modin_frame
        col = next(c for c in frame._columns if c.is_device)
        col.host_cache = None
        assert recovery.recover_column(col, force=True) == recovery.KIND_IO
        replayer = col.lineage.replay.func.__self__
        recovery._purge_io_caches()
        assert replayer._cache is None
        np.testing.assert_array_equal(col.to_numpy(), np.arange(64))

    def test_lineage_never_pins_device_memory(self):
        before = device_ledger.total_bytes()
        base = _col(np.arange(4096, dtype=np.int64))
        out = TorchWrapper.deploy(_times3_plus1, (base.data,))
        col = DeviceColumn(out, np.dtype(np.int64))
        del base, out, col
        gc.collect()
        assert device_ledger.total_bytes() <= before
        assert not recovery._provenance or all(r.ref() is not None for r in recovery._provenance.values())

    def test_deploy_rebinds_after_a_second_loss(self):
        # the seam's retry after the re-seat fails again: the arguments are
        # rebound to the re-seated columns and the call runs once more
        col = _col(np.arange(64, dtype=np.int64))
        with SequencedFaultInjector([("device_lost", 2)], ops=("deploy",)):
            out = TorchWrapper.deploy(_times3_plus1, (col.data,))
        np.testing.assert_array_equal(out.numpy(), np.arange(64) * 3 + 1)
        assert resilience.COUNTS["recovery.retry.rebind"] == 1


# ====================================================================== #
# sequenced injectors
# ====================================================================== #


class TestSequencedInjectors:
    def test_schedule_orders_and_exhausts(self):
        inj = SequencedFaultInjector([("clean", 2), ("transient", 1), ("clean", 1)], ops=("deploy",))
        fired = []
        with inj:
            for _ in range(6):
                try:
                    resilience._fault_hook("deploy")
                    fired.append("clean")
                except Exception:
                    fired.append("fault")
        assert fired == ["clean", "clean", "fault", "clean", "clean", "clean"]
        assert inj.injected == 1 and inj.calls == 6

    def test_non_matching_ops_pass_through(self):
        with midquery_device_loss(after_deploys=0, times=1) as inj:
            resilience._fault_hook("materialize")
        assert inj.injected == 0

    def test_rejects_unknown_kinds(self):
        with pytest.raises(ValueError):
            SequencedFaultInjector([("nonsense", 1)])

    def test_oom_burst_clears_after_spill(self):
        col = _col(np.arange(2048, dtype=np.int64))
        with OomBurstInjector(ops=("deploy",), spills=1) as inj:
            with pytest.raises(torch.cuda.OutOfMemoryError):
                resilience._fault_hook("deploy")
            assert device_ledger.spill_lru(10**12) > 0
            assert col.is_spilled
            resilience._fault_hook("deploy")
        assert inj.injected == 1

    def test_exclusive_with_plain_injector(self):
        with inject_faults("oom"):
            with pytest.raises(RuntimeError):
                with midquery_device_loss(after_deploys=1):
                    pass

    def test_mixed_injector_cycles_kinds(self):
        from modin_tpu_torch.testing import MixedFaultInjector

        kinds = []
        with MixedFaultInjector(kinds=("oom", "device_lost"), ops=("deploy",), period=2, times=4) as inj:
            for _ in range(10):
                try:
                    resilience._fault_hook("deploy")
                except Exception as err:
                    kinds.append(type(resilience.classify_device_error(err)).__name__)
        assert kinds == ["DeviceOOM", "DeviceLost", "DeviceOOM", "DeviceLost"] and inj.injected == 4
