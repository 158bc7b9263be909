"""Buffer donation in the torch port's fused whole-plan leg
(``plan/fuse._donation_candidates``, ``ops/reductions._mark_and_run``,
``ops/groupby.fused_group_agg``).

The counterparts of ``tests/test_fuse.py``'s donation cases: under a
``DeviceMemoryBudget``, a filtered reduction and a filtered groupby from
``read_csv`` under ``MODIN_TPU_TORCH_FUSE=Fused`` consume the scan's
sole-consumer columns (marked donated, the exact host copy
authoritative), give the JAX package's and pandas' answers, and a later
read of a donated column restores it; a shared or deferred column is never
donated, and with no budget nothing is donated, so a second query on the
frame restores nothing.  The kernels' plain versions run here.

Tolerance: labels, dtypes and integer values exactly; float values to rtol
1e-12 (sums add in another order on each route).
"""

import threading

import numpy as np
import pandas
import pytest
import torch

import modin_tpu.pandas as mpd
from modin_tpu.config import FuseMode as JaxFuseMode
from modin_tpu.utils import to_pandas as jax_to_pandas

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch.config import DeviceMemoryBudget, FuseMinRows, FuseMode
from modin_tpu_torch.core import memory
from modin_tpu_torch.core.dataframe.torch.dataframe import DeviceColumn
from modin_tpu_torch.plan import fuse


@pytest.fixture(autouse=True)
def _cpu_device():
    modin_tpu_torch.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _join_jax_watchdog_threads():
    yield
    for t in threading.enumerate():
        if t.name.startswith("modin-tpu-watchdog"):
            t.join(timeout=5)


#: a budget no test comes near: donation is on, and nothing spills
ROOMY_BUDGET = 1 << 40


def _write_csv(tmp_path, n=3000, name="donate.csv", seed=41):
    rng = np.random.default_rng(seed)
    pandas.DataFrame({
        "a": rng.integers(-10, 10, n),
        "b": rng.uniform(0, 1, n),
        "c": rng.uniform(-1, 1, n),
        "d": rng.integers(0, 9, n),
    }).to_csv(tmp_path / name, index=False)
    return str(tmp_path / name)


def _equal(got, want):
    if isinstance(want, pandas.DataFrame):
        pandas.testing.assert_frame_equal(got, want, check_exact=False, rtol=1e-12)
    else:
        pandas.testing.assert_series_equal(got, want, check_exact=False, rtol=1e-12)


def _scan_columns(md):
    """The device columns of the deferred read's cached parses."""
    origin = md._query_compiler._plan.origin
    return [c for qc, _nbytes in origin.cache.values() for c in qc._modin_frame._columns if c.is_device]


PIPELINES = {
    "reduce": lambda d: d.query("a > 0")[["b", "c"]].agg("sum"),
    "groupby": lambda d: d.query("a > 0")[["b", "c", "d"]].groupby("d").agg("sum"),
    "groupby_mean": lambda d: d[d["a"] > 2].groupby("d").agg("mean"),
}


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_donated_runs_answer_as_the_jax_package_and_pandas(tmp_path, name):
    path = _write_csv(tmp_path)
    pipeline = PIPELINES[name]
    donated0 = memory.COUNTS["fuse.donated"]
    with FuseMode.context("Fused"), DeviceMemoryBudget.context(ROOMY_BUDGET):
        md = tpd.read_csv(path)
        got = tpd.to_pandas(pipeline(md))
    assert memory.COUNTS["fuse.donated"] > donated0
    donated = [c for c in _scan_columns(md) if c.donated]
    assert donated and all(c.is_spilled and c.host_cache is not None for c in donated)
    with JaxFuseMode.context("Fused"):
        want_jax = jax_to_pandas(pipeline(mpd.read_csv(path)))
    want = pipeline(pandas.read_csv(path))
    _equal(got, want)
    _equal(got, want_jax)


def test_use_after_donate_restores(tmp_path):
    path = _write_csv(tmp_path, name="reuse.csv")
    restores0 = memory.COUNTS["fuse.donated_restore"]
    with FuseMode.context("Fused"), DeviceMemoryBudget.context(ROOMY_BUDGET):
        md = tpd.read_csv(path)
        first = tpd.to_pandas(PIPELINES["reduce"](md))
        bytes0 = memory.COUNTS["fuse.donated_bytes"]
        donated = [c for c in _scan_columns(md) if c.donated]
        assert donated
        # a device read of the donated scan restores it and answers exactly
        dev = float((md["b"] * 3).sum())
        assert dev == pytest.approx(float((pandas.read_csv(path)["b"] * 3).sum()), rel=1e-12)
        assert memory.COUNTS["fuse.donated_restore"] > restores0
        # the same query again: the restored columns answer as before
        again = tpd.to_pandas(PIPELINES["reduce"](md))
    pandas.testing.assert_series_equal(again, first, check_exact=True)
    assert memory.COUNTS["fuse.donated_bytes"] >= bytes0
    pandas.testing.assert_frame_equal(tpd.to_pandas(md), pandas.read_csv(path))


def test_a_shared_buffer_is_never_donated():
    values = np.arange(4096, dtype=np.float64)
    col = DeviceColumn.from_numpy(values)
    assert col.donation_safe()
    twin = DeviceColumn(col.data, col.pandas_dtype, length=col.length)
    assert not col.donation_safe() and not twin.donation_safe()
    frame = type("F", (), {"_columns": [col]})()
    with DeviceMemoryBudget.context(ROOMY_BUDGET):
        assert fuse._donation_candidates(frame) == []
        del twin
        import gc

        gc.collect()
        assert col.donation_safe()
        assert fuse._donation_candidates(frame) == [col]


def test_a_column_without_a_host_copy_or_deferred_is_never_donated():
    from modin_tpu_torch.ops.lazy import lazy_op

    computed = DeviceColumn(torch.arange(100, dtype=torch.float64), np.dtype(np.float64))
    assert not computed.donation_safe()  # nothing to restore from
    src = DeviceColumn.from_numpy(np.arange(100, dtype=np.float64))
    deferred = DeviceColumn(lazy_op("add", src.data, 1.0), np.dtype(np.float64), length=100)
    assert not deferred.donation_eligible()
    assert deferred.mark_donated() == 0 and deferred.is_lazy


def test_a_pinned_scan_is_not_donated(tmp_path):
    """A second live column over a scan column's storage (a user's other
    reference to it) keeps every column of that storage resident."""
    path = _write_csv(tmp_path, name="pinned.csv")
    with FuseMode.context("Fused"), DeviceMemoryBudget.context(ROOMY_BUDGET):
        md = tpd.read_csv(path)
        qc = md._query_compiler
        frame = qc._modin_frame  # parses every column
        pins = [DeviceColumn(c.data, c.pandas_dtype, length=c.length) for c in frame._columns]
        donated0 = memory.COUNTS["fuse.donated"]
        got = tpd.to_pandas(PIPELINES["reduce"](md))
        assert memory.COUNTS["fuse.donated"] == donated0
        assert not any(c.is_spilled for c in frame._columns)
    _equal(got, PIPELINES["reduce"](pandas.read_csv(path)))
    del pins


@pytest.mark.parametrize("budget", [None, ROOMY_BUDGET])
def test_donation_only_under_a_budget(tmp_path, budget):
    """With no budget the fused leg donates nothing, so the same query on
    the same frame again uploads nothing; under a budget it donates, and
    the second query restores what the first donated.  A residency leg
    the optimizer plans windowed (a budget under the frame's bytes) runs
    the window loop instead, which never donates
    (``test_a_windowed_residency_keeps_fusion_and_donation``)."""
    path = _write_csv(tmp_path, name="budget.csv")
    want = PIPELINES["reduce"](pandas.read_csv(path))
    donated0, dispatches0 = memory.COUNTS["fuse.donated"], fuse.DISPATCHES
    with FuseMode.context("Auto"), FuseMinRows.context(1), DeviceMemoryBudget.context(budget):
        md = tpd.read_csv(path)
        first = tpd.to_pandas(PIPELINES["reduce"](md))
        restores0 = memory.COUNTS["memory.device.restore"]
        again = tpd.to_pandas(PIPELINES["reduce"](md))
        restores = memory.COUNTS["memory.device.restore"] - restores0
    assert fuse.DISPATCHES - dispatches0 == 2
    if budget is None:
        assert memory.COUNTS["fuse.donated"] == donated0 and restores == 0
        assert not any(c.is_spilled for c in _scan_columns(md))
    else:
        assert memory.COUNTS["fuse.donated"] > donated0 and restores > 0
    _equal(first, want)
    pandas.testing.assert_series_equal(again, first, check_exact=True)


def test_a_windowed_residency_keeps_fusion_and_donation(tmp_path, monkeypatch):
    """A budget under the file's bytes: the optimizer plans the residency
    windowed, and the joint constraints fix the compile leg staged and turn
    donation off.  The window loop keeps the fused kernel: each filtered
    window's chain and sum is one masked launch (``fuse.DISPATCHES``), and
    it donates nothing, since the loop owns its windows' tensors."""
    from modin_tpu_torch.plan import optimizer
    from modin_tpu_torch.streaming import executor

    path = _write_csv(tmp_path, name="windowed.csv")
    want = PIPELINES["reduce"](pandas.read_csv(path))
    chosen = []
    choose = optimizer.choose
    monkeypatch.setattr(optimizer, "choose", lambda root, *a, **k: chosen.append(choose(root, *a, **k)) or chosen[-1])
    donated0, dispatches0 = memory.COUNTS["fuse.donated"], fuse.DISPATCHES
    windows0 = executor.COUNTS.get("stream.window.count", 0)
    budget = memory.device_ledger.total_bytes() + 4096  # under the file's columns
    with FuseMode.context("Auto"), FuseMinRows.context(1), DeviceMemoryBudget.context(budget):
        got = tpd.to_pandas(PIPELINES["reduce"](tpd.read_csv(path)))
    strategies = [st for state in chosen for st in state.by_node.values() if "residency" in st.legs]
    assert strategies and all(st.legs["residency"] == "windowed" and st.legs["compile"] == "staged"
                              and not st.donate for st in strategies)
    windows = executor.COUNTS.get("stream.window.count", 0) - windows0
    assert windows > 1 and fuse.DISPATCHES - dispatches0 == windows
    assert memory.COUNTS["fuse.donated"] == donated0
    _equal(got, want)
