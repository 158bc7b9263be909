"""The device-memory ledger, spill and restore of the torch port
(``modin_tpu_torch/core/memory.py``, ``DeviceColumn``'s memory protocol).

- Accounting: entries are keyed on the tensor's storage, so two columns
  over one storage (a column and a view of it) count its bytes once, pin it
  together and are neither its sole consumer.
- Policy, on a private ledger of stand-in holders: ``spill_lru`` takes the
  derived entries first and each tier coldest first, skips the excluded
  storages, and ``admit`` spills only past ``resident + estimate > budget``.
- End to end under ``MODIN_TPU_TORCH_DEVICE_MEMORY_BUDGET``: frames from
  ``from_pandas`` and computed (materialized) frames spill and restore, and
  every answer equals pandas' and the JAX package's under the same budget;
  a spilled column's sorted representation is dropped and rebuilt; a
  spilled column without a host copy raises instead of answering stale.

The budgets are set relative to the ledger's resident bytes when a test
starts (other tests' live columns count too).  Tolerance: ints exactly,
float sums and means to rtol 1e-12 against pandas (another summation
order), the port's own results before and after a spill bit for bit.
"""

import gc

import numpy as np
import pandas
import pytest
import torch

import modin_tpu.pandas as mpd
from modin_tpu.config import DeviceMemoryBudget as JaxDeviceMemoryBudget
from modin_tpu.utils import to_pandas as jax_to_pandas

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch.config import DeviceMemoryBudget, Memory
from modin_tpu_torch.core import memory
from modin_tpu_torch.core.dataframe.torch.dataframe import DeviceColumn
from modin_tpu_torch.ops import sorted_cache

ROWS = 4000


@pytest.fixture(autouse=True)
def _cpu_device():
    modin_tpu_torch.set_device("cpu")
    gc.collect()


def _frame(seed: int, rows: int = ROWS) -> pandas.DataFrame:
    rng = np.random.default_rng(seed)
    return pandas.DataFrame({
        "k": rng.integers(0, 100, rows),
        "a": rng.integers(-1000, 1000, rows),
        "b": rng.uniform(-1, 1, rows),
        "c": rng.integers(0, 7, rows).astype(np.int32),
    })


def _frame_bytes(pdf: pandas.DataFrame) -> int:
    return int(sum(pdf[c].to_numpy().nbytes for c in pdf.columns))


# ---------------------------------------------------------------------- #
# accounting
# ---------------------------------------------------------------------- #


def test_a_view_of_one_storage_counts_once():
    t = torch.arange(1000, dtype=torch.float64)
    before = memory.device_resident_bytes()
    col = DeviceColumn(t, np.dtype(np.float64), host_cache=t.numpy().copy())
    assert memory.device_resident_bytes() == before + 8000
    view = DeviceColumn(t[200:700], np.dtype(np.float64), host_cache=t[200:700].numpy().copy())
    assert memory.device_resident_bytes() == before + 8000  # the same storage
    assert memory.device_ledger.buffer_consumers(t) == 2
    assert not col.donation_safe() and not view.donation_safe()
    # both pin it: the first spill frees nothing, the second the storage
    assert col.spill() == 0
    assert memory.device_resident_bytes() == before + 8000
    assert view.spill() == 8000
    assert memory.device_resident_bytes() == before
    # each restores its own values into a fresh storage
    assert torch.equal(view.data, torch.arange(200, 700, dtype=torch.float64))
    assert torch.equal(col.data, t)
    assert memory.device_resident_bytes() == before + 8000 + 4000


def test_a_dead_column_leaves_the_ledger():
    before = memory.device_resident_bytes()
    col = DeviceColumn(torch.zeros(512, dtype=torch.int64), np.dtype(np.int64))
    twin = DeviceColumn(col.data, np.dtype(np.int64))
    assert memory.device_resident_bytes() == before + 4096
    del col
    gc.collect()
    assert memory.device_resident_bytes() == before + 4096  # the twin still holds it
    assert twin.donation_eligible() is False  # no host copy
    del twin
    gc.collect()
    assert memory.device_resident_bytes() == before


def test_deferred_columns_register_when_they_materialize():
    from modin_tpu_torch.ops.lazy import lazy_op

    t = torch.arange(256, dtype=torch.int64)
    src = DeviceColumn(t, np.dtype(np.int64), host_cache=t.numpy().copy())
    before = memory.device_resident_bytes()
    col = DeviceColumn(lazy_op("mul", src.data, 3), np.dtype(np.int64), length=256)
    assert col.is_lazy and memory.device_resident_bytes() == before
    assert col.spill() == 0 and not col.donation_eligible()  # a deferred column never spills
    assert torch.equal(col.data, t * 3)
    assert memory.device_resident_bytes() == before + 2048


# ---------------------------------------------------------------------- #
# the spill policy, on a private ledger
# ---------------------------------------------------------------------- #


class _Holder:
    """A stand-in ledger holder: a tensor, and a spill that drops it."""

    def __init__(self, ledger, name, nbytes, derived=False, log=None):
        self.name, self.ledger, self.log = name, ledger, log
        self._data = torch.zeros(nbytes, dtype=torch.uint8)
        self._dev_key = None
        self.is_derived_cache = derived
        self.is_lazy = False
        ledger.register(self)

    def spill(self):
        self.log.append(self.name)
        freed = self.ledger.deregister(self)
        self._data = None
        return freed


def test_spill_order_is_derived_first_then_coldest():
    ledger, log = memory._DeviceLedger(), []
    a = _Holder(ledger, "a", 1000, log=log)
    rep_a = _Holder(ledger, "rep_a", 300, derived=True, log=log)
    b = _Holder(ledger, "b", 1000, log=log)
    c = _Holder(ledger, "c", 1000, log=log)
    rep_b = _Holder(ledger, "rep_b", 300, derived=True, log=log)
    ledger.touch(a)  # a is now the warmest column
    assert ledger.total_bytes() == 3600
    assert ledger.spill_lru(500) == 600
    assert log == ["rep_a", "rep_b"]
    assert ledger.spill_lru(1500) == 2000
    assert log == ["rep_a", "rep_b", "b", "c"]
    assert ledger.total_bytes() == 1000 and a._data is not None


def test_spill_skips_the_excluded_storages():
    ledger, log = memory._DeviceLedger(), []
    a = _Holder(ledger, "a", 100, log=log)
    b = _Holder(ledger, "b", 100, log=log)
    ledger.spill_lru(100, exclude_ids={memory.storage_key(a._data)})
    assert log == ["b"] and b._data is None


class _Failing(_Holder):
    def __init__(self, ledger, name, nbytes, error, log=None):
        super().__init__(ledger, name, nbytes, log=log)
        self.error = error

    def spill(self):
        raise self.error


def test_a_host_copy_that_does_not_fit_is_counted_and_the_next_spills():
    ledger, log = memory._DeviceLedger(), []
    stuck = _Failing(ledger, "stuck", 100, MemoryError(), log=log)
    b = _Holder(ledger, "b", 100, log=log)
    failed0 = memory.COUNTS["memory.device.spill_failed"]
    assert ledger.spill_lru(100) == 100
    assert log == ["b"] and stuck._data is not None and b._data is None
    assert memory.COUNTS["memory.device.spill_failed"] == failed0 + 1


def test_a_device_error_in_a_spill_propagates():
    ledger = memory._DeviceLedger()
    broken = _Failing(ledger, "broken", 100, RuntimeError("CUDA error: an illegal memory access was encountered"))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        ledger.spill_lru(100)
    assert broken._data is not None


def test_admission_projects_resident_plus_estimate(monkeypatch):
    ledger, log = memory._DeviceLedger(), []
    holders = [_Holder(ledger, name, 1000, log=log) for name in "abc"]
    monkeypatch.setattr(memory, "_DEVICE_BUDGET", 4000)
    ledger.admit(1000)
    assert log == []  # 3000 + 1000 fits
    ledger.admit(1500)
    assert log == ["a"]  # 500 over: the coldest column goes
    monkeypatch.setattr(memory, "_DEVICE_BUDGET", None)
    ledger.admit(10**9)
    assert log == ["a"] and [h._data is None for h in holders] == [True, False, False]


def test_the_budget_subscription_reaches_the_seams():
    assert memory._DEVICE_BUDGET is None
    with DeviceMemoryBudget.context(12345):
        assert memory._DEVICE_BUDGET == memory.device_ledger.budget() == 12345
    assert memory._DEVICE_BUDGET is None


# ---------------------------------------------------------------------- #
# spill and restore end to end
# ---------------------------------------------------------------------- #


def _queries(df):
    """The same queries on pandas, the port and the JAX package."""
    return {
        "sum": lambda: df.sum(),
        "mean": lambda: df.mean(),
        "groupby_sum": lambda: df.groupby("k").sum(),
        "median": lambda: df.median(),
        "nunique": lambda: df.nunique(),
        "shifted": lambda: (df["a"] * 3 + 1).sum(),
    }


def _as_pandas(x):
    if isinstance(x, (pandas.DataFrame, pandas.Series)) or np.isscalar(x):
        return x
    try:
        return tpd.to_pandas(x)
    except (TypeError, AttributeError):
        return jax_to_pandas(x)


def _assert_same(got, want, what):
    if isinstance(want, pandas.DataFrame):
        pandas.testing.assert_frame_equal(got, want, check_exact=False, rtol=1e-12, obj=what)
    elif isinstance(want, pandas.Series):
        pandas.testing.assert_series_equal(got, want, check_exact=False, rtol=1e-12, obj=what)
    else:
        assert got == pytest.approx(want, rel=1e-12), what


def test_from_pandas_and_computed_frames_spill_and_restore_under_a_budget():
    pdfs = [_frame(seed) for seed in (1, 2, 3)]
    nbytes = _frame_bytes(pdfs[0])
    counts0 = dict(memory.COUNTS)
    resident0 = memory.device_resident_bytes()
    # room for two of the three frames (and their computed columns) at once
    with DeviceMemoryBudget.context(resident0 + 2 * nbytes + nbytes // 2):
        frames = [tpd.from_pandas(p) for p in pdfs]
        computed = [(f * 3 + 1) for f in frames]
        for c in computed:
            c._query_compiler._modin_frame.materialize_device()
        answers = {}
        for i, (frame, pdf) in enumerate(zip(frames + computed, pdfs + [p * 3 + 1 for p in pdfs])):
            for name, q in _queries(frame).items():
                want = _queries(pdf)[name]()
                answers[i, name] = got = _as_pandas(q())
                _assert_same(got, want, f"frame {i} {name}")
        assert memory.device_resident_bytes() <= resident0 + 2 * nbytes + nbytes // 2 + nbytes
    spills = memory.COUNTS["memory.device.spill"] - counts0["memory.device.spill"]
    restores = memory.COUNTS["memory.device.restore"] - counts0["memory.device.restore"]
    copies = memory.COUNTS["memory.device.spill_copy"] - counts0["memory.device.spill_copy"]
    assert spills > 0 and restores > 0
    assert copies > 0  # computed columns have no host copy: their spill fetched one
    # without a budget the same queries give the same answers, bit for bit
    for i, frame in enumerate(frames + computed):
        for name, q in _queries(frame).items():
            got = _as_pandas(q())
            if isinstance(got, pandas.DataFrame):
                pandas.testing.assert_frame_equal(got, answers[i, name], check_exact=True)
            elif isinstance(got, pandas.Series):
                pandas.testing.assert_series_equal(got, answers[i, name], check_exact=True)
            else:
                assert got == answers[i, name]


def test_answers_equal_the_jax_package_under_the_same_budget():
    pdf = _frame(11)
    nbytes = _frame_bytes(pdf)
    from modin_tpu.core.memory import device_resident_bytes as jax_resident

    with DeviceMemoryBudget.context(memory.device_resident_bytes() + nbytes), \
            JaxDeviceMemoryBudget.context(jax_resident() + 8 * nbytes):
        t_frames = [tpd.from_pandas(pdf), tpd.from_pandas(pdf + 1)]
        j_frames = [mpd.DataFrame(pdf), mpd.DataFrame(pdf + 1)]
        for t, j in zip(t_frames, j_frames):
            for name in ("sum", "groupby_sum", "median", "nunique"):
                got = _as_pandas(_queries(t)[name]())
                want = jax_to_pandas(_queries(j)[name]())
                _assert_same(got, want, name)
    assert memory.device_ledger.spill_count() > 0


def test_a_spilled_column_drops_its_sorted_representation():
    pdf = _frame(21)
    df = tpd.from_pandas(pdf)
    col = df._query_compiler._modin_frame._columns[pdf.columns.get_loc("b")]
    median = tpd.to_pandas(df.median())
    assert sorted_cache.peek(col)
    rep = col._sorted_rep
    assert memory.device_ledger.buffer_consumers(rep.data) == 1  # a derived entry
    before = memory.device_resident_bytes()
    freed = col.spill()
    assert freed == ROWS * 8 and col.is_spilled and col._sorted_rep is None
    assert memory.device_resident_bytes() == before - ROWS * 8 - rep.data.numel() * 8
    assert not sorted_cache.peek(col)  # probing does not restore
    assert col.is_spilled
    pandas.testing.assert_series_equal(tpd.to_pandas(df.median()), median, check_exact=True)
    assert not col.is_spilled and sorted_cache.peek(col)


def test_derived_entries_spill_before_columns():
    pdf = _frame(31)
    df = tpd.from_pandas(pdf)
    tpd.to_pandas(df.median())  # sorted representations of every column
    cols = df._query_compiler._modin_frame._columns
    assert all(sorted_cache.peek(c) for c in cols)
    spills0 = memory.COUNTS["memory.device.spill"]
    # a small overshoot: the derived entries alone cover it
    with DeviceMemoryBudget.context(memory.device_resident_bytes()):
        memory.device_ledger.admit(ROWS)
    assert memory.COUNTS["memory.device.spill"] > spills0
    assert not any(c.is_spilled for c in cols)
    assert sum(sorted_cache.peek(c) for c in cols) < len(cols)


def test_restore_without_a_host_copy_raises():
    col = DeviceColumn(torch.arange(64, dtype=torch.int64), np.dtype(np.int64))
    col.spill()  # fetches a host copy first
    assert col.host_cache is not None
    col.host_cache = None  # lost: the restore must not answer
    with pytest.raises(RuntimeError, match="no host copy"):
        col.data


def test_the_host_budget_keeps_a_spilled_columns_only_copy():
    values = np.arange(1000, dtype=np.int64)
    spilled = DeviceColumn.from_numpy(values)
    spilled.spill()
    resident = DeviceColumn.from_numpy(values.copy())
    with Memory.context(1):  # below every copy: drop what may be dropped
        memory.ledger.enforce()
    assert spilled.host_cache is not None  # its only copy
    assert resident.host_cache is None  # its tensor is authoritative
    assert np.array_equal(resident.to_numpy(), values)
    assert np.array_equal(spilled.to_numpy(), values)


def test_a_spilled_computed_column_frees_its_storage_without_the_collector():
    """A fused run keeps no reference cycle to its leaves or results: the
    spilled tensor of a materialized expression is freed at once."""
    import weakref

    pdf = _frame(41)
    df = tpd.from_pandas(pdf)
    gc.collect()
    gc.disable()
    try:
        computed = df * 3 + 1
        computed._query_compiler._modin_frame.materialize_device()
        col = computed._query_compiler._modin_frame._columns[1]
        ref = weakref.ref(col.data)
        assert col.spill() == ROWS * 8
        assert ref() is None
    finally:
        gc.enable()
    assert np.array_equal(col.to_numpy(), pdf["a"].to_numpy() * 3 + 1)
