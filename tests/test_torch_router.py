"""The kernel router of the torch port (``modin_tpu_torch/ops/router.py``)
held against the JAX package's (``modin_tpu/ops/router.py``).

With one forced calibration table through both packages'
``set_calibration``, the verdicts of ``decide``, ``forced_host``,
``decide_compile`` and ``decide_residency`` and the costs of
``predicted_costs`` must agree exactly (the same arithmetic on the same
floats) over a grid of op x rows x strategies x mode.  Then the calibration
store: the table round-trips through ``CacheDir`` (under ``tmp_path``), a
table keyed for another card or torch is refused, and a frame under
``KernelRouterMinRows`` never calibrates.  No test measures the real
calibration: ``_measure`` is replaced where a resolution could reach it.

Tolerance: none; every cost and verdict is compared for equality.
"""

import contextlib
import json

import numpy as np
import pandas
import pytest

import modin_tpu.config as jax_config
from modin_tpu.ops import router as jax_router

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch import config
from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
from modin_tpu_torch.ops import calibration as calstore
from modin_tpu_torch.ops import router

#: a forced table (never measured): the sort-shaped device cost rides on
#: device_sort_s, the host costs differ by family and regime
TABLE = {
    "rows": 1 << 16,
    "device_sort_s": 0.004,
    "device_consume_s": 0.0004,
    "device_hist_s": 0.0007,
    "host_median_low_s": 0.003,
    "host_median_high_s": 0.009,
    "host_quantile_low_s": 0.0031,
    "host_quantile_high_s": 0.0095,
    "host_nunique_low_s": 0.0006,
    "host_nunique_high_s": 0.012,
    "host_mode_low_s": 0.0011,
    "host_mode_high_s": 0.03,
}

OPS = ("median", "quantile", "nunique", "mode")
ROWS = (0, 1000, 1 << 20, 3_000_000, 10**8)
STRATEGIES = (["sort"], ["hist"], ["cached"], ["dict"], ["sort", "hist"], ["cached", "sort", "dict"], [])


@pytest.fixture(autouse=True)
def _cpu_and_forced_table():
    modin_tpu_torch.set_device("cpu")
    router.set_calibration(dict(TABLE))
    jax_router.set_calibration(dict(TABLE))
    yield
    router.set_calibration(None)
    jax_router.set_calibration(None)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("mode", ["Auto", "Device", "Host"])
@pytest.mark.parametrize("min_rows", [0, 1 << 20])
def test_decide_and_costs_agree_with_the_jax_router(op, mode, min_rows):
    with config.KernelRouterMode.context(mode), jax_config.KernelRouterMode.context(mode), \
            config.KernelRouterMinRows.context(min_rows), jax_config.KernelRouterMinRows.context(min_rows):
        for n in ROWS:
            for strategies in STRATEGIES:
                assert router.predicted_costs(op, n, strategies, TABLE) == jax_router.predicted_costs(
                    op, n, strategies, TABLE
                )
                assert router.decide(op, n, strategies) == jax_router.decide(op, n, strategies), (n, strategies)
            assert router.forced_host(op, n) == jax_router.forced_host(op, n)


def test_the_grid_crosses_over():
    """The grid above holds both verdicts: the table puts the crossover
    inside it."""
    seen = {router.decide(op, n, s) for op in OPS for n in ROWS for s in STRATEGIES}
    assert seen == {"device", "host"}


@pytest.mark.parametrize("mode", ["Auto", "Fused", "Staged"])
def test_decide_compile_agrees_with_the_jax_router(mode):
    with config.FuseMode.context(mode), jax_config.FuseMode.context(mode), \
            config.FuseMinRows.context(5000), jax_config.FuseMinRows.context(5000):
        for n in (0, 4999, 5000, 10**7):
            assert router.decide_compile("sig", n) == jax_router.decide_compile("sig", n)


@pytest.mark.parametrize("budget", [None, 1 << 20, 1 << 30])
def test_decide_residency_agrees_with_the_jax_router(budget):
    """The port's verdict is the reference's Auto arm (the pins, Resident
    and Windowed, are held to the reference's in
    ``test_torch_streaming.py``)."""
    from modin_tpu.core.memory import device_ledger as jax_ledger

    from modin_tpu_torch.core.memory import device_ledger

    with contextlib.ExitStack() as stack:
        stack.enter_context(jax_config.StreamMode.context("Auto"))
        stack.enter_context(config.DeviceMemoryBudget.context(budget))
        if budget is not None:  # the JAX package's budget is unset by default
            stack.enter_context(jax_config.DeviceMemoryBudget.context(budget))
        assert jax_ledger.budget() == device_ledger.budget() == budget
        for est in (0, 1 << 19, 1 << 20, (1 << 20) + 1, 1 << 30, (1 << 30) + 1, 1 << 40):
            # each ledger's own residents as the op's own bytes: the
            # headroom is the budget on both sides
            got = router.decide_residency("scan_reduce", est, self_bytes=device_ledger.total_bytes())
            want = jax_router.decide_residency("scan_reduce", est, self_bytes=jax_ledger.total_bytes())
            assert got == want, est


def test_decide_layout_is_local_on_one_device():
    assert router.decide_layout("sort", 10**9, payload_cols=4) == "local"


def test_verdicts_are_counted():
    before = dict(router.COUNTS)
    with config.KernelRouterMinRows.context(0):
        assert router.decide("nunique", 10**8, ["hist"]) == "host"
        assert router.decide("median", 1000, ["sort"]) == "device"
    assert router.COUNTS["router.nunique.host"] == before.get("router.nunique.host", 0) + 1
    assert router.COUNTS["router.median.device"] == before.get("router.median.device", 0) + 1


@pytest.mark.parametrize("fixed,growing,growth", [
    (2e-5, 1e-4, 64.0), (0.0, 3e-3, 64.0), (1e-3, 1e-6, 64.0), (5e-5, 2e-4, 87.1),
])
def test_the_fit_recovers_a_fixed_and_a_growing_part(fixed, growing, growth):
    t_small, t_large = fixed + growing, fixed + growing * growth
    got_fixed, got_growing = router.fit_fixed_and_growing(t_small, t_large, growth)
    assert got_fixed == pytest.approx(fixed, rel=1e-9, abs=1e-15)
    assert got_growing == pytest.approx(growing, rel=1e-9)


def test_the_fit_never_goes_negative():
    # no slower at the large size (noise): all of it grows
    assert router.fit_fixed_and_growing(2e-3, 1e-3, 64.0) == (0.0, 1e-3 / 64.0)
    # faster than linear: no negative fixed part
    fixed, growing = router.fit_fixed_and_growing(1e-6, 1.0, 64.0)
    assert fixed == 0.0 and growing > 0.0


def test_predicted_costs_add_each_device_terms_fixed_part():
    """A measured table's fixed parts add once a device term; a table
    without them (a forced one, or the reference's) predicts as before."""
    fixed = {"device_sort_fixed_s": 1e-3, "device_consume_fixed_s": 2e-4, "device_hist_fixed_s": 3e-4}
    with_fixed = dict(TABLE, **fixed)
    per_strategy = {"sort": 1e-3 + 2e-4, "cached": 2e-4, "hist": 3e-4, "dict": 0.0}
    for op in OPS:
        for n in ROWS:
            for strategies in STRATEGIES:
                plain = router.predicted_costs(op, n, strategies, TABLE)
                got = router.predicted_costs(op, n, strategies, with_fixed)
                extra = sum(per_strategy[s] for s in strategies)
                assert got["host_s"] == plain["host_s"]
                assert got["device_s"] == pytest.approx(plain["device_s"] + extra, rel=1e-12, abs=1e-15)


def test_measure_times_the_device_entries_at_two_sizes():
    """``_measure`` on the CPU at a tiny size (the tensors lie on the CPU,
    so the histogram runs bincount's plain version): every entry is there
    and none is negative."""
    with config.KernelRouterCalibrationRows.context(1 << 10):
        table = router._measure()
    assert table["rows"] == 1 << 10 and table["device_fit_rows"] == (1 << 10) * router.DEVICE_FIT_FACTOR
    assert table["version"] == router._CAL_VERSION and table["platform"] == "cpu"
    for name in router.DEVICE_ENTRIES:
        for suffix in ("s", "fixed_s", "at_rows_s", "at_fit_rows_s"):
            assert table[f"device_{name}_{suffix}"] >= 0.0
    for op in OPS:
        for regime in ("low", "high"):
            assert table[f"host_{op}_{regime}_s"] > 0.0


def test_calibration_scalings_agree_with_the_jax_store():
    from modin_tpu.ops import calibration as jax_calstore

    for n in (0, 1, 2, 1000, 1 << 18, 10**8):
        for cal in (1, 2, 1 << 18):
            assert calstore.nlogn_scale(n, cal) == jax_calstore.nlogn_scale(n, cal)
            assert calstore.linear_scale(n, cal) == jax_calstore.linear_scale(n, cal)


# ---------------------------------------------------------------------- #
# the calibration store
# ---------------------------------------------------------------------- #


@pytest.fixture
def lazy_router(tmp_path, monkeypatch):
    """Lazy resolution under a CacheDir in tmp_path, with ``_measure``
    replaced by a stub that counts its calls."""
    calls = []

    def fake_measure():
        calls.append(1)
        return dict(TABLE, version=router._CAL_VERSION, platform=router._platform(),
                    device=router._device_key())

    monkeypatch.setattr(router, "_measure", fake_measure)
    router.set_calibration(None)
    with config.CacheDir.context(str(tmp_path / "cache")):
        yield calls
    router.set_calibration(None)


def test_calibration_round_trips_through_the_cache(lazy_router):
    first = router.get_calibration()
    assert lazy_router == [1]
    path = router._cache_path(router._platform(), router._device_key())
    assert path.startswith(str(config.CacheDir.get()))
    with open(path) as f:
        assert json.load(f) == first
    router.set_calibration(None)
    assert router.get_calibration() == first  # from the file: no second measurement
    assert lazy_router == [1]
    assert router.calibration_peek() == first


@pytest.mark.parametrize("field,value", [
    ("device", "NVIDIA H100 80GB HBM3|torch-2.11.0+cu128"),
    ("platform", "cuda"),
    ("version", 0),
])
def test_a_table_keyed_for_another_device_is_refused(lazy_router, field, value):
    path = router._cache_path(router._platform(), router._device_key())
    stale = dict(TABLE, version=router._CAL_VERSION, platform=router._platform(), device=router._device_key())
    stale[field] = value
    stale["device_sort_s"] = 123.0
    calstore.store_table(path, stale)
    assert calstore.load_table(path, version=router._CAL_VERSION, platform=router._platform(),
                               device_key=router._device_key()) is None
    table = router.get_calibration()
    assert lazy_router == [1]  # measured anew
    assert table["device_sort_s"] == TABLE["device_sort_s"]


def test_the_cpu_and_a_card_use_different_files(tmp_path):
    with config.CacheDir.context(str(tmp_path)):
        cpu = calstore.table_path("kernel_router", "cpu", device_key="cpu|torch-2.13.0+cpu", version=1)
        card = calstore.table_path("kernel_router", "cuda", device_key="NVIDIA H100 80GB HBM3|torch-2.11.0",
                                   version=1)
    assert cpu != card and cpu.startswith(str(tmp_path)) and card.startswith(str(tmp_path))


def test_a_failed_calibration_routes_device_and_says_why(tmp_path, monkeypatch):
    def broken():
        raise RuntimeError("no device")

    monkeypatch.setattr(router, "_measure", broken)
    router.set_calibration(None)
    try:
        with config.CacheDir.context(str(tmp_path)), config.KernelRouterMinRows.context(0):
            assert router.decide("median", 10**9, ["sort"]) == "device"
            assert router.CALIBRATION_ERROR == "RuntimeError: no device"
    finally:
        router.set_calibration(None)


def test_small_frames_never_calibrate(lazy_router):
    rng = np.random.default_rng(5)
    pdf = pandas.DataFrame({"a": rng.integers(0, 1 << 30, 5000), "b": rng.integers(0, 9, 5000)})
    df = tpd.from_pandas(pdf)
    defaults = tqc.DEFAULTS_TO_PANDAS
    pandas.testing.assert_series_equal(tpd.to_pandas(df.median()), pdf.median())
    pandas.testing.assert_series_equal(tpd.to_pandas(df.nunique()), pdf.nunique())
    assert lazy_router == []
    assert router.calibration_peek() is None
    assert tqc.DEFAULTS_TO_PANDAS == defaults


@pytest.mark.parametrize("op", ["median", "quantile", "nunique", "mode", "describe"])
def test_a_host_verdict_declines_to_pandas(op):
    """Every sort-shaped site asks the router: a host verdict is a counted
    default, and the answer is pandas'."""
    rng = np.random.default_rng(7)
    pdf = pandas.DataFrame({"a": rng.integers(0, 50, 3000), "b": rng.integers(-20, 20, 3000) / 8})
    df = tpd.from_pandas(pdf)
    call = {"median": lambda d: d.median(), "quantile": lambda d: d.quantile(0.3),
            "nunique": lambda d: d.nunique(), "mode": lambda d: d.mode(), "describe": lambda d: d.describe()}[op]
    counted = "quantile" if op == "describe" else op
    for mode, defaults_added in (("Device", 0), ("Host", 1)):
        before_defaults = tqc.DEFAULTS_TO_PANDAS
        before = router.COUNTS.get(f"router.{counted}.{mode.lower()}", 0)
        with config.KernelRouterMode.context(mode):
            got = tpd.to_pandas(call(df))
        assert tqc.DEFAULTS_TO_PANDAS - before_defaults == defaults_added
        assert router.COUNTS.get(f"router.{counted}.{mode.lower()}", 0) > before
        want = call(pdf)
        if isinstance(want, pandas.DataFrame):
            pandas.testing.assert_frame_equal(got, want)
        else:
            pandas.testing.assert_series_equal(got, want)
