"""The plan optimizer of the torch port (``modin_tpu_torch/plan/optimizer.py``).

The ports of ``tests/test_optimizer.py``'s cases that apply to the port's
legs:

1. Differential grid: ``MODIN_TPU_TORCH_OPT=Auto`` against ``Off``, pandas and
   the JAX package under every pinned kernel and compile leg, and under a
   forced calibration table: the optimizer may re-route, never re-answer.
   Off builds no strategy set and clears the router's consult hook.
2. Plan-time model: ``estimate_selectivity`` equal to the JAX package's on
   the same mask shapes, estimates flowing bottom up, the residency leg
   over the budget and the ledger (a windowed one fixes the compile leg
   staged and turns donation off, the joint constraints), the kernel leg
   under a forced table, which a wall correction never moves.
3. Re-planning: the re-plan factor and the noise floor, one re-plan per
   (node, trigger), the clamped correction, lowered nodes kept; a slow
   scan never sends a later sort-shaped reduction to pandas.
4. EXPLAIN renders each node's strategy and the re-plans.

Priors: the port has no ledger of card runs, so none seed it; both
packages' models run on ``DEFAULT_PRIORS`` here where they are compared.
Tolerance: answers equal pandas' with floats to rtol 1e-12 (another
summation order); Auto and Off bit for bit.
"""

import threading
import time

import numpy as np
import pandas
import pytest

import modin_tpu.pandas as mpd
from modin_tpu.plan import ir as jax_ir
from modin_tpu.plan import optimizer as jax_optimizer
from modin_tpu.utils import to_pandas as jax_to_pandas

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch.config import DeviceMemoryBudget, FuseMode, KernelRouterMode, OptMode, OptReplanFactor
from modin_tpu_torch.core.execution.torch_engine.io import TorchCSVDispatcher
from modin_tpu_torch.ops import router
from modin_tpu_torch.plan import explain, ir, optimizer

FROZEN_TABLE = {
    "rows": 100_000,
    "device_consume_s": 0.001,
    "device_hist_s": 0.002,
    "device_sort_s": 0.010,
    "host_median_low_s": 0.004,
    "host_median_high_s": 0.020,
    "host_quantile_low_s": 0.004,
    "host_quantile_high_s": 0.020,
    "host_nunique_low_s": 0.004,
    "host_nunique_high_s": 0.020,
    "host_mode_low_s": 0.004,
    "host_mode_high_s": 0.020,
}


@pytest.fixture(autouse=True)
def _cpu_device():
    modin_tpu_torch.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _join_jax_watchdog_threads():
    yield
    for t in threading.enumerate():
        if t.name.startswith("modin-tpu-watchdog"):
            t.join(timeout=5)


@pytest.fixture
def csv_path(tmp_path):
    rng = np.random.default_rng(20)
    n = 4000
    pandas.DataFrame({
        "a": rng.integers(-10, 10, n),
        "b": rng.uniform(0, 1, n),
        "c": rng.uniform(-1, 1, n),
        "d": rng.integers(0, 7, n),
        "e": rng.uniform(0, 100, n),
    }).to_csv(tmp_path / "opt.csv", index=False)
    return str(tmp_path / "opt.csv")


def _scan(csv_path, module=ir, dispatcher=TorchCSVDispatcher, columns=("a", "b", "c", "d", "e")):
    return module.Scan(dispatcher, {"filepath_or_buffer": csv_path}, pandas.Index(columns))


def _reduce_plan(csv_path, method="sum"):
    scan = _scan(csv_path)
    mask = ir.Map((scan,), "gt", args=(0,), bool_out=True)
    return ir.Reduce(ir.Project(ir.Filter(scan, mask), ("b", "c")), method, {})


# ---------------------------------------------------------------------- #
# 1. differential grid
# ---------------------------------------------------------------------- #


def _pipeline(read, path, agg):
    return getattr(read(path).query("a > 0")[["b", "c"]], agg)()


def _assert_differential(csv_path, agg):
    auto = tpd.to_pandas(_pipeline(tpd.read_csv, csv_path, agg))
    with OptMode.context("Off"):
        off = tpd.to_pandas(_pipeline(tpd.read_csv, csv_path, agg))
    want = _pipeline(pandas.read_csv, csv_path, agg)
    want_jax = jax_to_pandas(_pipeline(mpd.read_csv, csv_path, agg))
    pandas.testing.assert_series_equal(auto, off, check_exact=True)
    pandas.testing.assert_series_equal(auto, want, check_exact=False, rtol=1e-12)
    pandas.testing.assert_series_equal(auto, want_jax, check_exact=False, rtol=1e-12)


@pytest.mark.parametrize("kernel", ["Auto", "Device", "Host"])
@pytest.mark.parametrize("agg", ["sum", "median"])
def test_differential_kernel_legs(csv_path, kernel, agg):
    with KernelRouterMode.context(kernel):
        _assert_differential(csv_path, agg)


@pytest.mark.parametrize("fuse", ["Auto", "Fused", "Staged"])
def test_differential_compile_legs(csv_path, fuse):
    with FuseMode.context(fuse):
        _assert_differential(csv_path, "sum")


@pytest.mark.parametrize("budget", [None, 1 << 40, 1 << 16])
def test_differential_residency_legs(csv_path, budget):
    # no budget; a roomy one (resident, donation on); one under the file's
    # columns (windowed, every upload spilling)
    with DeviceMemoryBudget.context(budget):
        _assert_differential(csv_path, "sum")


def test_differential_with_frozen_calibration(csv_path):
    router.set_calibration(dict(FROZEN_TABLE))
    try:
        _assert_differential(csv_path, "median")
    finally:
        router.set_calibration(None)


def test_off_mode_zero_allocations(csv_path):
    with OptMode.context("Off"):
        assert not optimizer.OPT_ON
        before = optimizer.opt_alloc_count()
        got = tpd.to_pandas(_pipeline(tpd.read_csv, csv_path, "sum"))
        assert optimizer.opt_alloc_count() == before
    pandas.testing.assert_series_equal(got, _pipeline(pandas.read_csv, csv_path, "sum"), check_exact=False,
                                       rtol=1e-12)
    assert optimizer.OPT_ON
    before = optimizer.opt_alloc_count()
    tpd.to_pandas(_pipeline(tpd.read_csv, csv_path, "sum"))
    assert optimizer.opt_alloc_count() == before + 1


# ---------------------------------------------------------------------- #
# 2. the plan-time model
# ---------------------------------------------------------------------- #


def _mask_shapes(module, scan):
    def mk(method, *children):
        return module.Map(children or (scan,), method, bool_out=True)

    return [
        mk("eq"), mk("ne"), mk("gt"), mk("lt"), mk("ge"), mk("le"), mk("isna"), mk("notna"), mk("isin"),
        mk("and", mk("gt"), mk("eq")), mk("__and__", mk("gt"), mk("ne")), mk("mul", mk("eq"), mk("eq")),
        mk("or", mk("notna"), mk("ne")), mk("__or__", mk("eq"), mk("lt")), mk("invert", mk("eq")),
        mk("__invert__", mk("and", mk("gt"), mk("isna"))), mk("add", mk("eq"), mk("eq")), mk("abs"), scan,
    ]


def test_selectivity_equals_the_jax_package(csv_path):
    from modin_tpu.core.execution.jax_engine.io import TpuCSVDispatcher

    ours = _mask_shapes(ir, _scan(csv_path))
    theirs = _mask_shapes(jax_ir, _scan(csv_path, jax_ir, TpuCSVDispatcher))
    got = [optimizer.estimate_selectivity(m) for m in ours]
    want = [jax_optimizer.estimate_selectivity(m) for m in theirs]
    assert got == want
    assert got[:3] == [pytest.approx(0.1), pytest.approx(0.9), pytest.approx(0.5)]


def test_estimates_flow_bottom_up(csv_path):
    root = _reduce_plan(csv_path)
    strategies = optimizer.choose(root)
    scan_st = strategies.by_node[id(root.children[0].children[0].children[0])]
    red_st = strategies.by_node[id(root)]
    assert scan_st.est_bytes and scan_st.est_rows
    assert red_st.est_s >= scan_st.est_s > 0.0
    assert red_st.est_rows == 1


def test_estimated_rows_equal_the_jax_package_on_default_priors(csv_path):
    from modin_tpu.core.execution.jax_engine.io import TpuCSVDispatcher

    def plan(module, dispatcher):
        scan = _scan(csv_path, module, dispatcher)
        mask = module.Map((scan,), "eq", args=(3,), bool_out=True)
        return module.GroupbyAgg((module.Project(module.Filter(scan, mask), ("b", "d")),), "d", "sum", {})

    ours, theirs = plan(ir, TorchCSVDispatcher), plan(jax_ir, TpuCSVDispatcher)
    jax_optimizer.set_priors(dict(jax_optimizer.DEFAULT_PRIORS))
    try:
        got = [optimizer.choose(ours).by_node[id(n)] for n in ir.walk(ours)]
        want = [jax_optimizer.choose(theirs).by_node[id(n)] for n in jax_ir.walk(theirs)]
    finally:
        jax_optimizer.set_priors(None)
    assert [(s.est_rows, s.est_bytes) for s in got] == [(s.est_rows, s.est_bytes) for s in want]
    assert [s.legs for s in got] == [s.legs for s in want]


def test_priors_take_only_cuda_runs(tmp_path):
    import json

    path = tmp_path / "history.json"
    path.write_text(json.dumps({"runs": [
        {"substrate": "tpu", "scale": {"rows": 1000}, "ops": {"sum": {"port_s": 0.5}}},
        {"substrate": "cuda", "scale": {"rows": 1000}, "ops": {"median": {"port_s": 2.0}}},
    ]}))
    priors = optimizer.priors_from_history(str(path))
    assert priors["sortred_s_per_row"] == pytest.approx(2e-3)
    assert "reduce_s_per_row" not in priors
    assert optimizer.priors_from_history(str(tmp_path / "missing.json")) is None
    assert optimizer.default_history_path() is None


@pytest.mark.parametrize("budget,want", [(None, "resident"), (1 << 40, "resident"), (1, "windowed")])
def test_choose_residency_leg_reads_the_budget_and_the_ledger(csv_path, budget, want):
    root = _reduce_plan(csv_path)
    with DeviceMemoryBudget.context(budget), FuseMode.context("Fused"):
        st = optimizer.choose(root).by_node[id(root)]
    assert st.legs["residency"] == want and st.leg_ops["residency"] == "scan_reduce"
    # the joint constraints: a windowed tail runs per window (the staged
    # compile leg, firm) and never donates; a resident one takes the fused
    # gate's own leg
    if want == "windowed":
        assert st.legs["compile"] == "staged" and "compile" in st.firm and not st.donate
    else:
        assert st.legs["compile"] == "fused" and "compile" not in st.firm and st.donate


def test_kernel_leg_ignores_the_wall_correction(csv_path):
    root = _reduce_plan(csv_path, "median")
    router.set_calibration(dict(FROZEN_TABLE))
    try:
        strategies = optimizer.choose(root)
        st = strategies.by_node[id(root)]
        assert st.legs["kernel"] == "device" and st.leg_ops["kernel"] == "median"
        est_s = st.est_s
        strategies.correction = optimizer.MAX_CORRECTION
        strategies = optimizer.choose(root, state=strategies)
        assert strategies.by_node[id(root)].legs["kernel"] == "device"
        # the estimate takes the correction
        assert strategies.by_node[id(root)].est_s > est_s > 0.0
    finally:
        router.set_calibration(None)


# ---------------------------------------------------------------------- #
# 3. re-planning
# ---------------------------------------------------------------------- #


def _installed(root):
    strategies = optimizer.choose(root)
    optimizer.begin(strategies, root, {})
    return strategies


@pytest.mark.parametrize("measured,replans", [(0.039, 0), (0.041, 1)])
def test_observe_against_the_replan_factor(csv_path, measured, replans):
    root = _reduce_plan(csv_path)
    strategies = _installed(root)
    try:
        strategies.by_node[id(root)].est_s = 0.010
        with OptReplanFactor.context(4.0):
            optimizer.observe(root, measured)
        assert strategies.by_node[id(root)].measured_s == pytest.approx(measured)
        assert len(strategies.replans) == replans
    finally:
        optimizer.end()


def test_observe_noise_floor(csv_path):
    root = _reduce_plan(csv_path)
    strategies = _installed(root)
    try:
        strategies.by_node[id(root)].est_s = 1e-9
        optimizer.observe(root, optimizer.REPLAN_NOISE_FLOOR_S)
        assert strategies.replans == []
    finally:
        optimizer.end()


def test_observe_divergence_replans_once(csv_path):
    root = _reduce_plan(csv_path)
    strategies = _installed(root)
    try:
        strategies.by_node[id(root)].est_s = 0.010
        with OptReplanFactor.context(4.0):
            optimizer.observe(root, 0.060)
            assert len(strategies.replans) == 1
            event = strategies.replans[0]
            assert event["trigger"] == "wall_divergence"
            assert event["correction"] == pytest.approx(6.0)
            assert strategies.correction == pytest.approx(6.0)
            strategies.by_node[id(root)].est_s = 0.010
            optimizer.observe(root, 0.080)
        assert len(strategies.replans) == 1
    finally:
        optimizer.end()


def test_correction_clamped(csv_path):
    root = _reduce_plan(csv_path)
    strategies = _installed(root)
    try:
        strategies.by_node[id(root)].est_s = 1e-12
        optimizer.observe(root, 10.0)
        assert strategies.correction <= optimizer.MAX_CORRECTION
        assert len(strategies.replans) == 1
    finally:
        optimizer.end()


def test_replan_excludes_lowered_nodes(csv_path):
    root = _reduce_plan(csv_path)
    scan = root.children[0].children[0].children[0]
    strategies = optimizer.choose(root)
    optimizer.begin(strategies, root, {id(scan): object()})
    try:
        strategies.by_node[id(scan)].est_s = 123.0
        assert optimizer._replan(strategies, "wall_divergence", key="t")
        assert strategies.by_node[id(scan)].est_s == 123.0
        assert strategies.replans[0]["remaining_nodes"] == len(strategies.by_node) - 1
    finally:
        optimizer.end()


def test_replan_idempotent_per_key_and_trigger(csv_path):
    strategies = optimizer.choose(_reduce_plan(csv_path))
    assert optimizer._replan(strategies, "wall_divergence", key="k1")
    assert not optimizer._replan(strategies, "wall_divergence", key="k1")
    assert optimizer._replan(strategies, "wall_divergence", key="k2")
    assert len(strategies.replans) == 2


def test_a_slow_scan_never_sends_a_later_median_to_host(csv_path, monkeypatch):
    """A scan far over its estimate (a slow parse) re-plans the rest under
    a large correction, and the median after it still takes the device:
    the live verdict is the router's, on the calibration alone."""
    from modin_tpu_torch.config import KernelRouterMinRows
    from modin_tpu_torch.plan import lowering

    lower_node = lowering._lower_node

    def slow_scan(node, memo):
        result = lower_node(node, memo)
        if isinstance(node, ir.Scan):
            time.sleep(0.05)
        return result

    monkeypatch.setattr(lowering, "_lower_node", slow_scan)
    router.set_calibration(dict(FROZEN_TABLE))
    replans0 = optimizer.REPLANS.get("wall_divergence", 0)
    verdicts0 = dict(router.COUNTS)
    try:
        with KernelRouterMinRows.context(0), OptReplanFactor.context(1.5):
            got = tpd.to_pandas(_pipeline(tpd.read_csv, csv_path, "median"))
    finally:
        router.set_calibration(None)
    assert optimizer.REPLANS.get("wall_divergence", 0) > replans0
    assert router.COUNTS.get("router.median.host", 0) == verdicts0.get("router.median.host", 0)
    assert router.COUNTS.get("router.median.device", 0) > verdicts0.get("router.median.device", 0)
    pandas.testing.assert_series_equal(got, _pipeline(pandas.read_csv, csv_path, "median"), check_exact=False,
                                       rtol=1e-12)


# ---------------------------------------------------------------------- #
# 4. EXPLAIN
# ---------------------------------------------------------------------- #


def test_explain_renders_strategy_and_replans(csv_path):
    root = _reduce_plan(csv_path, "median")
    strategies = optimizer.choose(root)
    rendered = explain.render(root, strategies=strategies)
    assert "[strategy:" in rendered and "est=" in rendered and "residency=" in rendered
    strategies.replans.append({"trigger": "wall_divergence", "est_s": 0.01, "measured_s": 0.08})
    strategies.correction = 8.0
    replans = explain.render_replans(strategies)
    assert "wall_divergence" in replans and "8.0" in replans


def test_explain_of_a_materialized_query_shows_its_strategies(csv_path):
    # staged: the reduction's lowered input is adopted, so the compiler
    # holds the materialized plan and its strategies
    with FuseMode.context("Staged"):
        md = tpd.read_csv(csv_path).query("a > 0")[["b", "c"]]
        tpd.to_pandas(md.sum())
    text = md._query_compiler.explain()
    assert "status: materialized" in text
    assert "[strategy:" in text and "compile=staged!" not in text and "compile=staged" in text
    assert "residency=resident" in text and "re-plans:" in text
    with OptMode.context("Off"), FuseMode.context("Staged"):
        md_off = tpd.read_csv(csv_path).query("a > 0")[["b", "c"]]
        tpd.to_pandas(md_off.sum())
    text_off = md_off._query_compiler.explain()
    assert "status: materialized" in text_off and "[strategy:" not in text_off
