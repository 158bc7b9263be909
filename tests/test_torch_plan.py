"""The whole-query planner of the torch port (``modin_tpu_torch/plan``).

The counterparts of ``tests/test_plan.py``'s cases:

1. IR mechanics: schema answers, DAG sharing through ``transform``,
   structural keys (the CSE criterion);
2. every rewrite rule as a pure ``Plan -> Plan | None`` function, and the
   fixpoint engine's pass budget;
3. end to end: deferred pipelines over one seeded CSV go through
   ``modin_tpu_torch.pandas`` under ``Auto`` and ``Off``, through the JAX
   package (``modin_tpu.pandas``, ``MODIN_TPU_OPT=Off``, its fused leg pinned
   Staged) and through pandas; pushdown into ``usecols`` (seen by the
   reader), materialization points, ``Force``, ``defer_frame`` and EXPLAIN.

Tolerances: frames and integer results exactly; float reductions to rtol
1e-12 (the port's and pandas' sums add in another order), and the port under
``Auto`` against itself under ``Off`` bit for bit where the staged path runs.
"""

import threading

import numpy as np
import pandas
import pytest

import modin_tpu.pandas as mpd
from modin_tpu.config import FuseMode as JaxFuseMode
from modin_tpu.config import OptMode as JaxOptMode
from modin_tpu.utils import to_pandas as jax_to_pandas

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch.config import FuseMode, PlanMaxPasses, PlanMode, PlanScanCacheBytes
from modin_tpu_torch.core.execution.torch_engine.io import TorchCSVDispatcher
from modin_tpu_torch.core.io import file_dispatcher
from modin_tpu_torch.core.io.text import csv_dispatcher
from modin_tpu_torch.plan import ir, rules
from modin_tpu_torch.plan import runtime as plan_runtime


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
    rng = np.random.default_rng(11)
    n = 4000
    pandas.DataFrame(
        {
            "a": rng.integers(-10, 10, n),
            "b": rng.uniform(0, 1, n),
            "c": rng.uniform(-1, 1, n),
            "d": rng.integers(0, 7, n),
            "e": rng.uniform(0, 100, n),
        }
    ).to_csv(tmp_path / "plan.csv", index=False)
    return str(tmp_path / "plan.csv")


def _scan(columns=("a", "b", "c")):
    return ir.Scan(TorchCSVDispatcher, {"filepath_or_buffer": "x.csv"}, pandas.Index(columns))


def _to_pandas(obj):
    return obj._to_pandas() if hasattr(obj, "_to_pandas") else obj


def _equal(got, want, rtol=1e-12):
    """Frames and Series: labels and dtypes exactly, float values to rtol."""
    got = _to_pandas(got)
    if isinstance(want, pandas.DataFrame):
        pandas.testing.assert_frame_equal(got, want, check_exact=False, rtol=rtol)
    elif isinstance(want, pandas.Series):
        pandas.testing.assert_series_equal(got, want, check_exact=False, rtol=rtol)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol)


# ---------------------------------------------------------------------- #
# IR mechanics
# ---------------------------------------------------------------------- #


def test_ir_schema_and_row_keys():
    scan = _scan()
    proj = ir.Project(scan, ("a",), out_hint="column")
    mask = ir.Map((proj,), "gt", (0,), out_columns=proj.columns, bool_out=True)
    filt = ir.Filter(scan, mask)
    assert list(filt.columns) == ["a", "b", "c"]
    assert list(mask.columns) == ["a"]
    assert mask.known_dtypes().iloc[0] == bool
    assert scan.known_dtypes() is None
    assert proj.row_key() == scan.row_key() == mask.row_key()
    assert filt.row_key() != scan.row_key()
    assert ir.Sort(scan, "a", True, {}).row_key() != scan.row_key()


def test_transform_preserves_diamond_sharing():
    scan = _scan()
    left = ir.Project(scan, ("a",))
    right = ir.Project(scan, ("b",))
    mask = ir.Map((right,), "gt", (0,), out_columns=right.columns, bool_out=True)
    root = ir.Filter(left, mask)
    rebuilt, changes = ir.transform(root, lambda n: None)
    assert changes == 0 and rebuilt is root
    new_scan = _scan(("a", "b", "c"))
    rebuilt, changes = ir.transform(root, lambda n: new_scan if isinstance(n, ir.Scan) else None)
    assert changes == 1
    assert rebuilt.children[0].children[0] is rebuilt.children[1].children[0].children[0]


def test_structural_key_identity_vs_structure():
    scan = _scan()
    memo = {}
    p1, p2, p3 = ir.Project(scan, ("a",)), ir.Project(scan, ("a",)), ir.Project(scan, ("b",))
    assert ir.structural_key(p1, memo) == ir.structural_key(p2, memo)
    assert ir.structural_key(p1, memo) != ir.structural_key(p3, memo)
    assert ir.structural_key(ir.Project(_scan(), ("a",)), memo) != ir.structural_key(p1, memo)


# ---------------------------------------------------------------------- #
# Rewrite rules
# ---------------------------------------------------------------------- #


def _mask(scan, col="a", value=0):
    return ir.Map((ir.Project(scan, (col,)),), "gt", (value,), out_columns=pandas.Index([col]), bool_out=True)


def test_rule_push_filter_below_project_and_map():
    scan = _scan()
    mask = _mask(scan)
    new_root = rules.push_filter_down(ir.Filter(ir.Project(scan, ("b", "c")), mask))
    assert isinstance(new_root, ir.Project)
    assert isinstance(new_root.children[0], ir.Filter)
    assert new_root.children[0].children[0] is scan
    new_mroot = rules.push_filter_down(ir.Filter(ir.Map((scan,), "abs", out_columns=scan.columns), mask))
    assert isinstance(new_mroot, ir.Map) and isinstance(new_mroot.children[0], ir.Filter)
    assert rules.push_filter_down(ir.Filter(scan, mask)) is None


def test_rule_cse_merges_identical_subtrees():
    scan = _scan()
    m1, m2 = _mask(scan), _mask(scan)
    new_root = rules.common_subexpression_elimination(
        ir.Map((m1, m2), "__and__", (ir.Ref(1),), out_columns=m1.columns)
    )
    assert new_root is not None and new_root.children[0] is new_root.children[1]
    merged = rules.common_subexpression_elimination(
        ir.Map((m1, _mask(scan, value=1)), "__and__", (ir.Ref(1),), out_columns=m1.columns)
    )
    assert merged is not None and merged.children[0] is not merged.children[1]


def test_rule_prune_columns_unions_all_consumers():
    scan = _scan(("a", "b", "c", "d", "e"))
    root = ir.Reduce(ir.Project(ir.Filter(scan, _mask(scan)), ("b", "c")), "sum", {})
    new_root = rules.prune_dead_columns(root)
    pruned_scan = new_root.children[0].children[0].children[0]
    assert set(pruned_scan.pruned) == {"a", "b", "c"}
    assert new_root.children[0].children[0].children[1].children[0].children[0] is pruned_scan
    assert rules.prune_dead_columns(scan) is None


def test_rule_pushdown_gate_blocks_unsafe_kwargs():
    safe = ir.Scan(TorchCSVDispatcher, {"filepath_or_buffer": "x.csv"}, pandas.Index(["a", "b"]), pruned=("a",))
    assert plan_runtime.scan_supports_pushdown(safe)
    assert rules.pushdown_projection_into_scan(safe).pushed
    for blocker in ({"index_col": "a"}, {"index_col": 0}, {"converters": {"a": int}}, {"parse_dates": ["a"]},
                    {"usecols": lambda c: True}, {"names": ["x", "y"]}, {"skipfooter": 2}, {"dtype": {1: "f4"}}):
        scan = ir.Scan(TorchCSVDispatcher, {"filepath_or_buffer": "x.csv", **blocker},
                       pandas.Index(["a", "b"]), pruned=("a",))
        assert not plan_runtime.scan_supports_pushdown(scan), blocker
        assert rules.pushdown_projection_into_scan(scan) is None


def test_rule_fuse_map_reduce_counts_chain():
    scan = _scan()
    m2 = ir.Map((ir.Map((scan,), "add", (1,), out_columns=scan.columns),), "mul", (2,), out_columns=scan.columns)
    fused = rules.fuse_map_reduce(ir.Reduce(m2, "sum", {}))
    assert fused is not None and fused.fused and fused.fused_maps == 2
    assert rules.fuse_map_reduce(fused) is None
    assert rules.fuse_map_reduce(ir.Reduce(scan, "sum", {})) is None


def test_optimize_respects_pass_budget(monkeypatch):
    calls = []

    def hungry_rule(root):
        calls.append(1)
        return ir.Project(root, tuple(root.columns))

    monkeypatch.setattr(rules, "RULES", (("hungry", hungry_rule),))
    _optimized, applied = rules.optimize(_scan(), max_passes=3)
    assert len(applied) == 3 and len(calls) == 3
    monkeypatch.undo()
    with PlanMaxPasses.context(2):
        _root, applied = rules.optimize(_scan())
        assert applied == []


# ---------------------------------------------------------------------- #
# End to end
# ---------------------------------------------------------------------- #


def _jax(csv_path, pipeline):
    with JaxOptMode.context("Off"), JaxFuseMode.context("Staged"):
        return jax_to_pandas(pipeline(mpd.read_csv(csv_path)))


PIPELINES = {
    "project": lambda df: df[["b", "e"]],
    "filter": lambda df: df.query("a > 2 and e < 50.0"),
    "filter-project-mean": lambda df: df.query("a > 0")[["b"]].mean(),
    "map-sum": lambda df: (df[["b", "c"]] * 2.0).sum(),
    "mask-abs-sum": lambda df: df[df["a"] > 0][["c"]].abs().sum(),
    "filter-sort-project": lambda df: df.query("a > 0").sort_values("e")[["b", "c"]],
    "count": lambda df: df[["a", "b"]].count(),
    "stacked-filters-max": lambda df: df[df["a"] > -5][df["e"] < 60.0][["e", "a"]].max(),
    "groupby-sum": lambda df: df[["d", "b"]].groupby("d").sum(),
    "unary-maps": lambda df: (df[["b", "c"]].abs().round(2) + (-df[["b", "c"]])).sum(),
}


@pytest.mark.parametrize("fuse", ["Staged", "Fused"])
@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_deferred_pipelines_match_off_jax_and_pandas(csv_path, name, fuse):
    pipeline = PIPELINES[name]
    reference = pipeline(pandas.read_csv(csv_path))
    with FuseMode.context(fuse):
        planned = _to_pandas(pipeline(tpd.read_csv(csv_path)))
    with PlanMode.context("Off"):
        eager = _to_pandas(pipeline(tpd.read_csv(csv_path)))
    _equal(planned, reference)
    _equal(eager, reference)
    _equal(planned, _jax(csv_path, pipeline))
    if fuse == "Staged":
        _equal(planned, eager, rtol=0)


def test_acceptance_pipeline_parses_three_columns_in_one_launch(csv_path):
    from modin_tpu_torch.ops.cuda import fused_kernels

    md = tpd.read_csv(csv_path)
    assert md._query_compiler._plan is not None
    parsed, programs = file_dispatcher.PARSED_COLUMNS, fused_kernels.PROGRAMS_RUN
    with FuseMode.context("Fused"):
        planned = md.query("a > 0")[["b", "c"]].agg("sum")
    assert file_dispatcher.PARSED_COLUMNS - parsed == 3
    assert fused_kernels.PROGRAMS_RUN - programs == 1
    reference = pandas.read_csv(csv_path).query("a > 0")[["b", "c"]].agg("sum")
    _equal(planned, reference)
    with PlanMode.context("Off"):
        _equal(tpd.read_csv(csv_path).query("a > 0")[["b", "c"]].agg("sum"), reference)


def test_pushdown_reaches_the_readers_usecols(csv_path, monkeypatch):
    body_usecols = []
    orig = csv_dispatcher.CSVDispatcher.read_fn

    def spying(*args, **kwargs):
        if kwargs.get("nrows") != 0:
            body_usecols.append(kwargs.get("usecols"))
        return orig(*args, **kwargs)

    monkeypatch.setattr(csv_dispatcher.CSVDispatcher, "read_fn", staticmethod(spying))
    out = tpd.read_csv(csv_path).query("a > 0")[["b", "c"]].sum()
    assert body_usecols == [["a", "b", "c"]]
    _equal(out, pandas.read_csv(csv_path).query("a > 0")[["b", "c"]].sum())


def test_unary_maps_defer(csv_path):
    md = tpd.read_csv(csv_path)[["b", "c"]]
    for out in (md.abs(), -md, md.round(2), md.isna(), md.notna(), np.sqrt(md.abs())):
        assert out._query_compiler._plan is not None
    pdf = pandas.read_csv(csv_path)[["b", "c"]]
    _equal(np.sqrt(md.abs()).round(3), np.sqrt(pdf.abs()).round(3))


def test_read_defers_and_metadata_stays_cheap(csv_path):
    md = tpd.read_csv(csv_path)
    qc = md._query_compiler
    assert qc._plan is not None
    assert list(md.columns) == ["a", "b", "c", "d", "e"]
    assert qc._plan is not None
    assert len(md) == 4000
    assert qc._plan is None


def test_materialization_points_force(csv_path):
    pdf = pandas.read_csv(csv_path)
    md = tpd.read_csv(csv_path)
    repr(md)
    assert md._query_compiler._plan is None
    md = tpd.read_csv(csv_path)
    _equal(md.head(7), pdf.head(7))
    md = tpd.read_csv(csv_path)
    assert md._query_compiler._plan is not None
    pandas.testing.assert_series_equal(md.dtypes, pdf.dtypes)
    assert md._query_compiler._plan is None


def test_compound_mask_and_cse_stay_deferred(csv_path):
    md = tpd.read_csv(csv_path)
    mask = md["a"] > 0
    assert mask.dtype == np.dtype(bool) and mask._query_compiler._plan is not None
    out = md[(md["a"] > 0) & (md["e"] < 75.0)][["b", "d"]]
    assert out._query_compiler._plan is not None
    text = out._query_compiler.explain()
    assert "cse" in text  # the two projections of the scan for "a" ... and the repeated scan leaf
    pdf = pandas.read_csv(csv_path)
    _equal(out, pdf[(pdf["a"] > 0) & (pdf["e"] < 75.0)][["b", "d"]])


def test_explain_lifecycle_attributes_the_pushdown(csv_path):
    md = tpd.read_csv(csv_path).query("a > 0")[["b", "c"]]
    before = md._query_compiler.explain()
    assert "status: deferred" in before and "scan[" in before and "filter" in before
    assert "pushdown-project-into-scan: 1 application(s)" in before
    assert "3/5 cols (pruned, usecols pushed into reader)" in before
    md._query_compiler.execute()
    after = md._query_compiler.explain()
    assert "status: materialized" in after and "rewrites:" in after
    analyzed = tpd.read_csv(csv_path).query("a > 0")[["b"]]._query_compiler.explain(analyze=True)
    assert "status: analyzed" in analyzed and "(actual: time=" in analyzed and "no cost model" in analyzed
    with PlanMode.context("Off"):
        assert "status: eager" in tpd.read_csv(csv_path)._query_compiler.explain()


def test_off_mode_never_defers(csv_path):
    with PlanMode.context("Off"):
        md = tpd.read_csv(csv_path)
        assert md._query_compiler._plan is None
        assert (md["a"] > 0)._query_compiler._plan is None


def test_force_mode_replans_after_materialization(csv_path):
    with PlanMode.context("Force"):
        md = tpd.read_csv(csv_path)
        len(md)
        assert md._query_compiler._plan is None
        out = md[["b", "c"]]
        assert out._query_compiler._plan is not None
        assert "source" in out._query_compiler.explain()
        _equal(out, pandas.read_csv(csv_path)[["b", "c"]])


def test_force_mode_defers_filters_and_binaries():
    src = pandas.DataFrame({"a": [1.0, -2.0, 3.0, -4.0], "b": [4.0, 5.0, 6.0, 7.0]})
    with PlanMode.context("Force"):
        md = tpd.DataFrame(src)
        mask = md["a"] > 0
        assert mask._query_compiler._plan is not None
        filtered = md[mask]
        assert filtered._query_compiler._plan is not None
        added = md["a"] + md["b"]
        assert added._query_compiler._plan is not None
        _equal(filtered, src[src["a"] > 0])
        _equal(added, src["a"] + src["b"])


def test_defer_frame_helper(csv_path):
    with PlanMode.context("Off"):
        md = tpd.read_csv(csv_path)
    deferred = plan_runtime.defer_frame(md)
    assert deferred._query_compiler._plan is not None
    _equal(deferred.query("a > 0")[["b"]].sum(), pandas.read_csv(csv_path).query("a > 0")[["b"]].sum())


def test_planned_meets_eager_falls_back_correctly(csv_path):
    md = tpd.read_csv(csv_path)
    with PlanMode.context("Off"):
        eager = tpd.read_csv(csv_path)
    pdf = pandas.read_csv(csv_path)
    _equal(md[["b"]] + eager[["b"]], pdf[["b"]] + pdf[["b"]])


def test_second_reduce_reuses_adopted_frame(csv_path, monkeypatch):
    reads = {"n": 0}
    orig = csv_dispatcher.CSVDispatcher.read_fn

    def counting(*args, **kwargs):
        if kwargs.get("nrows") != 0:
            reads["n"] += 1
        return orig(*args, **kwargs)

    monkeypatch.setattr(csv_dispatcher.CSVDispatcher, "read_fn", staticmethod(counting))
    md = tpd.read_csv(csv_path)[["b", "c"]]
    first, second = md.sum(), md.mean()
    assert reads["n"] == 1
    pdf = pandas.read_csv(csv_path)[["b", "c"]]
    _equal(first, pdf.sum())
    _equal(second, pdf.mean())


def test_user_usecols_and_unsafe_kwargs_stay_exact(csv_path):
    _equal(tpd.read_csv(csv_path, usecols=["a", "b", "c"]).query("a > 0")[["b"]].sum(),
           pandas.read_csv(csv_path, usecols=["a", "b", "c"]).query("a > 0")[["b"]].sum())
    _equal(tpd.read_csv(csv_path, index_col="d")[["b", "c"]].sum(),
           pandas.read_csv(csv_path, index_col="d")[["b", "c"]].sum())
    _equal(tpd.read_csv(csv_path, index_col=0)[["b", "c"]].sum(),
           pandas.read_csv(csv_path, index_col=0)[["b", "c"]].sum())


def test_sniff_failure_and_extension_dtypes_stay_eager(csv_path, tmp_path):
    with pytest.raises(FileNotFoundError):
        tpd.read_csv(str(tmp_path / "missing.csv"))
    md = tpd.read_csv(csv_path, dtype={"a": "Int64"})
    assert md._query_compiler._plan is None


def test_deep_chain_hits_depth_cap_not_recursion(csv_path):
    s = tpd.read_csv(csv_path)["b"]
    ps = pandas.read_csv(csv_path)["b"]
    for _ in range(ir.MAX_PLAN_DEPTH + 20):
        s = s + 1.0
        ps = ps + 1.0
    plan = s._query_compiler._plan
    assert plan is None or plan.depth <= ir.MAX_PLAN_DEPTH
    _equal(s, ps)


def test_numeric_projection_out_of_range_declines(csv_path):
    qc = tpd.read_csv(csv_path)._query_compiler
    assert plan_runtime.defer_project(qc, [99], numeric=True) is None
    assert plan_runtime.defer_project(qc, [1], numeric=True) is not None


def test_scan_read_cache_is_bounded_and_exact(csv_path):
    md = tpd.read_csv(csv_path)
    scan = md._query_compiler._plan
    results = {c: float(md[c].sum()) for c in ("a", "b", "c", "d", "e")}
    assert sum(b for _qc, b in scan.origin.cache.values()) <= int(PlanScanCacheBytes.get())
    with PlanMode.context("Off"):
        eager = tpd.read_csv(csv_path)
        for c, value in results.items():
            assert value == float(eager[c].sum())


def test_lowering_error_names_the_plan_node(tmp_path):
    path = tmp_path / "strings.csv"
    pandas.DataFrame({"s": ["x", "y", "z"], "n": [1, 2, 3]}).to_csv(path, index=False)
    md = tpd.read_csv(str(path))
    assert md._query_compiler._plan is not None
    mask = md["s"] > 3
    with pytest.raises(TypeError, match="materializing deferred plan node"):
        _to_pandas(mask)


def test_read_table_shares_the_eager_kwargs(tmp_path):
    path = tmp_path / "t.tsv"
    pandas.DataFrame({"a": [1, -2, 3], "b": [0.5, 1.5, 2.5]}).to_csv(path, sep="\t", index=False)
    md = tpd.read_table(str(path))
    assert md._query_compiler._plan is not None
    _equal(md.query("a > 0")[["b"]].sum(), pandas.read_table(str(path)).query("a > 0")[["b"]].sum())
