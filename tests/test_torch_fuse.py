"""Whole-plan fusion of the torch port (``modin_tpu_torch/plan/fuse.py``).

The counterparts of ``tests/test_fuse.py``'s differential grid and routing
cases: deferred ``read_csv -> filter/map/project -> reduce | groupby``
pipelines run with ``MODIN_TPU_TORCH_FUSE`` pinned Fused (the masked fused
leg: a masked tail of the fused kernel; the probe, the slot launch and the
``groupagg`` kernel) and Staged, through the JAX package with its own fused
leg pinned Fused (``MODIN_TPU_OPT=Off``) and through pandas, on one seeded
CSV.  The kernels' plain versions run here (CPU tensors).

Tolerances: labels, dtypes and integer values exactly; float values to rtol
1e-12 (sums add in another order on each route).  The JAX package's fused
groupby keeps a narrow int column's dtype and wraps; the port follows pandas,
so those columns are held to pandas alone.
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
from modin_tpu_torch.config import FuseMinRows, FuseMode
from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
from modin_tpu_torch.ops import groupby as gb
from modin_tpu_torch.ops import route
from modin_tpu_torch.ops.cuda import fused_kernels, groupagg_kernels
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


def _write_csv(tmp_path, n, name="fuse.csv", nan_frac=0.0, seed=23):
    rng = np.random.default_rng(seed)
    b = rng.uniform(0, 1, n)
    if nan_frac and n:
        b[rng.random(n) < nan_frac] = np.nan
    pandas.DataFrame(
        {
            "a": rng.integers(-10, 10, n),
            "b": b,
            "c": rng.uniform(-1, 1, n),
            "k": rng.integers(0, 5, n),
            "g": rng.integers(0, 8000, n),
            "t": rng.integers(0, 2, n).astype(bool),
        }
    ).to_csv(tmp_path / name, index=False)
    return str(tmp_path / name)


def _to_pandas(obj):
    return obj._to_pandas() if hasattr(obj, "_to_pandas") else obj


def _equal(got, want, rtol=1e-12):
    if isinstance(want, pandas.DataFrame):
        pandas.testing.assert_frame_equal(got, want, check_exact=False, rtol=rtol)
    else:
        pandas.testing.assert_series_equal(got, want, check_exact=False, rtol=rtol)


def _both_modes(pipeline):
    """(fused, staged) results of a port pipeline, with the fused leg's
    dispatches and the fused kernel's programs of the fused run."""
    d0, p0 = fuse.DISPATCHES, fused_kernels.PROGRAMS_RUN
    with FuseMode.context("Fused"):
        fused = _to_pandas(pipeline(tpd))
    counts = (fuse.DISPATCHES - d0, fused_kernels.PROGRAMS_RUN - p0)
    with FuseMode.context("Staged"):
        staged = _to_pandas(pipeline(tpd))
    return fused, staged, counts


def _jax(pipeline):
    with JaxOptMode.context("Off"), JaxFuseMode.context("Fused"):
        return jax_to_pandas(pipeline(mpd))


# ---------------------------------------------------------------------- #
# filter -> reduce
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("agg", ["sum", "mean", "min", "max", "count", "prod", "var", "std"])
@pytest.mark.parametrize("nan_frac", [0.0, 0.3])
def test_filter_reduce_grid(tmp_path, agg, nan_frac):
    path = _write_csv(tmp_path, 3000, nan_frac=nan_frac)

    def pipeline(pd):
        return pd.read_csv(path).query("a > 0")[["b", "c"]].agg(agg)

    fused, staged, (dispatches, programs) = _both_modes(pipeline)
    reference = pipeline(pandas)
    _equal(fused, reference)
    _equal(staged, reference)
    _equal(fused, _jax(pipeline))
    # the filter, the projection and the reduction: one launch (two passes
    # for a moments op)
    assert dispatches == 1
    assert programs == (2 if agg in ("var", "std") else 1)


@pytest.mark.parametrize("agg", ["sum", "mean", "count", "min", "max"])
def test_mixed_dtype_reduce(tmp_path, agg):
    path = _write_csv(tmp_path, 2500)

    def pipeline(pd):
        return pd.read_csv(path).query("a > 0")[["a", "b", "t"]].agg(agg)

    fused, staged, (dispatches, _) = _both_modes(pipeline)
    reference = pipeline(pandas)
    _equal(fused, reference)
    _equal(staged, reference)
    _equal(fused, _jax(pipeline))
    assert dispatches == 1


def test_map_chain_into_reduce(tmp_path):
    path = _write_csv(tmp_path, 2000)

    def pipeline(pd):
        md = pd.read_csv(path)
        kept = md[md["a"] > 0]
        return ((kept["b"] * 2 + kept["c"]) * kept["b"]).sum()

    with FuseMode.context("Fused"):
        p0 = fused_kernels.PROGRAMS_RUN
        fused = float(pipeline(tpd))
        assert fused_kernels.PROGRAMS_RUN - p0 == 1
    with FuseMode.context("Staged"):
        staged = float(pipeline(tpd))
    reference = float(pipeline(pandas))
    assert fused == pytest.approx(reference, rel=1e-12)
    assert staged == pytest.approx(reference, rel=1e-12)
    assert fused == pytest.approx(float(_jax(pipeline)), rel=1e-12)


def test_stacked_filters(tmp_path):
    path = _write_csv(tmp_path, 2000)

    def pipeline(pd):
        md = pd.read_csv(path)
        return md[md["a"] > 0][md[md["a"] > 0]["b"] > 0.5][["b", "c"]].agg("sum")

    # the second mask is built from a second filter object: another row
    # lineage, so the planner declines to defer it (as the reference does)
    fused, staged, _ = _both_modes(pipeline)
    _equal(fused, pipeline(pandas))
    _equal(staged, pipeline(pandas))

    def chained(pd):
        kept = pd.read_csv(path)
        kept = kept[kept["a"] > 0]
        kept = kept[kept["b"] > 0.5]
        return kept[kept["c"] < 0.25][["b", "c"]].agg("sum")

    fused, staged, (dispatches, programs) = _both_modes(chained)
    _equal(fused, chained(pandas))
    _equal(staged, chained(pandas))
    # three filters AND-ed into one mask, one launch
    assert (dispatches, programs) == (1, 1)


def test_filter_to_zero_rows_and_empty_frame(tmp_path):
    path = _write_csv(tmp_path, 1000)
    empty_path = _write_csv(tmp_path, 0, name="empty.csv")
    declines = fuse.DECLINES

    def zero_rows(pd):
        return pd.read_csv(path).query("a > 99")[["b", "c"]].agg("sum")

    def empty(pd):
        return pd.read_csv(empty_path)[["b", "c"]].agg("sum")

    for pipeline in (zero_rows, empty):
        fused, staged, _ = _both_modes(pipeline)
        _equal(fused, pipeline(pandas))
        _equal(staged, pipeline(pandas))
    assert fuse.DECLINES > declines  # no kept row: the staged path answers


# ---------------------------------------------------------------------- #
# filter -> groupby
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("agg", ["sum", "mean", "count", "min", "max", "prod"])
@pytest.mark.parametrize("key", ["k", "g", "t"])  # low / high cardinality / bool
def test_filter_groupby_grid(tmp_path, agg, key):
    path = _write_csv(tmp_path, 3000, nan_frac=0.2)

    def pipeline(pd):
        return pd.read_csv(path).query("a > 0").groupby(key).agg(agg)

    g0 = groupagg_kernels.LAUNCHES
    fused, staged, (dispatches, programs) = _both_modes(pipeline)
    reference = pipeline(pandas)
    _equal(fused, reference)
    _equal(staged, reference)
    _equal(fused, _jax(pipeline))
    # the probe and the slot launch of the fused kernel, then groupagg (its
    # plain version here: the wrapper counts kernel launches only)
    assert dispatches == 1 and programs == 2
    assert groupagg_kernels.LAUNCHES == g0


def test_groupby_without_filter(tmp_path):
    path = _write_csv(tmp_path, 2000)

    def pipeline(pd):
        return pd.read_csv(path)[["k", "b", "c"]].groupby("k").agg("mean")

    fused, staged, (dispatches, _) = _both_modes(pipeline)
    _equal(fused, pipeline(pandas))
    _equal(staged, pipeline(pandas))
    _equal(fused, _jax(pipeline))
    assert dispatches == 1


@pytest.mark.parametrize("dtype", ["int8", "uint8", "int16", "int32"])
@pytest.mark.parametrize("agg", ["sum", "prod", "mean"])
def test_narrow_int_fused_groupby_follows_pandas(tmp_path, dtype, agg):
    rng = np.random.default_rng(5)
    n = 3000
    info = np.iinfo(dtype)
    path = str(tmp_path / "narrow.csv")
    pandas.DataFrame({
        "k": rng.integers(0, 3, n),
        "a": rng.integers(-5, 5, n),
        "v": rng.integers(max(info.min, -100), min(info.max, 120), n),
    }).to_csv(path, index=False)

    def pipeline(pd):
        return pd.read_csv(path, dtype={"v": dtype}).query("a > -4").groupby("k").agg(agg)

    fused, staged, (dispatches, _) = _both_modes(pipeline)
    _equal(fused, pipeline(pandas))
    _equal(staged, pipeline(pandas))
    assert dispatches == 1


def test_groupby_wide_key_range_declines_to_staged(tmp_path):
    rng = np.random.default_rng(7)
    n = 1500
    pandas.DataFrame({"k": rng.integers(0, 2**40, n), "v": rng.uniform(0, 1, n)}).to_csv(
        tmp_path / "wide.csv", index=False
    )
    path = str(tmp_path / "wide.csv")
    declines, dispatches = fuse.DECLINES, fuse.DISPATCHES
    with FuseMode.context("Fused"):
        got = _to_pandas(tpd.read_csv(path).groupby("k").agg("sum"))
    _equal(got, pandas.read_csv(path).groupby("k").agg("sum"))
    assert fuse.DECLINES == declines + 1 and fuse.DISPATCHES == dispatches


@pytest.mark.parametrize("n", [2047, 2048, 2049, 4096 + 33])
def test_ragged_sizes(tmp_path, n):
    """Sizes around the groupagg chunk and the fused kernel's tiles."""
    path = _write_csv(tmp_path, n, name=f"ragged{n}.csv", nan_frac=0.1)

    def reduce(pd):
        return pd.read_csv(path).query("a > 0")[["b", "c"]].agg("sum")

    def group(pd):
        return pd.read_csv(path).query("a > 0").groupby("k").agg("sum")

    for pipeline in (reduce, group):
        fused, staged, _ = _both_modes(pipeline)
        _equal(fused, pipeline(pandas))
        _equal(staged, pipeline(pandas))


# ---------------------------------------------------------------------- #
# routing
# ---------------------------------------------------------------------- #


def test_decide_compile_modes():
    from modin_tpu_torch.ops import router

    with FuseMode.context("Staged"):
        assert router.decide_compile(None, 10**9) == "staged"
    with FuseMode.context("Fused"):
        assert router.decide_compile(None, 1) == "fused"
    with FuseMode.context("Auto"):
        floor = int(FuseMinRows.get())
        assert router.decide_compile(None, floor - 1) == "staged"
        assert router.decide_compile(None, floor) == "fused"


def test_auto_keeps_tiny_frames_staged(tmp_path):
    path = _write_csv(tmp_path, 500)
    dispatches, defaults = fuse.DISPATCHES, tqc.DEFAULTS_TO_PANDAS
    with FuseMode.context("Auto"):
        got = _to_pandas(tpd.read_csv(path).query("a > 0")[["b", "c"]].agg("sum"))
    _equal(got, pandas.read_csv(path).query("a > 0")[["b", "c"]].agg("sum"))
    assert fuse.DISPATCHES == dispatches
    assert tqc.DEFAULTS_TO_PANDAS == defaults


@pytest.mark.parametrize(
    "slots, n_cols",
    [(9, 1), (1025, 1), (2049, 1), (129, 5), (257, 5), (513, 5), (1025, 2), (1025, 3), (65537, 1)],
)
def test_decide_groupby_follows_the_table_mode(slots, n_cols):
    """Auto takes ``groupagg`` for a float sum (which the staged path
    sorts for) where one block's shared memory holds the whole table; past
    that the slots split into ranges and Auto stays staged.  Fused takes
    it at every width."""
    geo = groupagg_kernels.launch_geometry(10**6, slots, n_cols)
    stage = groupagg_kernels._stage_bytes(n_cols)
    fits = groupagg_kernels.table_bytes(slots, n_cols) + stage <= groupagg_kernels.SMEM_MAX
    assert (geo.ranges == 1) == fits
    shared = geo.ranges == 1
    with FuseMode.context("Auto"):
        assert fuse.decide_groupby(10**6, slots, "sum", n_cols, True) == shared
    with FuseMode.context("Fused"):
        assert fuse.decide_groupby(10**6, slots, "sum", n_cols, True)


@pytest.mark.parametrize("slots", [9, 101, 1001, 1025, 1026, 4001, 10001, 65537])
@pytest.mark.parametrize(
    "agg, any_float, sorts",
    [("sum", False, False), ("min", True, False), ("max", False, False), ("count", True, False),
     ("prod", False, False), ("sum", True, True), ("mean", False, True), ("prod", True, True)],
)
def test_decide_groupby_keeps_atomic_aggregations_staged_past_their_contention(slots, agg, any_float, sorts):
    """Where the staged path folds by atomics (an int sum or product, min,
    max, a count) Auto takes ``groupagg`` only up to ``ATOMIC_MAX_SLOTS``
    slots; where it sorts (a float sum or product, every mean) at every
    width one block's table holds.  Fused takes it at every width."""
    assert route.staged_sorts(agg, any_float) == sorts
    one_range = groupagg_kernels.launch_geometry(10**6, slots, 1).ranges == 1
    want = one_range and (sorts or slots <= route.ATOMIC_MAX_SLOTS)
    with FuseMode.context("Auto"):
        assert route.decide_groupby(10**6, slots, agg, 1, any_float) == want
    with FuseMode.context("Fused"):
        assert route.decide_groupby(10**6, slots, agg, 1, any_float)


@pytest.mark.parametrize("key, dispatched", [("k", True), ("g", False)])
def test_auto_groupby_fuses_only_with_shared_tables(tmp_path, key, dispatched):
    """Auto above the row floor: 5 keys and 3 value columns fit one block's
    shared memory (fused); a key range of about 8000 (8193 slots) splits
    the table into slot ranges, and the groupby declines to the staged
    path.  Both equal pandas to rtol 1e-12."""
    n = int(FuseMinRows.get()) + 100
    path = _write_csv(tmp_path, n)
    cols = ["a", "b", "c", key]
    dispatches, declines = fuse.DISPATCHES, fuse.DECLINES
    with FuseMode.context("Auto"):
        got = _to_pandas(tpd.read_csv(path).query("a > 0")[cols].groupby(key).agg("sum"))
    _equal(got, pandas.read_csv(path).query("a > 0")[cols].groupby(key).agg("sum"))
    assert fuse.DISPATCHES - dispatches == int(dispatched)
    assert fuse.DECLINES - declines == int(not dispatched)


def test_fused_groups_bucket_matches_the_reference():
    from modin_tpu.ops import groupby as jgb

    for width in (1, 7, 8, 9, 100, 10_000, 65_536):
        assert gb.fused_groups_bucket(width) == jgb.fused_groups_bucket(width)
    assert gb.FUSED_MAX_GROUPS == jgb.FUSED_MAX_GROUPS
    assert gb.FUSED_GROUPBY_AGGS == jgb.FUSED_GROUPBY_AGGS
