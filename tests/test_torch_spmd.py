"""The row-shard mesh of the torch port: sharded sort, sorted-representation
build, merge-join and groupby UDFs through the range shuffle.

The counterpart of ``tests/test_spmd.py``.  The port's shards wrap onto the
one CPU device (``parallel/mesh.py``); the JAX package runs on its 8-device
CPU mesh reshaped to the same shard count.  The same seeded numpy inputs go
through both:

1. the parity grid at mesh shapes (1, 1), (2, 1), (4, 1) and (8, 1) with
   the sharded path forced (``SpmdMode`` Sharded in both packages): sort,
   groupby, reductions, the sort-shaped reductions and merges on a ragged
   803-row frame whose last shards are all NaN, each held to pandas, to
   the JAX package and to the port's local path (``SpmdMode`` Local);
2. identity: the sharded sorted representation and the sharded merge
   positions equal the local builds bit for bit, and the JAX package's
   sharded builds at the same mesh;
3. routing and accounting: ``decide_layout``'s arms against the JAX
   router, the skew fallback, the representation dropped by a reshape,
   ``collective_bytes``, the decline on one shard, the optimizer's layout
   leg, the mesh's key and devices;
4. groupby UDFs (``apply``, ``agg`` of a callable) through the shuffle at
   2, 4 and 8 shards with nothing defaulting to pandas (the row floor
   lowered in both packages, as the JAX package's tests lower it).

Keys and values are moved, never computed, so every comparison is exact:
ints and orders bit for bit, floats bit for bit against the port's local
path and numpy, value for value against the JAX package (its cross-shard
gathers turn -0.0 into 0.0).  The one computed float, the grouped sum of
the float column, is held to pandas to 1e-12 of its value (the rows are
added in another order).
"""

import threading

import numpy as np
import pandas
import pytest
import torch

import modin_tpu.pandas as mpd
from modin_tpu.config import MeshShape as JaxMeshShape
from modin_tpu.config import SpmdMode as JaxSpmdMode
from modin_tpu.utils import to_pandas as jax_to_pandas

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch.config import CostCapture, MeshShape, SpmdMinRows, SpmdMode
from modin_tpu_torch.core.execution import resilience as tres
from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
from modin_tpu_torch.ops import join, router, sort, spmd
from modin_tpu_torch.parallel import mesh as tmesh
from modin_tpu_torch.parallel import shuffle

SHAPES = [(1, 1), (2, 1), (4, 1), (8, 1)]
SHARDS = (2, 4, 8)


@pytest.fixture(autouse=True, scope="module")
def _join_jax_watchdog_threads():
    """Let the JAX package's per-fetch watchdog threads end before the next
    test file runs in this worker (``tests/test_watch.py`` counts threads)."""
    yield
    for t in threading.enumerate():
        if t.name.startswith("modin-tpu-watchdog"):
            t.join(timeout=5)


@pytest.fixture(autouse=True)
def _cpu_device():
    modin_tpu_torch.set_device("cpu")


@pytest.fixture
def mesh():
    """Both packages at ``(S, 1)``; the defaults come back after."""
    from modin_tpu.parallel.mesh import num_row_shards, reset_mesh

    def reshape(shards: int) -> int:
        JaxMeshShape.put((shards, 1))
        reset_mesh()
        MeshShape.put((shards, 1))
        assert num_row_shards() == tmesh.num_row_shards() == shards
        return shards

    try:
        yield reshape
    finally:
        MeshShape.put(None)
        JaxMeshShape.put((8, 1))
        reset_mesh()


@pytest.fixture
def forced_sharded():
    with SpmdMode.context("Sharded"), JaxSpmdMode.context("Sharded"):
        yield


def _port(x):
    return tpd.to_pandas(x) if hasattr(x, "_query_compiler") else x


def _same(got, want) -> None:
    """Frames, Series or scalars equal exactly (values, dtypes, index)."""
    got, want = _port(got), want
    if isinstance(want, pandas.DataFrame):
        pandas.testing.assert_frame_equal(got, want, check_exact=True)
    elif isinstance(want, pandas.Series):
        pandas.testing.assert_series_equal(got, want, check_exact=True)
    else:
        assert (np.isnan(got) and np.isnan(want)) if isinstance(want, float) and np.isnan(want) else got == want


def _local(fn):
    """``fn()`` with the layout pinned local (the port's local path)."""
    with SpmdMode.context("Local"):
        return _port(fn())


# ---------------------------------------------------------------------- #
# 1. the parity grid
# ---------------------------------------------------------------------- #


def _grid_data(rng, n=803):
    """A ragged length (803 rows are no multiple of 2, 4 or 8) and a NaN run
    that fills the last shards at every shape: a shard with only NaN keys
    is the degenerate case the shuffle's NaN routing must survive."""
    data = {
        "k": rng.normal(size=n),
        "g": rng.integers(0, 7, n).astype(np.int64),
        # unique, so pandas' default (unstable) sort kind has one answer
        "v": rng.permutation(n * 3)[:n].astype(np.int64),
    }
    data["k"][700:] = np.nan
    return data


def _grid(shape, mesh):
    mesh(shape[0])
    data = _grid_data(np.random.default_rng(11))
    return tpd.DataFrame(data), mpd.DataFrame(data), pandas.DataFrame(data)


@pytest.mark.parametrize("shape", SHAPES)
def test_parity_sort(shape, mesh, forced_sharded):
    tdf, mdf, pdf = _grid(shape, mesh)
    for args in (("k",), ("v",), ("g",)):
        for asc in (True, False):
            want = pdf.sort_values(*args, ascending=asc, kind="stable")
            shuffle.LAST_RUN.clear()
            got = tdf.sort_values(*args, ascending=asc, kind="stable")
            _same(got, want)
            assert bool(shuffle.LAST_RUN) == (shape[0] > 1)
            _same(got, _local(lambda: tdf.sort_values(*args, ascending=asc, kind="stable")))
            _same(got, jax_to_pandas(mdf.sort_values(*args, ascending=asc, kind="stable")))


@pytest.mark.parametrize("shape", SHAPES)
def test_parity_groupby_and_reduce(shape, mesh, forced_sharded):
    # ints exactly; the float sums to 1e-12 of their value (the port, the
    # JAX package and pandas add the rows in different orders)
    tdf, mdf, pdf = _grid(shape, mesh)
    want = pdf.groupby("g").sum()
    for got in (_port(tdf.groupby("g").sum()), jax_to_pandas(mdf.groupby("g").sum())):
        pandas.testing.assert_series_equal(got["v"], want["v"], check_exact=True)
        pandas.testing.assert_series_equal(got["k"], want["k"], check_exact=False, rtol=1e-12)
    assert int(tdf["v"].sum()) == int(pdf["v"].sum()) == int(mdf["v"].sum())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("op", ["median", "nunique", "quantile", "mode"])
def test_parity_sort_shaped_reductions(shape, op, mesh, forced_sharded):
    tdf, mdf, pdf = _grid(shape, mesh)
    call = {
        "median": lambda s: s.median(),
        "nunique": lambda s: s.nunique(),
        "quantile": lambda s: s.quantile([0.1, 0.5, 0.9]),
        "mode": lambda s: s.mode(),
    }[op]
    for col in ("k", "v"):
        want = call(pdf[col])
        shuffle.LAST_RUN.clear()
        got = _port(call(tdf[col]))
        _same(got, want)
        # the rep is the shuffle's (nunique and mode count an int column of
        # a narrow range with the histogram instead)
        hist = op in ("nunique", "mode") and col == "v"
        assert bool(shuffle.LAST_RUN) == (shape[0] > 1 and not hist)
        fresh = tpd.DataFrame({col: pdf[col].to_numpy()})[col]
        _same(got, _local(lambda: call(fresh)))
        _same(_port(jax_to_pandas(call(mdf[col]))), want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("how", ["inner", "left", "outer"])
def test_parity_merge(shape, how, mesh, forced_sharded):
    mesh(shape[0])
    rng = np.random.default_rng(12)
    lk = rng.integers(0, 40, 257).astype(np.int64)
    rk = rng.integers(0, 40, 181).astype(np.int64)
    left, right = {"k": lk, "a": np.arange(257)}, {"k": rk, "b": np.arange(181)}
    want = pandas.DataFrame(left).merge(pandas.DataFrame(right), on="k", how=how)
    shuffle.LAST_RUN.clear()
    got = tpd.DataFrame(left).merge(tpd.DataFrame(right), on="k", how=how)
    _same(got, want)
    assert bool(shuffle.LAST_RUN) == (shape[0] > 1)
    _same(got, _local(lambda: tpd.DataFrame(left).merge(tpd.DataFrame(right), on="k", how=how)))
    _same(jax_to_pandas(mpd.DataFrame(left).merge(mpd.DataFrame(right), on="k", how=how)), want)


# ---------------------------------------------------------------------- #
# 2. identity with the local builds and the JAX package's sharded ones
# ---------------------------------------------------------------------- #


def _rep_values(kind: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(3)
    if kind == "float":
        values = rng.normal(size=n).round(2)  # ties, -0.0 beside 0.0
        values[17:900] = np.nan
        values[5], values[6] = np.inf, -np.inf
        return values
    if kind == "bool":
        return rng.random(n) < 0.3
    return rng.integers(0, 1 << 30, n).astype(np.int64)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("kind", ["float", "int", "bool"])
def test_sharded_sorted_valid_matches_local_build(shards, kind, mesh):
    from modin_tpu.ops.spmd import sharded_sorted_valid as jax_sharded_sorted_valid
    from modin_tpu.ops.structural import pad_host
    from modin_tpu.parallel.engine import JaxWrapper

    mesh(shards)
    n = 4001
    values = _rep_values(kind, n)
    col = torch.as_tensor(values)
    pair = spmd.sharded_sorted_valid(col, n)
    assert pair is not None
    local_xs, local_nv = sort.sorted_valid(col, n)
    assert pair[0].dtype == local_xs.dtype
    np.testing.assert_array_equal(pair[0].numpy().view(np.uint8), local_xs.numpy().view(np.uint8))
    assert int(pair[1]) == int(local_nv)
    if kind != "bool":
        jax_pair = jax_sharded_sorted_valid(JaxWrapper.put(pad_host(values)), n)
        np.testing.assert_array_equal(pair[0].numpy(), np.asarray(jax_pair[0])[:n])
        assert int(pair[1]) == int(np.asarray(jax_pair[1]))


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("how", ["inner", "left"])
def test_sharded_merge_positions_match_local(shards, how, mesh):
    from modin_tpu.ops.spmd import sharded_merge_positions as jax_sharded_merge_positions
    from modin_tpu.ops.structural import pad_host
    from modin_tpu.parallel.engine import JaxWrapper

    mesh(shards)
    rng = np.random.default_rng(4)
    n_l, n_r = 1501, 907
    lk = rng.uniform(-5, 5, n_l).round(1)  # float keys with heavy ties
    rk = rng.uniform(-5, 5, n_r).round(1)
    lk[3:40] = np.nan  # NaN keys match each other in pandas' merge
    rk[10:25] = np.nan
    got = spmd.sharded_merge_positions(torch.as_tensor(lk), torch.as_tensor(rk), n_l, n_r, how)
    assert got is not None
    want = join.sort_merge_positions(torch.as_tensor(lk), torch.as_tensor(rk), n_l, n_r, how)
    assert got[2:] == want[2:]
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    jax = jax_sharded_merge_positions(JaxWrapper.put(pad_host(lk)), JaxWrapper.put(pad_host(rk)), n_l, n_r, how)
    assert (got[2], got[3]) == (jax[2], jax[3])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jax[0])[: got[2]])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jax[1])[: got[2]])


# ---------------------------------------------------------------------- #
# 3. routing and accounting
# ---------------------------------------------------------------------- #


def test_decide_layout_forced_and_floor(mesh):
    from modin_tpu.ops import router as jax_router

    mesh(8)
    for mode, n in (("Sharded", 10), ("Local", 10**9), ("Auto", 10)):
        with SpmdMode.context(mode), JaxSpmdMode.context(mode):
            got = router.layout_verdict("sort", n)
            assert got["choice"] == jax_router.decide_layout("sort", n)
            assert got["reason"] == {"Sharded": "forced", "Local": "forced", "Auto": "below_min_rows"}[mode]


def test_decide_layout_single_shard_answers_first(mesh):
    mesh(1)
    with SpmdMode.context("Sharded"):
        assert router.layout_verdict("merge", 10**9) == {"choice": "local", "reason": "single_shard"}
    MeshShape.put(None)  # the default: one shard a device, one device here
    assert tmesh.num_row_shards() == 1
    assert router.decide_layout("sort", 10**9, payload_cols=4) == "local"


def _layout_table(**over):
    table = {
        "version": router._CAL_VERSION,
        "platform": "cpu",
        "rows": 1 << 18,
        "device_sort_s": 1.0,
        "device_consume_s": 0.01,
        "device_hist_s": 0.01,
        "device_shuffle_s": 0.25,
        "collective_bytes_per_s": 1e9,
    }
    table.update(over)
    return table


@pytest.mark.parametrize("case", ["cheaper_shuffle", "payload_at_slow_links", "no_sharded_entries"])
def test_decide_layout_crossover_from_forced_table(case, mesh):
    from modin_tpu.ops import router as jax_router

    mesh(8)
    table, payload = {
        "cheaper_shuffle": (_layout_table(), 0),
        "payload_at_slow_links": (_layout_table(collective_bytes_per_s=1.0), 8),
        "no_sharded_entries": (
            {k: v for k, v in _layout_table().items() if "shuffle" not in k and "collective" not in k}, 0),
    }[case]
    n = 1 << 20  # above the SpmdMinRows floor
    want = {"cheaper_shuffle": "sharded", "payload_at_slow_links": "local", "no_sharded_entries": "local"}[case]
    try:
        with SpmdMode.context("Auto"), JaxSpmdMode.context("Auto"):
            router.set_calibration(dict(table))
            jax_router.set_calibration(dict(table, version=jax_router._CAL_VERSION))
            got = router.layout_verdict("sort", n, payload_cols=payload)
            assert got["choice"] == want == jax_router.decide_layout("sort", n, payload_cols=payload)
            assert got["reason"] == ("uncalibrated" if case == "no_sharded_entries" else "cost_model")
            assert router.planned_layout("sort", n) == (want if payload == 0 else "sharded")
    finally:
        router.set_calibration(None)
        jax_router.set_calibration(None)


def test_decide_layout_counts_its_own_verdict(mesh, monkeypatch):
    # counted once; the optimizer's consult is offered residency verdicts
    # only, never the layout's
    mesh(4)
    offered = []
    monkeypatch.setattr(router, "_opt_consult", lambda leg, choice, reason, **ctx: offered.append((leg, reason)))
    before = router.COUNTS.get("router.spmd_merge.local", 0)
    try:
        router.set_calibration(_layout_table(device_shuffle_s=4.0))
        with SpmdMinRows.context(0):
            assert router.decide_layout("merge", 1 << 20) == "local"
    finally:
        router.set_calibration(None)
    assert router.COUNTS["router.spmd_merge.local"] == before + 1
    assert offered == []


@pytest.mark.parametrize("case", ["cheaper_shuffle", "forced", "uncalibrated"])
def test_decide_layout_of_a_groupby_udf(case, mesh):
    # pandas runs the UDF on the same rows either way: under Auto the
    # shuffle is all the sharded side adds, so a shuffle cheaper than the
    # local sort (a sort goes sharded on it) leaves the UDF local; Sharded
    # forces it
    mesh(4)
    table = _layout_table() if case != "uncalibrated" else {
        k: v for k, v in _layout_table().items() if "shuffle" not in k and "collective" not in k}
    try:
        router.set_calibration(table)
        with SpmdMode.context("Sharded" if case == "forced" else "Auto"):
            got = router.layout_verdict("apply", 1 << 20, payload_cols=1)
            sort_choice = router.layout_verdict("sort", 1 << 20)["choice"]
    finally:
        router.set_calibration(None)
    want = {"cheaper_shuffle": ("local", "cost_model"), "forced": ("sharded", "forced"),
            "uncalibrated": ("local", "uncalibrated")}[case]
    assert (got["choice"], got["reason"]) == want
    if case == "cheaper_shuffle":
        assert got["local_s"] == 0.0 < got["sharded_s"]
        assert sort_choice == "sharded"


def test_range_partitioning_reads_as_sharded_for_the_sort(mesh):
    from modin_tpu_torch.config import RangePartitioning

    mesh(4)
    with RangePartitioning.context(True):
        assert router.layout_verdict("sort", 10) == {"choice": "sharded", "reason": "forced"}
        assert router.layout_verdict("merge", 10)["choice"] == "local"
        with SpmdMode.context("Local"):
            assert router.layout_verdict("sort", 10)["choice"] == "local"


@pytest.fixture
def fast_calibration(tmp_path, monkeypatch):
    """The real one-shot measurement at a tiny size, its table under a
    CacheDir in tmp_path."""
    from modin_tpu_torch.config import CacheDir, KernelRouterCalibrationRows

    monkeypatch.setattr(router, "DEVICE_FIT_FACTOR", 2)
    router.set_calibration(None)
    with CacheDir.context(str(tmp_path / "cache")), KernelRouterCalibrationRows.context(1 << 10):
        yield tmp_path / "cache"
    router.set_calibration(None)


def test_calibration_measures_the_sharded_entries(mesh, fast_calibration):
    mesh(2)
    table = router.get_calibration()
    assert router.CALIBRATION_ERROR is None
    assert table["mesh_shards"] == 2 and table["device_shuffle_at_rows_s"] > 0
    assert table["collective_bytes_per_s"] > 0
    assert "mesh-cpu:2x1" in table["device"]


@pytest.mark.parametrize("timed,want", [
    # host-bound: no slower at the fit rows, all fixed, growing as the sort
    ((5e-3, 4e-3), (4e-3, 1e-3)),
    # growing faster than the local sort: the fit as it is
    ((1e-3, 1e-3 + 99 * 2e-3), (0.0, 2e-3)),
    # growing slower than the local sort: floored at the sort's
    ((5e-3, 5e-3 + 99 * 1e-4), (5e-3 - 1e-4, 1e-3)),
])
def test_the_shuffle_fit_in_the_calibration(timed, want, mesh, monkeypatch):
    mesh(4)
    times = iter([*timed, 1.0])
    monkeypatch.setattr(router, "_time_best", lambda fn, sync, reps=2: next(times))
    monkeypatch.setattr(router.calstore, "nlogn_scale", lambda n, cal: 100.0)
    table = {"device_sort_s": 1e-3}
    router._measure_sharded(table, 64, 128, torch.device("cpu"), lambda: None)
    assert table["device_shuffle_fixed_s"] == pytest.approx(want[0], abs=1e-12)
    assert table["device_shuffle_s"] == pytest.approx(want[1], abs=1e-12)
    assert table["mesh_shards"] == 4 and table["collective_bytes_per_s"] > 0


def test_a_failed_exchange_in_the_calibration_stores_nothing(mesh, fast_calibration, monkeypatch):
    # a failed sharded probe fails the calibration: the error is recorded,
    # no table is stored, and the layout verdict is "uncalibrated"
    mesh(2)

    def broken(*args, **kwargs):
        raise RuntimeError("peer copy failed")

    monkeypatch.setattr(shuffle, "exchange", broken)
    with SpmdMinRows.context(0):
        got = router.layout_verdict("sort", 1 << 20)
    assert (got["choice"], got["reason"]) == ("local", "uncalibrated")
    assert router.CALIBRATION_ERROR == "RuntimeError: peer copy failed"
    assert not any(p.is_file() for p in fast_calibration.rglob("*"))


def test_a_device_failure_in_the_calibration_raises_on_the_card(mesh, fast_calibration, monkeypatch):
    # on the card a device failure of the probe (here an OOM of the
    # exchange) raises instead of leaving the router quietly uncalibrated
    mesh(2)

    def oom(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(shuffle, "exchange", oom)
    monkeypatch.setattr(router, "_platform", lambda: "cuda")
    monkeypatch.setattr(router, "_device_key", lambda: f"a card|mesh-{tmesh.mesh_shape_key()}")
    with pytest.raises(torch.cuda.OutOfMemoryError):
        router.get_calibration()
    assert router.CALIBRATION_ERROR.startswith("OutOfMemoryError")
    assert router.calibration_peek() is None
    assert not any(p.is_file() for p in fast_calibration.rglob("*"))


def test_optimizer_layout_leg_keeps_the_live_verdict(mesh):
    from modin_tpu_torch.plan import optimizer

    mesh(4)
    state = optimizer.PlanStrategies()
    optimizer.begin(state, None, {})
    try:
        assert optimizer._consult("layout", "sharded", "cost_model", op="sort", n=1 << 20) is None
    finally:
        optimizer.end()
    with SpmdMode.context("Sharded"):
        assert router.planned_layout("sort", 10) == "sharded"
    assert router.planned_layout("sort", None) == "local"


@pytest.mark.parametrize("shards", SHARDS)
def test_merge_skew_falls_back_to_local(shards, mesh, forced_sharded, monkeypatch):
    # the shuffle gives up on pathological skew: the local sort-merge
    # answers exactly, and the decline is no device failure
    mesh(shards)
    monkeypatch.setattr(shuffle, "range_shuffle", lambda *a, **k: (_ for _ in ()).throw(
        shuffle.ShuffleSkewError("range_shuffle: pathological key skew")))
    rng = np.random.default_rng(13)
    n = 1024
    left = {"k": rng.integers(0, 3, n).astype(np.int64), "a": np.arange(n)}
    right = {"k": np.full(n, 1, np.int64), "b": np.arange(n)}
    fallbacks = tres.fallback_count()
    _same(tpd.DataFrame(left).merge(tpd.DataFrame(right), on="k"),
          pandas.DataFrame(left).merge(pandas.DataFrame(right), on="k"))
    assert tres.fallback_count() == fallbacks


@pytest.mark.parametrize("shards", SHARDS)
def test_merge_real_skew_exhaustion_counts_and_falls_back(shards, mesh, forced_sharded, monkeypatch):
    import functools

    mesh(shards)
    monkeypatch.setattr(shuffle, "range_shuffle", functools.partial(shuffle.range_shuffle, max_slack=2.0))
    n = 1024
    left = {"k": np.arange(n) % 3, "a": np.arange(n)}
    right = {"k": np.full(n, 1, np.int64), "b": np.arange(n)}
    before = tres.COUNTS.get("resilience.shuffle.skew_fallback", 0)
    _same(tpd.DataFrame(left).merge(tpd.DataFrame(right), on="k", how="left"),
          pandas.DataFrame(left).merge(pandas.DataFrame(right), on="k", how="left"))
    assert tres.COUNTS.get("resilience.shuffle.skew_fallback", 0) == before + 1


@pytest.mark.parametrize("kind", ["transient", "device_lost"])
def test_a_failed_exchange_on_the_card_retries_or_raises(kind, mesh, forced_sharded, monkeypatch):
    # the card's legs (``_on_card`` patched true): a transient failure of the
    # exchange runs the sort again; a loss raises through the sort_shuffle
    # family's device_path; neither falls back to the CPU or to pandas
    from modin_tpu_torch.config import ResilienceBackoffS
    from modin_tpu_torch.testing import make_device_error

    mesh(4)
    monkeypatch.setattr(tres, "_on_card", lambda qc, args, kwargs: True)
    real, calls = shuffle.exchange, []

    def failing(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise make_device_error(kind)
        return real(*args, **kwargs)

    monkeypatch.setattr(shuffle, "exchange", failing)
    data = {"a": np.random.default_rng(23).permutation(2000), "b": np.arange(2000.0)}
    tdf = tpd.DataFrame(data)
    fallbacks, defaults = tres.fallback_count(), tqc.DEFAULTS_TO_PANDAS
    try:
        with ResilienceBackoffS.context(0.0):
            if kind == "transient":
                _same(tdf.sort_values("a"), pandas.DataFrame(data).sort_values("a"))
                assert len(calls) == 2
            else:
                with pytest.raises(tres.DeviceLost):
                    tdf.sort_values("a")
                assert tres.COUNTS.get("resilience.raised.sort_shuffle.device_lost", 0) >= 1
    finally:
        tres.reset_breakers()
    assert tres.fallback_count() == fallbacks and tqc.DEFAULTS_TO_PANDAS == defaults


def test_sorted_rep_invalidates_on_mesh_reshape(mesh, forced_sharded):
    from modin_tpu_torch.ops import sorted_cache

    mesh(8)
    vals = np.random.default_rng(21).normal(size=2048)
    df = tpd.DataFrame({"w": vals})
    assert float(df["w"].median()) == float(np.median(vals))
    col = df._query_compiler._modin_frame.get_column(0)
    assert sorted_cache.peek(col)
    assert tmesh.mesh_shape_key() == "cpu:8x1"
    mesh(4)
    # built under 8x1: a 4x1 mesh must not serve it
    assert not sorted_cache.peek(col)
    assert float(df["w"].median()) == float(np.median(vals))
    assert sorted_cache.peek(col)


def test_collective_bytes_accounted(mesh, forced_sharded):
    from modin_tpu_torch.observability import costs, meters

    mesh(4)
    n = 2048
    values = np.random.default_rng(31).integers(0, 1 << 30, n)
    with CostCapture.context("On"):
        before = costs.thread_collective()
        with meters.query_stats("sharded") as qs:
            pair = spmd.sharded_sorted_valid(torch.as_tensor(values), n)
        moved = costs.thread_collective() - before
    assert pair is not None
    # every row of the one int64 column crosses once
    assert moved == n * 8 == qs.collective_bytes == shuffle.LAST_RUN["exchange_bytes"]
    assert costs.get_cost_ledger().snapshot()["collective"]["shuffle.all_to_all"]["bytes"] >= moved
    assert "collective: " in qs.summary()


def test_explain_analyze_bills_the_exchange(mesh, forced_sharded, tmp_path):
    mesh(4)
    path = tmp_path / "s.csv"
    pandas.DataFrame({"a": np.arange(300)[::-1], "b": np.arange(300.0)}).to_csv(path, index=False)
    with CostCapture.context("On"):
        text = tpd.read_csv(path).sort_values("a")._query_compiler.explain(analyze=True)
    # the sort's int64 key, its float64 payload and the row ids cross once:
    # 300 x 24 bytes; the plan's layout leg reads the forced verdict
    assert "collective=7.0KiB" in text and "layout=sharded" in text, text
    with SpmdMode.context("Local"), CostCapture.context("On"):
        text = tpd.read_csv(path).sort_values("a")._query_compiler.explain(analyze=True)
    assert "collective=" not in text and "layout=local" in text


def test_collective_bytes_zero_on_local(mesh):
    from modin_tpu_torch.observability import meters

    mesh(4)
    with SpmdMode.context("Local"), meters.query_stats("local") as qs:
        tpd.DataFrame({"a": np.arange(100.0)}).sort_values("a")
    assert qs.collective_bytes == 0


def test_spmd_declines_on_single_shard_mesh(mesh, forced_sharded):
    mesh(1)
    col = torch.arange(64, dtype=torch.int64)
    assert spmd.sharded_sorted_valid(col, 64) is None
    assert spmd.sharded_merge_positions(col, col, 64, 64, "inner") is None


def test_mesh_key_devices_and_wrap(mesh):
    assert tmesh.num_row_shards() == 1 and tmesh.mesh_shape_key() == "cpu:1x1"
    mesh(4)
    assert tmesh.shard_devices() == (torch.device("cpu"),) * 4
    assert tmesh.row_blocks(803, 4) == [(0, 201), (201, 402), (402, 603), (603, 803)]
    assert tmesh.row_blocks(5, 4) == [(0, 2), (2, 4), (4, 5), (5, 5)]
    built = tmesh.get_mesh()
    assert built.key == tmesh.mesh_shape_key() == "cpu:4x1"
    tmesh.reset_mesh()
    assert tmesh.get_mesh() is not built and tmesh.get_mesh().key == "cpu:4x1"
    MeshShape.put("8,1")
    assert tmesh.num_row_shards() == 8 and tmesh.mesh_shape_key() == "cpu:8x1"
    with pytest.raises(ValueError):
        MeshShape.put("0,1")


# ---------------------------------------------------------------------- #
# 4. groupby UDFs through the shuffle
# ---------------------------------------------------------------------- #


def _spread(g):
    return g["a"].max() - g["b"].mean()


def _top2(g):
    return g.nlargest(2, "a")


UDF_CASES = {
    "scalar": (lambda gb: gb.apply(_spread), {}),
    "frame": (lambda gb: gb.apply(_top2), {}),
    "unsorted": (lambda gb: gb.apply(_spread), {"sort": False}),
    "as_index_false": (lambda gb: gb.apply(_spread), {"as_index": False}),
    "agg_callable": (lambda gb: gb.agg(lambda s: s.max() - s.min()), {}),
}


@pytest.fixture
def apply_floor(monkeypatch):
    """The shuffle's row floor lowered in both packages."""
    from modin_tpu.core.storage_formats.tpu import query_compiler as jax_qc

    monkeypatch.setattr(tqc, "_SHUFFLE_APPLY_MIN_ROWS", 100)
    monkeypatch.setattr(jax_qc, "_SHUFFLE_APPLY_MIN_ROWS", 100)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("case", sorted(UDF_CASES))
def test_groupby_udf_through_the_shuffle(shards, case, mesh, apply_floor, forced_sharded):
    mesh(shards)
    rng = np.random.default_rng(17)
    n = 3000
    data = {"k": rng.integers(0, 40, n), "a": rng.permutation(n).astype(np.float64), "b": rng.integers(0, 9, n)}
    call, kwargs = UDF_CASES[case]
    want = call(pandas.DataFrame(data).groupby("k", **kwargs))
    defaults = tqc.DEFAULTS_TO_PANDAS
    shuffle.LAST_RUN.clear()
    got = call(tpd.DataFrame(data).groupby("k", **kwargs))
    assert tqc.DEFAULTS_TO_PANDAS == defaults
    assert shuffle.LAST_RUN["shards"] == shards
    _same(got, want)
    _same(_port(jax_to_pandas(call(mpd.DataFrame(data).groupby("k", **kwargs)))), want)


def test_groupby_udf_string_key_and_nan_keys(mesh, apply_floor, forced_sharded):
    mesh(4)
    rng = np.random.default_rng(18)
    n = 2000
    keys = rng.choice(np.array(["x", "y", "z", "w"], dtype=object), n)
    fk = rng.integers(0, 20, n).astype(np.float64)
    fk[::7] = np.nan
    data = {"s": keys, "f": fk, "a": rng.permutation(n).astype(np.float64)}
    defaults = tqc.DEFAULTS_TO_PANDAS
    for by in ("s", "f", ["s", "f"]):
        want = pandas.DataFrame(data).groupby(by).apply(lambda g: g["a"].sum())
        _same(tpd.DataFrame(data).groupby(by).apply(lambda g: g["a"].sum()), want)
    assert tqc.DEFAULTS_TO_PANDAS == defaults


def test_groupby_udf_declines_where_row_shaped_or_one_shard(mesh, apply_floor, forced_sharded):
    rng = np.random.default_rng(19)
    n = 1000
    data = {"k": rng.integers(0, 10, n), "a": rng.normal(size=n)}
    pdf = pandas.DataFrame(data)
    mesh(4)
    defaults = tqc.DEFAULTS_TO_PANDAS
    # transform keeps the frame's row order: pandas answers
    _same(tpd.DataFrame(data).groupby("k").transform(lambda s: s - s.mean()),
          pdf.groupby("k").transform(lambda s: s - s.mean()))
    assert tqc.DEFAULTS_TO_PANDAS == defaults + 1
    mesh(1)
    _same(tpd.DataFrame(data).groupby("k").apply(_spread_a), pdf.groupby("k").apply(_spread_a))
    assert tqc.DEFAULTS_TO_PANDAS == defaults + 2


def test_groupby_udf_stays_local_under_auto(mesh, apply_floor):
    # Auto's verdict for a UDF is local (below the row floor here, the cost
    # model above it): pandas answers, counted as a default, no shuffle
    mesh(4)
    rng = np.random.default_rng(20)
    data = {"k": rng.integers(0, 10, 1000), "a": rng.normal(size=1000)}
    defaults = tqc.DEFAULTS_TO_PANDAS
    before = router.COUNTS.get("router.spmd_apply.local", 0)
    shuffle.LAST_RUN.clear()
    _same(tpd.DataFrame(data).groupby("k").apply(_spread_a), pandas.DataFrame(data).groupby("k").apply(_spread_a))
    assert tqc.DEFAULTS_TO_PANDAS == defaults + 1
    assert router.COUNTS["router.spmd_apply.local"] == before + 1
    assert not shuffle.LAST_RUN


def _spread_a(g):
    return g["a"].max() - g["a"].min()
