"""Lazy fusion in the torch port, through ``modin_tpu_torch.pandas``.

The counterpart of the JAX package's ``tests/test_fusion.py``: chained column
expressions stay deferred (``ops/lazy.py``) until a consumer needs concrete
data, and then run as ONE fused program per consumer (a materialization, a
filter or a reduction tail).  The same queries go through
``modin_tpu_torch.pandas``, ``modin_tpu.pandas`` and pandas on the same
numpy data: elementwise results equal pandas' bit for bit, reductions to
rtol 1e-12 (their sums run in another order), and no query defaults to
pandas.  Program counts come from ``fused_kernels.PROGRAMS_RUN``, which
counts the programs run on either route (the plain version here).
"""

import threading

import numpy as np
import pandas
import pytest

import modin_tpu.pandas as mpd
from modin_tpu.utils import to_pandas as jax_to_pandas

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch.config import FusedCacheSize
from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
from modin_tpu_torch.ops import lazy
from modin_tpu_torch.ops.cuda import fused_kernels as fk

N = 2003


@pytest.fixture(autouse=True)
def _cpu_device():
    modin_tpu_torch.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _join_jax_watchdog_threads():
    """Let the JAX package's per-fetch watchdog threads end before the next
    test file runs in this worker (``tests/test_watch.py`` counts threads)."""
    yield
    for t in threading.enumerate():
        if t.name.startswith("modin-tpu-watchdog"):
            t.join(timeout=5)


def _data(seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=N), "b": rng.normal(size=N), "c": rng.uniform(1, 2, size=N)}


@pytest.fixture
def frames():
    data = _data()
    return tpd.DataFrame(data), mpd.DataFrame(data), pandas.DataFrame(data)


def _col(obj, i: int = 0):
    return obj._query_compiler._modin_frame._columns[i]


def _as_pandas(obj):
    return tpd.to_pandas(obj) if hasattr(obj, "_query_compiler") else obj


def _check(got, want, exact: bool = True, jax=None) -> None:
    """The port's result equal to pandas' (bit for bit, or to rtol 1e-12
    where sums reorder), dtypes and labels included; to the JAX package's
    within rtol 1e-12, where given (XLA contracts ``a * b + c`` into an fma
    on the CPU, so its chains are not pandas' bit for bit)."""
    got = _as_pandas(got)
    others = [(want, exact)] + ([(jax_to_pandas(jax), False)] if jax is not None else [])
    for other, ex in others:
        if isinstance(other, pandas.Series):
            pandas.testing.assert_series_equal(got, other, check_exact=ex, rtol=1e-12, check_names=False)
        elif isinstance(other, pandas.DataFrame):
            pandas.testing.assert_frame_equal(got, other, check_exact=ex, rtol=1e-12)
        else:
            np.testing.assert_allclose(got, other, rtol=0 if ex else 1e-12)


class _Counts:
    """Programs run and defaults to pandas over a block."""

    def __enter__(self):
        self.programs, self.defaults = fk.PROGRAMS_RUN, tqc.DEFAULTS_TO_PANDAS
        return self

    def __exit__(self, *exc):
        self.programs = fk.PROGRAMS_RUN - self.programs
        self.defaults = tqc.DEFAULTS_TO_PANDAS - self.defaults


def test_chain_stays_lazy_until_consumed(frames):
    t, _, p = frames
    s = t["a"] * t["b"] + t["c"]
    assert _col(s).is_lazy
    s2 = (s * 2.0).abs()
    assert _col(s2).is_lazy
    with _Counts() as n:
        got = s2.to_numpy()
    assert not _col(s2).is_lazy and n.programs == 1
    np.testing.assert_array_equal(got, ((p["a"] * p["b"] + p["c"]) * 2.0).abs().to_numpy())


def test_map_reduce_fuses_to_one_program(frames):
    t, m, p = frames
    before = dict(lazy._FUSED_CACHE)
    with _Counts() as n:
        out = (t["a"] * t["b"] + t["c"]).sum()
    assert n.programs == 1 and n.defaults == 0
    new_keys = [k for k in lazy._FUSED_CACHE if k not in before]
    assert len(new_keys) <= 1
    if new_keys:  # may be cached by an earlier test in this worker
        fingerprint, tail_key = new_keys[0]
        assert [node[0] for node in fingerprint[0]] == ["mul", "add"]
        assert tail_key[:2] == ("reduce", "sum")
    np.testing.assert_allclose(out, (p["a"] * p["b"] + p["c"]).sum(), rtol=1e-12)
    np.testing.assert_allclose(out, (m["a"] * m["b"] + m["c"]).sum(), rtol=1e-12)


def test_scalar_values_share_a_program(frames):
    t, _, p = frames
    (t["a"] * 2.0).to_numpy()
    before = lazy.fused_cache_len()
    got = (t["a"] * 3.0).to_numpy()
    assert lazy.fused_cache_len() == before  # the scalar is a runtime argument
    np.testing.assert_array_equal(got, (p["a"] * 3.0).to_numpy())


def test_diamond_subexpression_computed_once(frames):
    t, _, p = frames
    shared = t["a"] * t["b"]
    out = shared + shared
    lin = lazy._linearize([_col(out).raw])
    assert [node[0] for node in lin.nodes] == ["mul", "add"]
    with _Counts() as n:
        got = out.to_numpy()
    assert n.programs == 1
    np.testing.assert_array_equal(got, (p["a"] * p["b"] + p["a"] * p["b"]).to_numpy())


def test_depth_cap_materializes_eagerly(frames):
    t, _, p = frames
    s, ps = t["a"], p["a"]
    for _ in range(lazy._MAX_NODES + 10):
        s = s + 1.0
        ps = ps + 1.0
    _check(s, ps)


def test_max_nodes_overflow_materializes_midchain(frames):
    t, _, p = frames
    s, ps = t["a"], p["a"]
    for i in range(lazy._MAX_NODES + 5):
        s = s + float(i % 3)
        ps = ps + float(i % 3)
    col = _col(s)
    if col.is_lazy:
        assert lazy._distinct_size(col.raw) <= lazy._MAX_NODES
    _check(s, ps)


def test_max_nodes_diamond_not_overcounted(frames):
    t, _, _ = frames
    col = _col(t)
    expr = lazy.lazy_op("add", col.raw, 0.0)
    for _ in range(lazy._MAX_NODES.bit_length() + 4):
        expr = lazy.lazy_op("add", expr, expr)
    assert lazy.is_lazy(expr), "diamond sharing was double-counted"
    assert lazy._distinct_size(expr) <= lazy._MAX_NODES


def test_fused_chain_differential(frames):
    t, m, p = frames

    def pipeline(df):
        return ((df["a"] + df["b"]) * df["c"] - df["a"].abs()) / (df["c"] + 10.0)

    with _Counts() as n:
        got = _as_pandas(pipeline(t))
    assert n.programs == 1 and n.defaults == 0
    _check(got, pipeline(p), jax=pipeline(m))


@pytest.mark.parametrize("agg", ["sum", "mean", "std", "var", "min", "max", "count", "prod", "sem",
                                 "skew", "kurt", "any", "all"])
def test_fused_reductions_differential(frames, agg):
    t, m, p = frames
    with _Counts() as n:
        got = getattr(t * 2.0 + 1.0, agg)()
    assert n.defaults == 0
    assert n.programs == (2 if agg in ("std", "var", "sem", "skew", "kurt") else 1)
    exact = agg in ("min", "max", "count", "any", "all")
    _check(got, getattr(p * 2.0 + 1.0, agg)(), exact=exact)
    if agg not in ("skew", "kurt", "any", "all", "prod", "sem"):
        _check(got, getattr(m * 2.0 + 1.0, agg)(), exact=exact)


@pytest.mark.parametrize("skipna", [True, False])
def test_fused_reductions_with_nan(skipna):
    data = _data(5)
    data["a"][::7] = np.nan
    t, p = tpd.DataFrame(data), pandas.DataFrame(data)
    for agg in ["sum", "mean", "std", "min", "max", "count", "skew"]:
        with _Counts() as n:
            got = getattr(t * 3.0 - 1.0, agg)(skipna=skipna) if agg != "count" else (t * 3.0 - 1.0).count()
        assert n.defaults == 0
        want = getattr(p * 3.0 - 1.0, agg)(skipna=skipna) if agg != "count" else (p * 3.0 - 1.0).count()
        _check(got, want, exact=agg in ("min", "max", "count"))


@pytest.mark.parametrize("agg", ["sum", "mean", "min", "max", "count"])
def test_fused_axis1_reduction(frames, agg):
    t, m, p = frames
    with _Counts() as n:
        got = getattr(t * 3.0, agg)(axis=1)
    assert n.programs == 1 and n.defaults == 0
    _check(got, getattr(p * 3.0, agg)(axis=1), exact=agg in ("min", "max", "count"))
    _check(got, getattr(m * 3.0, agg)(axis=1), exact=agg in ("min", "max", "count"))


def test_filter_on_a_lazy_mask_is_one_program(frames):
    t, m, p = frames
    derived_t, derived_p = t * 2.0, p * 2.0
    with _Counts() as n:
        filtered = derived_t[derived_t["a"] > 0.0]
    # the mask and every deferred column in one launch, then the compaction
    assert n.programs == 1 and n.defaults == 0
    _check(filtered, derived_p[derived_p["a"] > 0.0])


def test_comparison_and_filter_on_lazy(frames):
    t, m, p = frames
    _check(t[(t["a"] * 2.0) > t["b"]], p[(p["a"] * 2.0) > p["b"]], jax=m[(m["a"] * 2.0) > m["b"]])
    _check(t[(t.a > 0) & (t.b < 0.5)], p[(p.a > 0) & (p.b < 0.5)], jax=m[(m.a > 0) & (m.b < 0.5)])


def test_int_promotion_through_fusion():
    data = {"i": np.arange(100, dtype=np.int64), "i8": np.arange(100).astype(np.int8),
            "u8": np.arange(100).astype(np.uint8), "f32": np.linspace(-1, 1, 100).astype(np.float32)}
    t, m, p = tpd.DataFrame(data), mpd.DataFrame(data), pandas.DataFrame(data)
    for fn in [lambda d: d["i"] * 2, lambda d: d["i"] / 4, lambda d: (d["i"] + 1).cumsum(),
               lambda d: d["i8"] * 3 + 100, lambda d: d["u8"] - 200, lambda d: d["i8"] // 7,
               lambda d: d["i8"] % -3, lambda d: d["f32"] * 0.1 + 2, lambda d: d["i8"] + d["u8"],
               lambda d: d["f32"] * d["i"]]:
        with _Counts() as n:
            got = fn(t)
        assert n.defaults == 0
        _check(got, fn(p))


def test_scalar_weak_typing_distinguishes_int_and_float(frames):
    t, _, _ = frames
    lazy._FUSED_CACHE.clear()
    (t["a"] * 2).to_numpy()
    before = lazy.fused_cache_len()
    (t["a"] * 3).to_numpy()
    assert lazy.fused_cache_len() == before  # an int scalar shares
    (t["a"] * 2.5).to_numpy()
    assert lazy.fused_cache_len() == before + 1  # a float scalar does not
    (t["a"] * np.float32(2.5)).to_numpy()
    assert lazy.fused_cache_len() == before + 1  # a numpy float32 operand is weak, as in pandas
    (t["a"] == 2.5).to_numpy()
    assert lazy.fused_cache_len() == before + 2
    (t["a"] == np.float32(2.5)).to_numpy()
    assert lazy.fused_cache_len() == before + 3  # but strong in a comparison, as in pandas


def test_bool_chain_through_fusion(frames):
    t, m, p = frames

    def chain(d):
        return (d["a"] > 0) & (d["b"] < 0) | (d["c"] > 1.5)

    with _Counts() as n:
        got = _as_pandas(chain(t))
    assert n.programs == 1
    _check(got, chain(p), jax=chain(m))


def test_non_registry_maps_on_lazy_frames():
    data = {"a": [1.0, np.nan, 3.0, -4.0, 0.123456, -2.5]}
    t, m, p = tpd.DataFrame(data), mpd.DataFrame(data), pandas.DataFrame(data)
    for fn in [
        lambda df: (df * 2.0).fillna(0.0),
        lambda df: (df * 2.0).round(1),
        lambda df: (df * 2.0).clip(lower=-2.5, upper=5.0),
        lambda df: (df * 2.0).isna(),
        lambda df: (df * 2.0).notna(),
        lambda df: (df * 2.0).dropna(),
        lambda df: (df * 2.0).fillna(0).clip(-1, 1).round(2),
    ]:
        with _Counts() as n:
            got = fn(t)
        assert n.defaults == 0
        _check(got, fn(p))
    # torch's vectorized sqrt on the CPU is within one unit in the last
    # place of numpy's correctly rounded one (on the card both are exact)
    _check(np.sqrt((t * 2.0).abs()) + 1, np.sqrt((p * 2.0).abs()) + 1, exact=False)


def test_standardize_along_the_columns(frames):
    t, _, p = frames
    with _Counts() as n:
        got = (t - t.mean()) / t.std()
        assert _col(got).is_lazy
        got = _as_pandas(got)
    assert n.defaults == 0
    _check(got, (p - p.mean()) / p.std(), exact=False)


def test_diamond_fingerprint_stability(frames):
    t, _, _ = frames

    def build():
        col_a, col_b = _col(t, 0).raw, _col(t, 1).raw
        shared = lazy.lazy_op("mul", col_a, col_b)
        return lazy.lazy_op("add", shared, shared)

    lin1, lin2 = lazy._linearize([build()]), lazy._linearize([build()])
    assert lin1.fingerprint == lin2.fingerprint
    assert [n[0] for n in lin1.nodes] == ["mul", "add"]
    assert lin1.nodes[1][1][0] == lin1.nodes[1][1][1] == ("n", 0)


def test_fused_cache_lru_bound_and_evictions():
    data = {"a": np.arange(64, dtype=np.float64)}
    t, p = tpd.DataFrame(data), pandas.DataFrame(data)
    evictions_before = lazy.fused_cache_evictions()
    old = FusedCacheSize.get()
    FusedCacheSize.put(2)
    try:
        pipelines = [
            lambda df: df["a"] * 2.0,
            lambda df: df["a"] + 1.5,
            lambda df: (df["a"] * 2.0) + 1.5,
            lambda df: df["a"].abs() * 0.5,
        ]
        for fn in pipelines:
            fn(t).to_numpy()
            assert lazy.fused_cache_len() <= 2
        assert lazy.fused_cache_evictions() > evictions_before
        _check(pipelines[0](t), pipelines[0](p))  # an evicted program compiles again
    finally:
        FusedCacheSize.put(old)


def test_fused_cache_lru_recency_order():
    t = tpd.DataFrame({"a": np.arange(32, dtype=np.float64)})
    old = FusedCacheSize.get()
    try:
        FusedCacheSize.put(0)  # unbounded while seeding
        lazy._FUSED_CACHE.clear()
        (t["a"] * 2.0).to_numpy()  # shape A
        (t["a"] + 1.0).to_numpy()  # shape B
        assert lazy.fused_cache_len() == 2
        keys = list(lazy._FUSED_CACHE)
        (t["a"] * 5.0).to_numpy()  # a hit on A makes it the most recent
        assert list(lazy._FUSED_CACHE)[-1] == keys[0]
        FusedCacheSize.put(2)
        t["a"].abs().to_numpy()  # shape C evicts B, the least recently used
        assert keys[0] in lazy._FUSED_CACHE and keys[1] not in lazy._FUSED_CACHE
    finally:
        FusedCacheSize.put(old)


def test_the_cache_size_refuses_a_negative_bound():
    with pytest.raises(ValueError):
        FusedCacheSize.put(-1)


def test_mutating_the_source_after_building_a_chain():
    data = _data(11)
    t, p = tpd.DataFrame(data), pandas.DataFrame(data)
    chain_t = t["a"] * 2.0 + t["b"]
    want = p["a"] * 2.0 + p["b"]
    # every update of the source builds new column tensors: the chain's
    # leaves keep the values it was built over
    t["a"] = t["a"] + 100.0
    t.loc[t["b"] > 0, "b"] = -5.0
    t["b"] = 0.0
    assert _col(chain_t).is_lazy
    _check(chain_t, want)
    p["a"] = p["a"] + 100.0
    p.loc[p["b"] > 0, "b"] = -5.0
    p["b"] = 0.0
    _check(t["a"] + t["b"], p["a"] + p["b"])


def test_a_series_along_other_columns_goes_to_pandas(frames):
    t, _, p = frames
    other = pandas.Series([1.0, 2.0, 3.0], index=["c", "b", "a"])
    with _Counts() as n:
        got = t - tpd.Series(other)
    assert n.defaults == 1  # pandas aligns the labels first: the device declines
    _check(got, p - other)
    with _Counts() as n:
        got = t * tpd.Series([2.0, 3.0, 4.0], index=["a", "b", "c"])
    assert n.defaults == 0 and _col(got).is_lazy
    _check(got, p * pandas.Series([2.0, 3.0, 4.0], index=["a", "b", "c"]))
