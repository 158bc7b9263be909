"""The rest of groupby in the torch port against the JAX package and pandas.

``ops/groupby.py``'s segment aggregations (prod, var, std, sem, any, all),
order aggregations (quantile/median, nunique, first/last), the row-shaped
ones (broadcast, the grouped cumulatives on the scan kernel's plain
version, cumcount) and the factorization memo must agree with
``modin_tpu.ops.groupby`` on the same codes; the groupby API calls of
``chip_smoke.py``'s window phase with ``modin_tpu.pandas`` and pandas,
without a default to pandas.

Tolerances: counts, ints, bools, min/max, first/last, quantiles that pick
a value and int cumulatives exactly; float sums, variances and
interpolated quantiles to ``rtol=1e-12`` (another order of the same
additions over groups of at most a few hundred rows), with ``atol=1e-12``
where a variance is zero.  Where pandas and the JAX package part (a
grouped cumsum after +/-inf, an int32 grouped cumsum's dtype) the port
follows pandas and is held to pandas there.
"""

import threading

import numpy as np
import pandas
import pytest
import torch

import jax.numpy as jnp

import modin_tpu.pandas as mpd
from modin_tpu.ops import groupby as jax_gb
from modin_tpu.utils import to_pandas as jax_to_pandas

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
from modin_tpu_torch.ops import groupby as gb

N = 3_000
RTOL = 1e-12
ATOL = 1e-12


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


def _values(kind: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "int64":
        return rng.integers(-1000, 1000, N)
    if kind == "int32":
        return rng.integers(-1000, 1000, N).astype(np.int32)
    if kind == "small":
        return rng.integers(-2, 3, N)
    if kind == "float64":
        return rng.normal(0, 100, N)
    if kind == "float64_nan":
        return np.where(rng.random(N) < 0.1, np.nan, rng.normal(0, 100, N))
    if kind == "float32":
        return rng.normal(0, 100, N).astype(np.float32)
    if kind == "bool":
        return rng.random(N) < 0.4
    raise ValueError(kind)


def _codes(ngroups: int = 40, seed: int = 1):
    key = np.random.default_rng(seed).integers(0, ngroups, N)
    jc, jg, _, _ = jax_gb.factorize_keys([jnp.asarray(key)], N)
    tc, tg, _, sizes = gb.factorize_keys([torch.as_tensor(key)], N)
    assert jg == tg
    return jc, tc, tg, sizes, key


def _same(got, want, what, exact):
    got, want = np.asarray(got), np.asarray(want)
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("agg", ["prod", "var", "std", "sem", "any", "all"])
@pytest.mark.parametrize("kind", ["int64", "small", "float64", "float64_nan", "bool"])
def test_segment_aggs_match_jax(agg, kind):
    if agg in ("var", "std", "sem", "prod") and kind == "bool":
        kind = "small"  # bools reach these as ints (the compiler casts them)
    if agg == "prod" and kind in ("int64", "float64", "float64_nan"):
        kind = {"int64": "small", "float64": "float64", "float64_nan": "float64_nan"}[kind]
    x = _values(kind, seed=3)
    if agg == "prod" and kind.startswith("float"):
        x = 1 + x / 1e4
    jc, tc, ng, sizes, _ = _codes()
    for ddof in ((0, 1, 2) if agg in ("var", "std", "sem") else (1,)):
        want = np.asarray(jax_gb.groupby_reduce(agg, [jnp.asarray(x)], jc, ng, N, ddof=ddof)[0])[:ng]
        got = gb.groupby_reduce(agg, [torch.as_tensor(x)], tc, ng, N, sizes=sizes, ddof=ddof)[0].numpy()
        assert got.dtype == want.dtype, (agg, kind, got.dtype, want.dtype)
        exact = agg in ("any", "all") or (agg == "prod" and not kind.startswith("float"))
        _same(got, want, f"{agg} {kind} ddof {ddof}", exact=exact)


@pytest.mark.parametrize("q,interpolation", [
    (0.5, "linear"), (0.9, "linear"), (0.0, "linear"), (1.0, "linear"), (0.3, "lower"),
    (0.3, "higher"), (0.5, "nearest"), (0.25, "midpoint"), (0.7, "nearest"),
])
@pytest.mark.parametrize("kind", ["int64", "float64_nan", "float32"])
def test_quantile_matches_jax(q, interpolation, kind):
    x = _values(kind, seed=4)
    jc, tc, ng, _, _ = _codes(25, seed=5)
    for median in (False, True):
        want = np.asarray(jax_gb.groupby_quantile(
            [jnp.asarray(x)], jc, ng, N, q, interpolation, preserve_float_dtype=median)[0])[:ng]
        got = gb.groupby_quantile([torch.as_tensor(x)], tc, ng, N, q, interpolation,
                                  preserve_float_dtype=median)[0].numpy()
        assert got.dtype == want.dtype
        _same(got, want, f"quantile {q} {interpolation} {kind}", exact=interpolation != "linear")


@pytest.mark.parametrize("kind", ["int64", "float64_nan", "small"])
@pytest.mark.parametrize("dropna", [True, False])
def test_nunique_matches_jax(kind, dropna):
    x = _values(kind, seed=6)
    jc, tc, ng, _, _ = _codes(30, seed=7)
    want = np.asarray(jax_gb.groupby_nunique([jnp.asarray(x)], jc, ng, N, dropna)[0])[:ng]
    got = gb.groupby_nunique([torch.as_tensor(x)], tc, ng, N, dropna)[0].numpy()
    _same(got, want, "nunique", exact=True)


@pytest.mark.parametrize("agg", ["first", "last"])
@pytest.mark.parametrize("kind", ["int64", "float64_nan", "bool"])
def test_first_last_match_jax(agg, kind):
    x = _values(kind, seed=8)
    if kind == "float64_nan":
        x[:200] = np.nan  # whole groups missing at the start
    jc, tc, ng, _, _ = _codes(60, seed=9)
    want = np.asarray(jax_gb.groupby_first_last(agg, [jnp.asarray(x)], jc, ng, N)[0])[:ng]
    got = gb.groupby_first_last(agg, [torch.as_tensor(x)], tc, ng, N)[0].numpy()
    assert got.dtype == want.dtype
    _same(got, want, agg, exact=True)


def test_broadcast_matches_jax():
    x = _values("float64_nan", seed=10)
    jc, tc, ng, sizes, _ = _codes()
    aggs_j = jax_gb.groupby_reduce("mean", [jnp.asarray(x)], jc, ng, N)
    aggs_t = gb.groupby_reduce("mean", [torch.as_tensor(x)], tc, ng, N, sizes=sizes)
    want = np.asarray(jax_gb.groupby_broadcast(aggs_j, jc)[0])
    got = gb.groupby_broadcast(aggs_t, tc)[0].numpy()
    _same(got, want, "broadcast", exact=False)


@pytest.mark.parametrize("op", sorted(gb.CUM_AGGS))
@pytest.mark.parametrize("kind", ["int64", "int32", "small", "float64", "float64_nan", "float32"])
def test_grouped_cumulative_matches_jax(op, kind):
    x = _values("small" if op == "cumprod" and kind.startswith("int") else kind, seed=11)
    if op == "cumprod" and kind.startswith("float"):
        x = (1 + x / 1e3).astype(x.dtype)
    jc, tc, _, _, _ = _codes(35, seed=12)
    want = np.asarray(jax_gb.groupby_cumulative(op, [jnp.asarray(x)], jc)[0])
    got = gb.groupby_cumulative(op, [torch.as_tensor(x)], tc)[0].numpy()
    # each column keeps its dtype (pandas); the JAX package widens int32
    assert got.dtype == x.dtype
    if kind == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    else:
        _same(got, want.astype(got.dtype), f"{op} {kind}", exact=not kind.startswith("float") or op in ("cummax", "cummin"))


def test_grouped_cumsum_after_inf_is_pandas():
    x = np.array([1.0, np.inf, 2.0, np.nan, 3.0, 4.0, -np.inf, 5.0])
    key = np.array([0, 0, 0, 0, 1, 1, 1, 1])
    tc, ng, _, _ = gb.factorize_keys([torch.as_tensor(key)], len(key))
    got = gb.groupby_cumulative("cumsum", [torch.as_tensor(x)], tc)[0].numpy()
    want = pandas.Series(x).groupby(key).cumsum().to_numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ascending", [True, False])
def test_cumcount_matches_pandas(ascending):
    _, tc, ng, sizes, key = _codes(17, seed=13)
    got = gb.groupby_cumcount(tc, ng, sizes, ascending).numpy()
    want = pandas.Series(key).groupby(key).cumcount(ascending=ascending).to_numpy()
    np.testing.assert_array_equal(got, want)
    got = gb.groupby_cumcount(tc, ng, None, ascending).numpy()
    np.testing.assert_array_equal(got, want)


def test_factorize_memo_hits_on_the_same_key_tensor():
    gb.clear_factorize_cache()
    key = torch.as_tensor(np.random.default_rng(14).integers(0, 9, N))
    first = gb.factorize_keys_cached([key], N)
    assert gb.factorize_keys_cached([key], N) is first
    assert gb.factorize_keys_cached([key.clone()], N) is not first
    assert gb.factorize_keys_cached([key], N, dropna=False) is not first
    np.testing.assert_array_equal(first[0].numpy(), gb.factorize_keys([key], N)[0].numpy())
    gb.clear_factorize_cache()
    assert gb.factorize_keys_cached([key], N) is not first


# ---------------------------------------------------------------------- #
# the API: the window phase's groupby calls
# ---------------------------------------------------------------------- #


def make_data(rows=2000, seed=0, ngroups=30):
    rng = np.random.default_rng(seed)
    data = {f"col{i}": rng.integers(0, 100, rows) for i in range(4)}
    data["col_s"] = rng.integers(-1, 2, rows)  # products that stay small
    data["groupby_col"] = rng.integers(0, ngroups, rows)
    return data


def float_data(rows=2000, seed=1):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 40, rows) / 8.0
    key[rng.random(rows) < 0.05] = np.nan
    val = rng.uniform(0, 100, rows)
    val[rng.random(rows) < 0.05] = np.nan
    val[rng.random(rows) < 0.01] = np.inf
    return {"key": key, "val": val, "ival": rng.integers(0, 30, rows)}


API_QUERIES = {
    "median": lambda d: d.groupby("groupby_col").median(),
    "quantile_09": lambda d: d.groupby("groupby_col").quantile(0.9),
    "quantile_lower": lambda d: d.groupby("groupby_col").quantile(0.3, interpolation="lower"),
    "nunique": lambda d: d.groupby("groupby_col").nunique(),
    "first": lambda d: d.groupby("groupby_col").first(),
    "last": lambda d: d.groupby("groupby_col").last(),
    "var": lambda d: d.groupby("groupby_col").var(),
    "std_ddof0": lambda d: d.groupby("groupby_col").std(ddof=0),
    "sem": lambda d: d.groupby("groupby_col").sem(),
    "prod": lambda d: (1 - 2 * (d[["col0", "col1"]] % 2)).groupby(d["groupby_col"]).prod(),
    "any": lambda d: (d > 90).groupby(d["groupby_col"]).any(),
    "all": lambda d: (d > 2).groupby(d["groupby_col"]).all(),
    "cumsum": lambda d: d.groupby("groupby_col").cumsum(),
    "cumprod": lambda d: d.groupby("groupby_col")[["col_s"]].cumprod(),
    "cummin": lambda d: d.groupby("groupby_col").cummin(),
    "cummax": lambda d: d.groupby("groupby_col").cummax(),
    "cumcount": lambda d: d.groupby("groupby_col").cumcount(),
    "cumcount_desc": lambda d: d.groupby("groupby_col").cumcount(ascending=False),
    "ngroup": lambda d: d.groupby("groupby_col").ngroup(),
    "transform_mean": lambda d: d.groupby("groupby_col").transform("mean"),
    "transform_sum": lambda d: d.groupby("groupby_col").transform("sum"),
    "agg_list": lambda d: d.groupby("groupby_col").agg(["sum", "mean", "max"]),
    "agg_dict": lambda d: d.groupby("groupby_col").agg({"col0": "sum", "col1": "median", "col2": "nunique"}),
    "describe": lambda d: d.groupby("groupby_col").describe(),
    "series_cumsum": lambda d: d.groupby("groupby_col")["col1"].cumsum(),
    "series_agg_list": lambda d: d.groupby("groupby_col")["col1"].agg(["min", "max"]),
    "series_transform": lambda d: d.groupby("groupby_col")["col1"].transform("max"),
    "two_keys_median": lambda d: d.groupby(["groupby_col", "col0"]).median(),
}

FLOAT_QUERIES = {
    "float_median": lambda d: d.groupby("key").median(),
    "float_first": lambda d: d.groupby("key").first(),
    "float_last": lambda d: d.groupby("key").last(),
    "float_nunique": lambda d: d.groupby("key").nunique(),
    "float_var": lambda d: d[["key", "ival"]].groupby("key").var(),
    "float_cumsum": lambda d: d.groupby("ival")["val"].cumsum(),
    "float_cummin": lambda d: d.groupby("ival").cummin(),
    "float_transform": lambda d: d.groupby("ival")["key"].transform("mean"),
    "float_quantile_dropna_false": lambda d: d.groupby("key", dropna=False).quantile(0.5),
}


def _assert_equal(got, want):
    if isinstance(want, pandas.DataFrame):
        pandas.testing.assert_frame_equal(got, want, rtol=RTOL, atol=ATOL)
    else:
        pandas.testing.assert_series_equal(got, want, rtol=RTOL, atol=ATOL)


def _check_api(fn, data, against_jax=True):
    want = fn(pandas.DataFrame(data))
    defaults = tqc.DEFAULTS_TO_PANDAS
    got = fn(tpd.DataFrame(data))
    assert tqc.DEFAULTS_TO_PANDAS == defaults, "a device query defaulted to pandas"
    got = tpd.to_pandas(got)
    _assert_equal(got, want)
    if against_jax:
        _assert_equal(got, jax_to_pandas(fn(mpd.DataFrame(data))))


@pytest.mark.parametrize("query", sorted(API_QUERIES))
def test_groupby_queries_match_jax_and_pandas(query):
    _check_api(API_QUERIES[query], make_data(seed=20))


@pytest.mark.parametrize("query", sorted(FLOAT_QUERIES))
def test_float_groupby_queries_match_jax_and_pandas(query):
    # the JAX package's grouped cumsum keeps inf where pandas' is NaN
    _check_api(FLOAT_QUERIES[query], float_data(), against_jax=query != "float_cumsum")


def test_int32_grouped_cumsum_keeps_its_dtype():
    d = make_data(seed=21)
    d["col0"] = d["col0"].astype(np.int32)
    _check_api(lambda df: df.groupby("groupby_col").cumsum(), d, against_jax=False)


@pytest.mark.parametrize(
    "query",
    [
        lambda d: d.groupby("groupby_col").skew(),
        lambda d: d.groupby("groupby_col").quantile([0.1, 0.9]),
        lambda d: d.groupby("groupby_col").agg(["sum", "skew"]),
        lambda d: d.groupby("groupby_col").shift(1),
        lambda d: d.groupby("groupby_col").rolling(3).sum(),
        lambda d: d.groupby("groupby_col").transform(lambda s: s - s.mean()),
        lambda d: d.groupby("groupby_col", sort=False).ngroup(),
    ],
    ids=["skew", "quantile_list", "agg_list_with_skew", "shift", "rolling", "transform_callable",
         "ngroup_unsorted"],
)
def test_declined_groupby_queries_default_to_pandas_once(query):
    d = make_data(300, seed=22)
    want = query(pandas.DataFrame(d))
    defaults = tqc.DEFAULTS_TO_PANDAS
    got = tpd.to_pandas(query(tpd.DataFrame(d)))
    assert tqc.DEFAULTS_TO_PANDAS == defaults + 1
    _assert_equal(got, want)
