"""The relational ops of the torch port against the JAX package.

The same numpy inputs (made from a seed) go through ``modin_tpu.ops.sort``,
``modin_tpu.ops.join`` and ``modin_tpu.ops.structural`` on the CPU mesh and
through their ports in ``modin_tpu_torch.ops``.  The JAX package pads every
column to its 8-device mesh, so only the first ``n`` entries of each JAX
result are compared.  Positions, counts and ints must be equal.  Floats are
only moved, never computed, so the port's must equal numpy's ``take`` of the
input bit for bit (pandas' semantics), and the JAX package's value for
value: its gathers across the sharded CPU mesh turn -0.0 into 0.0 (a
cross-shard sum), which ``assert_array_equal`` treats as equal.
"""

import numpy as np
import pytest
import torch

from modin_tpu.ops import join as jax_join
from modin_tpu.ops import sort as jax_sort
from modin_tpu.ops import structural as jax_structural
from modin_tpu.parallel.engine import JaxWrapper

import modin_tpu_torch
from modin_tpu_torch.ops import join, sort, structural


@pytest.fixture(autouse=True)
def _cpu_device():
    modin_tpu_torch.set_device("cpu")


def _jax(values: np.ndarray):
    """A padded JAX device column of ``values``."""
    return JaxWrapper.put(jax_structural.pad_host(np.asarray(values)))


def _np(x, n=None) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a if n is None else a[:n]


def _assert_bitwise(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    if got.dtype.kind == "f":
        np.testing.assert_array_equal(got.view(f"i{got.itemsize}"), want.view(f"i{want.itemsize}"))
    else:
        np.testing.assert_array_equal(got, want)


def _assert_moved(got: np.ndarray, jax_want: np.ndarray, np_want: np.ndarray) -> None:
    """Moved values: bitwise numpy's, value for value the JAX package's."""
    _assert_bitwise(got, np_want)
    assert jax_want.dtype == got.dtype
    np.testing.assert_array_equal(got, jax_want)


def _take_null(values: np.ndarray, positions: np.ndarray) -> np.ndarray:
    """numpy reference of a right-side gather: -1 gives NaN or int min."""
    out = values[np.where(positions >= 0, positions, 0)]
    null = np.nan if values.dtype.kind == "f" else np.iinfo(values.dtype).min
    return np.where(positions >= 0, out, np.asarray(null, values.dtype))


def _key(kind: str, n: int, seed: int) -> np.ndarray:
    """Sort/join keys with heavy ties; float kinds carry NaN, +/-inf and
    both signed zeros."""
    rng = np.random.default_rng(seed)
    if kind == "int64":
        return rng.integers(-20, 20, n)
    if kind == "int32":
        return rng.integers(-20, 20, n).astype(np.int32)
    if kind == "uint8":
        return rng.integers(0, 30, n).astype(np.uint8)
    x = rng.integers(-20, 20, n) / 4.0
    x[rng.random(n) < 0.1] = np.nan
    x[rng.random(n) < 0.05] = -0.0
    x[rng.random(n) < 0.05] = 0.0
    x[rng.random(n) < 0.02] = np.inf
    x[rng.random(n) < 0.02] = -np.inf
    return x.astype(np.float32) if kind == "float32" else x


# ---------------------------------------------------------------------- #
# float_total_order and lexsort_permutation
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", ["float64", "float32"])
def test_float_total_order(kind):
    x = _key(kind, 997, 1)
    want = np.asarray(jax_structural.float_total_order(_jax(x)))[: len(x)]
    got = _np(structural.float_total_order(torch.as_tensor(x)))
    _assert_bitwise(got, want)
    # strict order: NaN above +inf, -0.0 tied with 0.0
    assert got[np.isnan(x)].min() > got[x == np.inf].max()
    assert len(set(got[x == 0].tolist())) == 1


LEXSORT_CASES = [
    (("int64",), (True,)),
    (("int64",), (False,)),
    (("float64",), (True,)),
    (("float64",), (False,)),
    (("float32",), (True,)),
    (("int32", "float64"), (True, False)),
    (("float64", "int64"), (False, True)),
    (("uint8", "int64", "float64"), (True, False, True)),
]


@pytest.mark.parametrize("na_position", ["last", "first"])
@pytest.mark.parametrize("n", [1000, 1003])
@pytest.mark.parametrize(
    "kinds,ascending", LEXSORT_CASES, ids=["-".join(k) + str(a) for k, a in LEXSORT_CASES]
)
def test_lexsort_permutation(kinds, ascending, n, na_position):
    keys = [_key(k, n, seed) for seed, k in enumerate(kinds)]
    want = np.asarray(
        jax_sort.lexsort_permutation([_jax(k) for k in keys], n, list(ascending), na_position)
    )[:n]
    got = _np(
        sort.lexsort_permutation(
            [torch.as_tensor(k) for k in keys], n, list(ascending), na_position
        )
    )
    _assert_bitwise(got, want.astype(np.int64))


def test_lexsort_matches_pandas_nargsort():
    import pandas

    n = 2000
    df = pandas.DataFrame({"a": _key("float64", n, 5), "b": _key("int64", n, 6)})
    for asc in ([True, False], [False, True]):
        for na in ("first", "last"):
            want = df.sort_values(["a", "b"], ascending=asc, na_position=na).index.to_numpy()
            got = sort.lexsort_permutation(
                [torch.as_tensor(df["a"].to_numpy()), torch.as_tensor(df["b"].to_numpy())],
                n, asc, na,
            )
            np.testing.assert_array_equal(_np(got), want)


# ---------------------------------------------------------------------- #
# join: composite codes, sort-merge positions, right-only rows, gather
# ---------------------------------------------------------------------- #


def _dense_codes(lc: np.ndarray, rc: np.ndarray):
    _, inv = np.unique(np.concatenate([lc, rc]), return_inverse=True)
    return inv[: len(lc)], inv[len(lc):]


@pytest.mark.parametrize("kinds", [("int64", "float64"), ("float32", "int32", "int64")])
@pytest.mark.parametrize("sizes", [(1504, 904), (1501, 907)], ids=["unpadded", "ragged"])
def test_composite_key_codes(kinds, sizes):
    n_l, n_r = sizes
    lkeys = [_key(k, n_l, 10 + i) for i, k in enumerate(kinds)]
    rkeys = [_key(k, n_r, 20 + i) for i, k in enumerate(kinds)]
    jl, jr = jax_join.composite_key_codes([_jax(k) for k in lkeys], [_jax(k) for k in rkeys])
    # JAX ranks in int32 at these sizes; the port keeps int64 throughout
    jl, jr = np.asarray(jl)[:n_l].astype(np.int64), np.asarray(jr)[:n_r].astype(np.int64)
    tl, tr = join.composite_key_codes(
        [torch.as_tensor(k) for k in lkeys], [torch.as_tensor(k) for k in rkeys]
    )
    tl, tr = _np(tl), _np(tr)
    if n_l % 8 == 0 and n_r % 8 == 0:
        # no pad rows in the JAX union: the very same ranks
        _assert_bitwise(tl, jl)
        _assert_bitwise(tr, jr)
    else:
        # JAX's pad rows join its union and shift ranks; the codes still
        # compare alike
        for a, b in zip(_dense_codes(tl, tr), _dense_codes(jl, jr)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("how", ["inner", "left"])
@pytest.mark.parametrize("kind", ["int64", "float64", "float32"])
@pytest.mark.parametrize("sizes", [(1501, 907), (64, 3000)])
def test_sort_merge_positions(kind, how, sizes):
    n_l, n_r = sizes
    lk, rk = _key(kind, n_l, 1), _key(kind, n_r, 2)
    rk[rk == 3] = 2  # left keys equal to 3 match nothing: left-join misses
    e_lp, e_rp, e_n, e_miss = jax_join.sort_merge_positions(_jax(lk), _jax(rk), n_l, n_r, how)
    g_lp, g_rp, g_n, g_miss = join.sort_merge_positions(
        torch.as_tensor(lk), torch.as_tensor(rk), n_l, n_r, how
    )
    assert (g_n, g_miss) == (e_n, e_miss)
    _assert_bitwise(_np(g_lp), np.asarray(e_lp)[:e_n].astype(np.int64))
    _assert_bitwise(_np(g_rp), np.asarray(e_rp)[:e_n].astype(np.int64))
    if how == "left":
        # the outer appendix: right rows no left row matched
        p_right = int(_jax(rk).shape[0])
        e_order, e_m = jax_join.right_only_positions(e_rp, p_right, n_r, e_n)
        g_order, g_m = join.right_only_positions(g_rp, n_r)
        assert g_m == e_m
        _assert_bitwise(_np(g_order), np.asarray(e_order)[:e_m].astype(np.int64))
        # right columns gathered by the positions, -1 to NaN / int min
        rcols = [_key("int64", n_r, 3), _key("float64", n_r, 4), _key("int32", n_r, 5)]
        want = jax_join.gather_right_columns([_jax(c) for c in rcols], e_rp)
        got = join.gather_right_columns([torch.as_tensor(c) for c in rcols], g_rp)
        for c, g, w in zip(rcols, got, want):
            _assert_moved(_np(g), np.asarray(w)[:e_n], _take_null(c, _np(g_rp)))


def test_sort_merge_no_match():
    lp, rp, n, miss = join.sort_merge_positions(
        torch.arange(5), torch.arange(10, 13), 5, 3, "inner"
    )
    assert (n, miss, len(lp), len(rp)) == (0, False, 0, 0)
    lp, rp, n, miss = join.sort_merge_positions(
        torch.arange(5), torch.arange(10, 13), 5, 3, "left"
    )
    assert (n, miss) == (5, True)
    np.testing.assert_array_equal(_np(rp), [-1] * 5)


# ---------------------------------------------------------------------- #
# structural: compaction and concat
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("n", [1000, 1003, 8])
@pytest.mark.parametrize("keep_share", [0.0, 0.3, 1.0])
def test_compact_rows(n, keep_share):
    rng = np.random.default_rng(7)
    cols = [_key("int64", n, 1), _key("float64", n, 2), rng.random(n) < 0.5]
    mask = rng.random(n) < keep_share
    e_cols, e_count, e_perm = jax_structural.compact_rows([_jax(c) for c in cols], _jax(mask), n)
    e_count = int(np.asarray(e_count))
    g_cols, g_count, g_pos = structural.compact_rows(
        [torch.as_tensor(c) for c in cols], torch.as_tensor(mask), n
    )
    assert g_count == e_count == int(mask.sum())
    _assert_bitwise(_np(g_pos), np.asarray(e_perm)[:e_count].astype(np.int64))
    for c, g, w in zip(cols, g_cols, e_cols):
        _assert_moved(_np(g), np.asarray(w)[:e_count], c[mask])


@pytest.mark.parametrize("lengths", [(1000, 1003), (1003, 5), (8, 8, 17)])
def test_concat_columns(lengths):
    parts = [
        [_key("int64", n, 1 + i), _key("float64", n, 2 + i), _key("uint8", n, 3 + i)]
        for i, n in enumerate(lengths)
    ]
    e_cols, e_n = jax_structural.concat_columns(
        [[_jax(c) for c in p] for p in parts], list(lengths)
    )
    g_cols, g_n = structural.concat_columns(
        [[torch.as_tensor(c) for c in p] for p in parts], list(lengths)
    )
    assert g_n == e_n == sum(lengths)
    for ci, (g, w) in enumerate(zip(g_cols, e_cols)):
        want = np.concatenate([p[ci] for p in parts])
        _assert_moved(_np(g), np.asarray(w)[:e_n], want)


def test_gather_columns_host_positions():
    cols = [_key("int64", 100, 1), _key("float64", 100, 2)]
    positions = np.array([5, 0, 99, 5, 42])
    e_cols, e_n = jax_structural.gather_columns([_jax(c) for c in cols], positions)
    g_cols, g_n = structural.gather_columns([torch.as_tensor(c) for c in cols], positions)
    assert g_n == e_n == 5
    for c, g, w in zip(cols, g_cols, e_cols):
        _assert_moved(_np(g), np.asarray(w)[:e_n], c[positions])
