"""The fused groupby's kernels on the CPU: ``groupagg`` and the masked tails.

- ``groupagg_kernels.groupagg_plain`` (what the CPU runs, and what the card's
  ``csrc/groupagg.cu`` is held to bit for bit) against a row-by-row
  emulation of the kernel's order (a tree over each slot's rows in a group
  of 32, each table copy's groups in row order, the copies in order, the
  merge's runs of chunks and its tree over them): bit for bit, at widths
  that split the slots into ranges and at every table-copy count;
- the eager groupby on ``groupagg`` (``MODIN_TPU_TORCH_FUSE=Fused`` sends
  ``groupby_reduce`` to the kernel, which the CPU runs as its plain
  version) against the JAX package's groupby (``modin_tpu.pandas`` on the
  CPU mesh) and pandas: ints exactly, floats to rtol 1e-12;
- ``ops/groupby.fused_group_probe`` / ``fused_group_agg`` and
  ``ops/reductions.reduce_columns_masked`` against the JAX package's
  functions of the same names run on the CPU (``modin_tpu.ops``), on the
  same seeded numpy inputs: counts, sizes, keys and int results exactly,
  float sums and means to rtol 1e-12 (another summation order), min/max
  exactly; narrow ints, where the JAX package wraps, against pandas;
- the masked mode of the fused program: its lowering decodes back to the
  semantic program, and the plain masked tail equals the unmasked tail over
  the rows zeroed out, bit for bit (a masked-out row adds the tail's
  neutral, as the kernel adds nothing).
"""

import threading

import numpy as np
import pandas
import pytest
import torch

import jax.numpy as jnp
import modin_tpu.pandas as mpd
from modin_tpu.ops import groupby as jgb
from modin_tpu.ops import reductions as jred
from modin_tpu.utils import to_pandas as jax_to_pandas

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch.config import FuseMode
from modin_tpu_torch.ops import groupby as gb
from modin_tpu_torch.ops import reductions
from modin_tpu_torch.ops.cuda import fused_kernels as fk
from modin_tpu_torch.ops.cuda import fused_program as fp
from modin_tpu_torch.ops.cuda import groupagg_kernels as ga
from modin_tpu_torch.ops.lazy import lazy_op
from modin_tpu_torch.ops import lazy
from tests.test_torch_fused_program import _semantic_refs, _ssa


@pytest.fixture(autouse=True)
def _cpu_device():
    modin_tpu_torch.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _join_jax_watchdog_threads():
    yield
    for t in threading.enumerate():
        if t.name.startswith("modin-tpu-watchdog"):
            t.join(timeout=5)


def _values(dtype, n, rng, nan_frac=0.15):
    if dtype in ("float64", "float32"):
        x = rng.normal(size=n).astype(dtype)
        x[rng.random(n) < nan_frac] = np.nan
        x[: min(n, 4)] = np.array([0.0, -0.0, 0.0, -0.0])[: min(n, 4)]  # signed zero ties
        return x
    if dtype == "bool":
        return rng.integers(0, 2, n).astype(bool)
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -120), min(info.max, 120), n).astype(dtype)


def _emulate(agg, slot, x, g1, geo):
    """The kernel's order, row by row: [g1] float64 or int64 values.  A
    group of 32 rows combines each slot's rows in a tree over their ranks
    (rank r takes rank r + 2^d at level d; a NaN is the identity in its
    rank), each table copy folds its groups in row order, a chunk folds its
    copies in order, and the merge folds the chunks in 32 runs of ``per``
    and the runs in a tree."""
    fl = x.dtype.kind == "f" or agg == "mean"
    init = {"sum": 0, "mean": 0, "count": 0, "prod": 1,
            "min": np.inf if fl else np.iinfo(np.int64).max,
            "max": -np.inf if fl else np.iinfo(np.int64).min}[agg]
    dt = np.float64 if fl else np.int64
    groups = {}
    with np.errstate(over="ignore", invalid="ignore"):
        for r in range(len(x)):
            s = int(slot[r])
            if not 0 <= s < g1 - 1:
                continue
            v = dt(x[r])
            if fl and np.isnan(v):
                v = dt(init)
            groups.setdefault((r // 32, s), []).append(v)
        sub = geo.chunk // geo.copies
        level2 = {}
        for (grp, s), vals in sorted(groups.items()):
            for d in range(5):
                for k in range(0, len(vals), 2 << d):
                    if k + (1 << d) < len(vals):
                        vals[k] = _fold(agg, vals[k], vals[k + (1 << d)])
            r0 = grp * 32
            key = (r0 // geo.chunk, (r0 % geo.chunk) // sub, s)
            level2[key] = _fold(agg, level2.get(key, dt(init)), vals[0])
        level3 = {}
        for (c, _copy, s), v in sorted(level2.items()):
            level3[(c, s)] = _fold(agg, level3.get((c, s), dt(init)), v)
        per = -(-geo.chunks // 32)
        out = np.full(g1, init, dtype=dt)
        for s in sorted({s for _c, s in level3}):  # a slot without rows keeps the identity
            lanes = [dt(init)] * 32
            for lane in range(32):
                for c in range(lane * per, min((lane + 1) * per, geo.chunks)):
                    lanes[lane] = _fold(agg, lanes[lane], level3.get((c, s), dt(init)))
            for d in range(5):
                for lane in range(0, 32, 2 << d):
                    lanes[lane] = _fold(agg, lanes[lane], lanes[lane + (1 << d)])
            out[s] = lanes[0]
    return out


def _fold(agg, v, x):
    if agg in ("sum", "mean"):
        return v + x
    if agg == "prod":
        return v * x
    if agg == "min":
        return x if x < v else v
    if agg == "max":
        return x if v < x else v
    return v


def _check_against_emulation(agg, slot, x, g1, geo=None):
    table = ga.groupagg_plain(agg, torch.as_tensor(slot), [torch.as_tensor(x)], g1, _geometry=geo)
    geo = geo or ga.launch_geometry(len(slot), g1, 1)
    kept = (slot >= 0) & (slot < g1 - 1)  # the overflow slot folds nothing
    assert table[0].tolist() == np.bincount(slot[kept], minlength=g1).tolist()
    fl = x.dtype.kind == "f"
    ok = kept & ~np.isnan(x) if fl else kept
    assert table[2].tolist() == np.bincount(slot[ok], minlength=g1).tolist()
    if agg != "count":
        want = _emulate(agg, slot, x, g1, geo)
        assert np.array_equal(table[1].numpy(), want.view(np.int64)), (agg, x.dtype)


@pytest.mark.parametrize("agg", ga.AGGS)
@pytest.mark.parametrize("dtype", ["float64", "float32", "int8", "int64", "uint8", "bool"])
@pytest.mark.parametrize("n,g1", [(1, 9), (37, 9), (5000, 9), (6000, 129), (3000, 16385), (20000, 129),
                                  (9000, 16385), (6000, 65537)])
def test_plain_takes_the_kernel_order(agg, dtype, n, g1):
    """Widths 16 385 and 65 537 split the slots into ranges; 20 000 rows run
    five chunks of eight copies' sub-chunks of two tiles each."""
    rng = np.random.default_rng(n + g1)
    slot = rng.integers(0, g1, n).astype(np.int32)
    x = _values(dtype, n, rng)
    _check_against_emulation(agg, slot, x, g1)


@pytest.mark.parametrize("agg", ["sum", "prod", "mean", "min", "max"])
@pytest.mark.parametrize("copies", [1, 2, 4])
def test_plain_takes_the_order_of_every_copy_count(agg, copies):
    """A forced geometry of 1, 2 or 4 table copies (the widths that leave
    fewer than 8), over int64 slots with a few hot ones and 33 chunks (two
    chunks in the first lane's run of the merge)."""
    n, g1 = 33 * 2048 - 100, 33
    rng = np.random.default_rng(copies)
    slot = np.where(rng.random(n) < 0.5, rng.integers(0, 3, n), rng.integers(0, g1, n)).astype(np.int64)
    x = _values("float64", n, rng)
    geo = ga.Geometry(blocks=33, chunks=33, chunk=2048, copies=copies, range_slots=g1, ranges=1, stages=4,
                      stage_groups=4, bulk=True)
    _check_against_emulation(agg, slot, x, g1, geo)


def test_launch_geometry_covers_the_rows():
    for n in (1, 31, 2048, 2049, 10**6, 2 * 10**7, 10**8):
        for g1 in (9, 101, 129, 1025, 10001, 16385, 65537):
            for cols in (1, 2, 5, 10, 32):
                geo = ga.launch_geometry(n, g1, cols)
                ga._check_geometry(geo, n, g1, cols)
                assert geo.blocks <= max(ga.MAX_BLOCKS, geo.ranges) and geo.chunk % ga.CHUNK_ALIGN == 0
                assert (geo.chunks - 1) * geo.chunk < n <= geo.chunks * geo.chunk or n <= 1
                assert geo.chunks * (1 + 2 * cols) * g1 <= max(2 * n, 1 << 24) or geo.chunks == 1
                # the tables sit in shared memory beside two stages: as many
                # copies as fit, a range split only where one copy does not
                stage = ga._stage_bytes(cols)
                assert geo.copies * ga.table_bytes(geo.range_slots, cols) + stage <= ga.SMEM_MAX
                if geo.ranges > 1:
                    assert geo.copies == 1 and ga.table_bytes(g1, cols) + stage > ga.SMEM_MAX
                elif geo.copies < 8:
                    assert 2 * geo.copies * ga.table_bytes(g1, cols) + stage > ga.SMEM_MAX
    # eight copies for the main path's shape, one block's table for 1025
    # slots of five columns, slot ranges at 65 537 slots of one
    assert ga.launch_geometry(10**8, 101, 10).copies == 8
    assert ga.launch_geometry(10**8, 1025, 5).ranges == 1
    assert ga.launch_geometry(10**8, 65537, 1).ranges > 1


EAGER_DTYPES = ["int8", "int64", "uint8", "bool", "float32", "float64"]


def _eager_frame(agg, dtype, groups, seed):
    """Keys of ``groups`` values (every one present) and a value column of
    ``dtype`` (floats with NaN and signed zeros); a product's floats lie in
    [0.8, 1.25), so that no group's product leaves float32's range."""
    rng = np.random.default_rng(seed)
    n = max(20 * groups, 5000)
    key = np.concatenate([np.arange(groups), rng.integers(0, groups, n - groups)])
    if agg == "prod" and dtype.startswith("float"):
        x = rng.uniform(0.8, 1.25, n).astype(dtype)
        x[rng.random(n) < 0.15] = np.nan
    else:
        x = _values(dtype, n, rng)
    return pandas.DataFrame({"k": key, "v": x})


def _jax_agrees(agg, dtype):
    """Where the JAX package's groupby gives pandas' answer: it adds a
    narrow int column in the column's dtype and wraps (sums, products and
    means alike; ROADMAP Queue 3 item 4), multiplies int64s in another
    order of wrapping, and adds float32 in float32, so those are held to
    pandas alone."""
    if dtype in ("int8", "uint8", "bool"):
        return agg in ("min", "max", "count")
    if dtype == "float32":
        return agg in ("min", "max", "count")
    return not (dtype == "int64" and agg == "prod")


def _same_groups(got, want, agg, df, rtol):
    """Ints, counts and min/max exactly (the sign of a zero included); a
    float sum or mean to ``rtol`` of each group's magnitude (the sum or
    mean of its |x|: no order bounds a cancelling sum's error by the sum
    itself), a product to ``rtol`` of itself."""
    assert got.index.equals(want.index) and got.dtype == want.dtype, (got.dtype, want.dtype)
    if want.dtype.kind != "f" or agg in ("min", "max", "count"):
        pandas.testing.assert_series_equal(got, want, check_exact=True)
        if want.dtype.kind == "f":
            assert np.array_equal(np.signbit(got.to_numpy()), np.signbit(want.to_numpy()))
        return
    g, w = got.to_numpy(np.float64), want.to_numpy(np.float64)
    if agg in ("sum", "mean"):
        scale = getattr(df["v"].astype(np.float64).abs().groupby(df["k"]), agg)().to_numpy()
    else:
        scale = np.abs(w)
    assert ((np.abs(g - w) <= rtol * scale) | (np.isnan(g) & np.isnan(w))).all(), (agg, got, want)


@pytest.mark.parametrize("agg", ["sum", "mean", "prod", "min", "max", "count"])
@pytest.mark.parametrize("dtype", EAGER_DTYPES)
@pytest.mark.parametrize("groups", [8, 100, 10_000])
def test_eager_groupby_on_groupagg_against_the_jax_package(monkeypatch, agg, dtype, groups):
    df = _eager_frame(agg, dtype, groups, groups + len(dtype))
    calls = []
    run = ga.groupagg
    monkeypatch.setattr(ga, "groupagg", lambda *a, **k: calls.append(a[0]) or run(*a, **k))
    with FuseMode.context("Fused"):
        got = getattr(tpd.DataFrame(df).groupby("k"), agg)()._to_pandas()
    # an int column's count is its group's size: no launch
    assert calls == ([] if agg == "count" and not dtype.startswith("float") else [agg])
    # pandas adds a float32 column in float32, the port in float64
    rtol = 1e-6 if dtype == "float32" else 1e-12
    _same_groups(got["v"], getattr(df.groupby("k"), agg)()["v"], agg, df, rtol)
    if _jax_agrees(agg, dtype):
        from_jax = jax_to_pandas(getattr(mpd.DataFrame(df).groupby("k"), agg)())
        _same_groups(got["v"], from_jax["v"], agg, df, rtol)


def _inputs(n, dtype, seed):
    rng = np.random.default_rng(seed)
    key = rng.integers(-3, 40, n)
    a = rng.integers(-5, 5, n)
    x = _values(dtype, n, rng)
    return key, a, x


@pytest.mark.parametrize("agg", sorted(gb.FUSED_GROUPBY_AGGS))
@pytest.mark.parametrize("dtype", ["float64", "float32", "int64", "int32", "bool"])
@pytest.mark.parametrize("masked", [True, False])
def test_fused_group_agg_against_the_jax_package(agg, dtype, masked):
    n = 3001
    key, a, x = _inputs(n, dtype, 41)
    tkeep = lazy_op("gt", torch.as_tensor(a), 0) if masked else None
    jkeep = jnp.asarray(a) > 0 if masked else None
    kmin, kmax, kept = gb.fused_group_probe(torch.as_tensor(key), tkeep, n)
    jmin, jmax, jkept = jgb.fused_group_probe(jnp.asarray(key), jkeep, n)
    assert (kmin, kmax, kept) == (jmin, jmax, jkept)
    buckets = gb.fused_groups_bucket(kmax - kmin + 1)
    sizes, tables, counts = gb.fused_group_agg(agg, torch.as_tensor(key), [torch.as_tensor(x)], tkeep, n, kmin,
                                               buckets)
    jsizes, jtables, jcounts = jgb.fused_group_agg(agg, jnp.asarray(key), [jnp.asarray(x)], jkeep, n, kmin,
                                                   buckets)
    np.testing.assert_array_equal(sizes, np.asarray(jsizes))
    np.testing.assert_array_equal(counts[0], np.asarray(jcounts[0]))
    obs = np.nonzero(sizes[:buckets] > 0)[0]
    got, want = np.asarray(tables[0])[obs], np.asarray(jtables[0])[obs]
    if dtype == "int32" and agg == "prod":
        # the JAX package multiplies in int32 and wraps; the port in int64,
        # as pandas does
        m = a > 0 if masked else np.ones(n, bool)
        want = pandas.Series(x[m].astype(np.int64)).groupby(key[m]).prod().to_numpy()
    if dtype.startswith("float") or agg == "mean":
        # the JAX package sums a float32 column in float32, the port in
        # float64 (rounded once): those agree to float32's precision
        if dtype == "float32" and agg in ("sum", "prod", "mean"):
            m = a > 0 if masked else np.ones(n, bool)
            exact = getattr(pandas.Series(x[m].astype(np.float64)).groupby(key[m]), agg)().to_numpy()
            np.testing.assert_allclose(got, exact, rtol=1e-12)
            np.testing.assert_allclose(got, want.astype(np.float64), rtol=1e-6, atol=1e-5)
        else:
            np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=1e-12,
                                       equal_nan=True)
        if agg in ("min", "max"):  # order-free: exactly, the sign of a zero included
            assert np.array_equal(np.signbit(got.astype(np.float64)), np.signbit(want.astype(np.float64)))
    else:
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))


@pytest.mark.parametrize("agg", ["sum", "prod", "mean", "min", "max", "count"])
@pytest.mark.parametrize("dtype", ["int8", "uint8", "int16"])
def test_narrow_int_fused_group_agg_follows_pandas(agg, dtype):
    """The JAX package's fused groupby wraps a narrow int sum in the
    column's dtype; the port adds in int64 and takes pandas' dtype."""
    n = 3000
    key, a, x = _inputs(n, dtype, 42)
    keep = lazy_op("gt", torch.as_tensor(a), -3)
    kmin, kmax, kept = gb.fused_group_probe(torch.as_tensor(key), keep, n)
    buckets = gb.fused_groups_bucket(kmax - kmin + 1)
    sizes, tables, _ = gb.fused_group_agg(agg, torch.as_tensor(key), [torch.as_tensor(x)], keep, n, kmin, buckets)
    obs = np.nonzero(sizes[:buckets] > 0)[0]
    values = np.asarray(tables[0])[obs]
    out = gb.fused_groupby_dtype(agg, np.dtype(dtype), values)
    got = values.view(np.uint64).astype(out) if out.kind == "u" else values.astype(out)
    m = a > -3
    want = getattr(pandas.Series(x[m]).groupby(key[m]), agg)()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_allclose(got.astype(np.float64), want.to_numpy(np.float64), rtol=1e-12)


@pytest.mark.parametrize("op", ["sum", "mean", "var", "std", "min", "max", "count", "prod", "any", "all", "skew"])
@pytest.mark.parametrize("skipna", [True, False])
def test_reduce_columns_masked_against_the_jax_package(op, skipna):
    rng = np.random.default_rng(5)
    n = 4099
    a = rng.integers(-5, 5, n)
    cols = {"f64": _values("float64", n, rng), "f32": _values("float32", n, rng),
            "i64": rng.integers(-50, 50, n), "b": rng.integers(0, 2, n).astype(bool)}
    tcols = [lazy_op("mul", torch.as_tensor(c), 1) if k != "b" else torch.as_tensor(c) for k, c in cols.items()]
    vals, kept = reductions.reduce_columns_masked(op, tcols, lazy_op("gt", torch.as_tensor(a), 0), n,
                                                  skipna=skipna, cast_bool=True)
    jvals, jkept = jred.reduce_columns_masked(op, [jnp.asarray(c) for c in cols.values()], jnp.asarray(a) > 0, n,
                                              skipna=skipna, cast_bool=True)
    assert kept == jkept == int((a > 0).sum())
    for name, v, jv in zip(cols, vals, jvals):
        # a float32 column: the JAX package sums it in float32
        rtol = 1e-6 if name == "f32" else 1e-12
        np.testing.assert_allclose(np.asarray(v, dtype=np.float64), np.asarray(jv, dtype=np.float64),
                                   rtol=rtol, equal_nan=True)


@pytest.mark.parametrize("op", ["sum", "mean", "var", "min", "max", "prod", "any"])
def test_masked_programs_lower_and_match_the_zeroed_tail(op):
    rng = np.random.default_rng(9)
    n = 5000
    x = torch.as_tensor(rng.normal(size=n))
    x[::11] = float("nan")
    m = torch.as_tensor(rng.random(n) < 0.5)
    e = lazy_op("mul", x, 3.0)
    tail = ("reduce", op, True, 1, False)
    lin, plans = lazy._plan([e, m], tail + (True,))
    for program in plans:
        assert program.out_dtypes[-1] == (fp.F64 if fp.REDUCE_MODES[op] == fp.TAIL_M1 else fp.BOOL)
        for low in [program.kernel] + ([program.kernel_m2] if program.kernel_m2 is not None else []):
            assert _ssa(fp.decode(low, len(program.slots))) == _ssa(_semantic_refs(program))
    first, _ = lazy.run_fused([e, m], tail + (True,))
    neutral = {"prod": 1.0, "min": float("inf"), "max": float("-inf")}.get(op, 0.0)
    filled = torch.where(m, x * 3.0, neutral)
    unmasked, _ = lazy.run_fused([filled], tail)
    # the value slot equals the tail over the neutral-filled rows; the
    # counts are the kept rows' own
    assert first[0, 0].item() == unmasked[0, 0].item()
    ok = m & ~torch.isnan(x)
    assert first[0, 1].item() == int(ok.sum())
    assert first[0, 2].item() == int((m & torch.isnan(x)).sum())
    assert first[-1, 1].item() == int(m.sum())  # the kept-row count


def test_probe_is_one_program_and_counts_kept_rows():
    rng = np.random.default_rng(3)
    key = torch.as_tensor(rng.integers(-(2**62), 2**62, 1000))
    keep = lazy_op("lt", torch.as_tensor(rng.random(1000)), 0.3)
    p0 = fk.PROGRAMS_RUN
    kmin, kmax, kept = gb.fused_group_probe(key, keep, 1000)
    assert fk.PROGRAMS_RUN - p0 == 1
    sel = key.numpy()[lazy.materialize(keep).numpy()]
    assert (kmin, kmax, kept) == (int(sel.min()), int(sel.max()), len(sel))
