"""The range shuffle of the torch port (``modin_tpu_torch/parallel/shuffle.py``).

The counterpart of ``tests/test_shuffle.py``, its ten cases, each at meshes
of 2, 4 and 8 row shards: the port's shards wrap onto the one CPU device,
the JAX package's run on its 8-device CPU mesh reshaped to the same count.
The same seeded numpy keys go through both shuffles; the pivots, the rows
each shard received, the slack retries and the rows in their shuffled
order must be equal.  Keys and payloads are only moved, so the port's
output is numpy's stable reordering bit for bit, and the JAX package's
value for value (its cross-shard gathers turn -0.0 into 0.0).  The sorts
through the shuffle (``RangePartitioning``) are held to pandas' stable
sort and to the port's local sort.
"""

import functools
import threading

import numpy as np
import pandas
import pytest
import torch

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch.config import MeshShape, RangePartitioning
from modin_tpu_torch.core.execution import resilience as tres
from modin_tpu_torch.parallel import shuffle

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
    """Both packages at ``S`` row shards; the defaults come back after."""
    from modin_tpu.config import MeshShape as JaxMeshShape
    from modin_tpu.parallel.mesh import num_row_shards, reset_mesh

    def reshape(shards: int) -> int:
        JaxMeshShape.put((shards, 1))
        reset_mesh()
        MeshShape.put((shards, 1))
        assert num_row_shards() == shards
        return shards

    try:
        yield reshape
    finally:
        MeshShape.put(None)
        JaxMeshShape.put((8, 1))
        reset_mesh()


@pytest.fixture
def jax_metrics():
    from modin_tpu.logging import add_metric_handler, clear_metric_handler

    seen = {}

    def handler(name, value):
        seen[name] = seen.get(name, 0) + value

    add_metric_handler(handler)
    yield seen
    clear_metric_handler(handler)


def _jax_shuffle(keys, cols, n, metrics, **kwargs):
    """The JAX package's shuffle of the same inputs: (key, cols, counts,
    pivots, slack retries), its outputs cut to the ``n`` valid rows."""
    from modin_tpu.ops.structural import pad_host
    from modin_tpu.parallel.engine import JaxWrapper
    from modin_tpu.parallel.shuffle import range_shuffle

    before = metrics.get("modin_tpu.resilience.shuffle.slack_retry", 0)
    k, c, counts, pivots = range_shuffle(
        JaxWrapper.put(pad_host(keys)), [JaxWrapper.put(pad_host(v)) for v in cols], n, **kwargs
    )
    retries = metrics.get("modin_tpu.resilience.shuffle.slack_retry", 0) - before
    return np.asarray(k)[:n], [np.asarray(v)[:n] for v in c], np.asarray(counts), np.asarray(pivots), retries


def _port_shuffle(keys, cols, n, **kwargs):
    k, c, counts, pivots = shuffle.range_shuffle(
        torch.as_tensor(keys), [torch.as_tensor(v) for v in cols], n, **kwargs
    )
    return k.numpy(), [v.numpy() for v in c], counts, pivots, shuffle.LAST_RUN["slack_retries"]


def _bitwise(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.kind == "f":
        np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
    else:
        np.testing.assert_array_equal(got, want)


def _against_jax(keys, cols, n, metrics, **kwargs):
    """The port's shuffle, held to the JAX package's at the same mesh."""
    got = _port_shuffle(keys, cols, n, **kwargs)
    want = _jax_shuffle(keys, cols, n, metrics, **kwargs)
    np.testing.assert_array_equal(got[3], want[3])  # pivots
    np.testing.assert_array_equal(got[2], want[2])  # rows a shard
    assert got[4] == want[4]  # slack retries
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)
    return got


def _stable_order(keys: np.ndarray, descending: bool = False) -> np.ndarray:
    """pandas' stable order of a key: NaN last in both directions."""
    nan = np.isnan(keys) if keys.dtype.kind == "f" else np.zeros(len(keys), bool)
    value = np.where(nan, 0, keys)
    return np.lexsort((np.arange(len(keys)), -value if descending else value, nan))


@pytest.mark.parametrize("shards", SHARDS)
def test_range_shuffle_kernel_roundtrip(shards, mesh, jax_metrics):
    mesh(shards)
    rng = np.random.default_rng(5)
    n = 10_000
    keys = rng.uniform(-100, 100, n)
    vals = rng.integers(0, 1000, n)
    k, (v,), counts, pivots, _ = _against_jax(keys, [vals], n, jax_metrics)
    assert int(counts.sum()) == n and len(counts) == shards and len(pivots) == shards - 1
    # every row arrives with its payload, in its key range, in row order
    # within its shard
    order_in, order_out = np.lexsort((vals, keys)), np.lexsort((v, k))
    _bitwise(k[order_out], keys[order_in])
    _bitwise(v[order_out], vals[order_in])
    bucket = np.searchsorted(pivots, keys, side="right")
    _bitwise(k, keys[np.argsort(bucket, kind="stable")])


@pytest.mark.parametrize("shards", SHARDS)
def test_range_shuffle_local_sort_is_global_sort(shards, mesh, jax_metrics):
    mesh(shards)
    rng = np.random.default_rng(6)
    n = 8_001  # uneven on purpose
    keys = rng.normal(0, 50, n)
    rows = np.arange(n)
    k, (r,), _, _, _ = _against_jax(keys, [rows], n, jax_metrics, local_sort=True)
    _bitwise(k, np.sort(keys))
    _bitwise(r, np.argsort(keys, kind="stable"))


@pytest.mark.parametrize("shards", SHARDS)
def test_range_shuffle_skewed_keys_retry(shards, mesh, jax_metrics):
    # 90% identical keys overflow a destination: the slack doubles
    mesh(shards)
    rng = np.random.default_rng(7)
    n = 4_000
    keys = np.where(rng.random(n) < 0.9, 7.0, rng.uniform(0, 1000, n))
    k, (r,), _, _, retries = _against_jax(keys, [np.arange(n)], n, jax_metrics, local_sort=True)
    assert retries >= 1
    _bitwise(k, np.sort(keys))
    _bitwise(r, np.argsort(keys, kind="stable"))


def _frames(data):
    return tpd.DataFrame(data), pandas.DataFrame(data)


def _sorted_equal(md, pdf, *args, **kwargs) -> None:
    """The port's sort against pandas' stable sort."""
    want = pdf.sort_values(*args, kind="stable", **kwargs)
    pandas.testing.assert_frame_equal(tpd.to_pandas(md.sort_values(*args, **kwargs)), want)


@pytest.mark.parametrize("shards", SHARDS)
def test_sort_values_range_partitioning_config(shards, mesh):
    mesh(shards)
    rng = np.random.default_rng(8)
    data = {"a": rng.uniform(-10, 10, 3000), "b": rng.integers(0, 100, 3000)}
    md, pdf = _frames(data)
    shuffle.LAST_RUN.clear()
    with RangePartitioning.context(True):
        _sorted_equal(md, pdf, "a")
        assert shuffle.LAST_RUN["shards"] == shards
        shuffle.LAST_RUN.clear()
        _sorted_equal(md, pdf, "b", ascending=False, ignore_index=True)
        assert shuffle.LAST_RUN["shards"] == shards


@pytest.mark.parametrize("shards", SHARDS)
def test_sort_values_all_equal_keys_completes(shards, mesh):
    # all-equal keys send every row to one shard; the slack retries must
    # still converge at this mesh and sort correctly
    mesh(shards)
    md, pdf = _frames({"a": np.full(2048, 3.0), "b": np.arange(2048.0)})
    shuffle.LAST_RUN.clear()
    with RangePartitioning.context(True):
        _sorted_equal(md, pdf, "a")
    assert shuffle.LAST_RUN["slack_retries"] >= 1


@pytest.mark.parametrize("shards", SHARDS)
def test_sort_values_skew_overflow_falls_back(shards, mesh, monkeypatch):
    # a skew error from the shuffle: the local device sort answers
    mesh(shards)

    def boom(*args, **kwargs):
        raise shuffle.ShuffleSkewError("range_shuffle: pathological key skew")

    monkeypatch.setattr(shuffle, "range_shuffle", boom)
    md, pdf = _frames({"a": np.full(512, 3.0), "b": np.arange(512.0)})
    fallbacks = tres.fallback_count()
    with RangePartitioning.context(True):
        _sorted_equal(md, pdf, "a")
    assert tres.fallback_count() == fallbacks  # a decline, not a device failure


@pytest.mark.parametrize("shards", SHARDS)
def test_range_shuffle_sort_with_nan_and_inf(shards, mesh, jax_metrics):
    mesh(shards)
    rng = np.random.default_rng(9)
    n = 5_000
    keys = rng.uniform(-10, 10, n)
    keys[rng.choice(n, 200, replace=False)] = np.nan
    keys[rng.choice(n, 50, replace=False)] = np.inf
    keys[rng.choice(n, 50, replace=False)] = -np.inf
    k, (r,), _, _, _ = _against_jax(keys, [np.arange(n)], n, jax_metrics, local_sort=True)
    n_nan = int(np.isnan(keys).sum())
    _bitwise(k, np.concatenate([np.sort(keys[~np.isnan(keys)]), [np.nan] * n_nan]))
    _bitwise(r, _stable_order(keys))


@pytest.mark.parametrize("shards", SHARDS)
def test_range_shuffle_descending_nan_last(shards, mesh, jax_metrics):
    mesh(shards)
    rng = np.random.default_rng(10)
    n = 3_000
    keys = rng.uniform(-5, 5, n).round(1)  # ties: descending keeps row order
    keys[rng.choice(n, 100, replace=False)] = np.nan
    k, (r,), _, _, _ = _against_jax(keys, [np.arange(n)], n, jax_metrics, descending=True, local_sort=True)
    # rounding makes -0.0 beside 0.0: equal keys, kept in row order
    assert (np.signbit(keys) & (keys == 0)).any()
    _bitwise(k, keys[_stable_order(keys, descending=True)])
    _bitwise(r, _stable_order(keys, descending=True))


@pytest.mark.parametrize("shards", SHARDS)
def test_range_shuffle_exhausted_slack_raises_skew_error(shards, mesh, jax_metrics):
    # all-equal keys can never fit one destination under a clamped
    # max_slack: both shuffles double, give up and raise the semantic
    # ShuffleSkewError, with the retry and fallback counts
    from modin_tpu.ops.structural import pad_host
    from modin_tpu.parallel.engine import JaxWrapper
    from modin_tpu.parallel.shuffle import ShuffleSkewError as JaxSkewError
    from modin_tpu.parallel.shuffle import range_shuffle as jax_range_shuffle

    mesh(shards)
    n = 2048
    keys = np.full(n, 3.0)
    before = {k: tres.COUNTS.get(k, 0) for k in ("resilience.shuffle.slack_retry", "resilience.shuffle.skew_fallback")}
    with pytest.raises(shuffle.ShuffleSkewError):
        shuffle.range_shuffle(torch.as_tensor(keys), [], n, max_slack=2.0)
    after = {k: tres.COUNTS.get(k, 0) - v for k, v in before.items()}
    with pytest.raises(JaxSkewError):
        jax_range_shuffle(JaxWrapper.put(pad_host(keys)), [], n, max_slack=2.0)
    assert after["resilience.shuffle.skew_fallback"] == 1
    assert after["resilience.shuffle.slack_retry"] == jax_metrics["modin_tpu.resilience.shuffle.slack_retry"] >= 1
    assert jax_metrics["modin_tpu.resilience.shuffle.skew_fallback"] == 1


@pytest.mark.parametrize("shards", SHARDS)
def test_sort_values_real_skew_exhaustion_falls_back(shards, mesh, monkeypatch):
    # the real shuffle runs out of slack (max_slack clamped low) and
    # sort_values answers through the local device sort, counted
    mesh(shards)
    monkeypatch.setattr(shuffle, "range_shuffle", functools.partial(shuffle.range_shuffle, max_slack=2.0))
    md, pdf = _frames({"a": np.full(2048, 3.0), "b": np.arange(2048.0)})
    before = tres.COUNTS.get("resilience.shuffle.skew_fallback", 0)
    with RangePartitioning.context(True):
        _sorted_equal(md, pdf, "a")
        _sorted_equal(md, pdf, "a", ascending=False, ignore_index=True)
    assert tres.COUNTS.get("resilience.shuffle.skew_fallback", 0) - before == 2
