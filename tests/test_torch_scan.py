"""The torch port's scan kernel, held by its plain version on the CPU.

``scan_plain`` (the CPU form of the CUDA ``scan`` kernel, a doubling
Hillis-Steele scan) must equal a sequential numpy loop in every mode, and
the JAX package's own scans: ``modin_tpu.ops.window._linear_scan`` for the
linear mode and ``modin_tpu.ops.groupby.groupby_cumulative`` for the
segmented ones.  Tolerances: int64 results exactly, their wraparound
included (modular add and multiply do not depend on order); float64 max
and min exactly; float64 sums and linear recurrences to ``rtol=1e-12``
against the loop and JAX (another order of the same additions, at most a
few thousand terms), with ``atol=1e-12`` where cancellation takes a sum to
zero.  The CUDA kernel itself runs only on the card (``chip_smoke.py``
holds it against ``scan_plain`` there at 1e8 rows).
"""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from modin_tpu.ops.groupby import groupby_cumulative as jax_groupby_cumulative
from modin_tpu.ops.window import _linear_scan as jax_linear_scan

import modin_tpu_torch
from modin_tpu_torch.ops.cuda import build
from modin_tpu_torch.ops.cuda import scan_kernels as sk

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


def _loop_linear(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = np.empty_like(b)
    y = 0.0
    for i in range(len(a)):
        y = a[i] * y + b[i]
        out[i] = y
    return out


_NP_OPS = {
    "seg_add": lambda u, v: u + v,
    "seg_mul": lambda u, v: u * v,
    "seg_max": max,
    "seg_min": min,
}


def _loop_segmented(mode: str, x: np.ndarray, codes) -> np.ndarray:
    out = np.empty_like(x)
    fn = _NP_OPS[mode]
    with np.errstate(over="ignore"):
        for i in range(len(x)):
            start = i == 0 or (codes is not None and codes[i] != codes[i - 1])
            out[i] = x[i] if start else fn(out[i - 1], x[i])
    return out


def _sorted_codes(rng, n: int, groups: int) -> np.ndarray:
    return np.sort(rng.integers(0, groups, n))


@pytest.mark.parametrize("n", [1, 2, 3, 17, 1000, 4097])
def test_linear_plain_matches_loop_and_jax(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.0, 1.0, n)
    b = rng.normal(0, 10, n)
    got = sk.scan_plain("linear", torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, _loop_linear(a, b), rtol=RTOL, atol=ATOL)
    from_jax = np.asarray(jax_linear_scan(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, from_jax, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["seg_add", "seg_mul", "seg_max", "seg_min"])
@pytest.mark.parametrize("groups", [None, 1, 7, 300])
@pytest.mark.parametrize("dtype", ["int64", "float64"])
def test_segmented_plain_matches_loop(mode, groups, dtype):
    n = 2000
    rng = np.random.default_rng(7 if groups is None else groups)
    if dtype == "int64":
        # full-range values: sums and products wrap as numpy's do
        x = rng.integers(-(2**62), 2**62, n)
    elif mode == "seg_mul":
        x = rng.uniform(0.5, 1.5, n)
    else:
        x = rng.normal(0, 100, n)
    codes = None if groups is None else _sorted_codes(rng, n, groups)
    got = sk.scan_plain(mode, torch.as_tensor(x), None if codes is None else torch.as_tensor(codes)).numpy()
    want = _loop_segmented(mode, x, codes)
    if dtype == "int64" or mode in ("seg_max", "seg_min"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _loop_blocked(mode: str, x: np.ndarray, codes, width: int, reverse: bool) -> np.ndarray:
    """The segmented scan as a loop over rows in scan order: a segment
    starts at the first row scanned, where the code differs from the row
    scanned before, and where the block of ``width`` rows changes."""
    out = np.empty_like(x)
    fn = _NP_OPS[mode]
    order = range(len(x) - 1, -1, -1) if reverse else range(len(x))
    prev = None
    with np.errstate(over="ignore"):
        for j in order:
            start = prev is None
            if not start and codes is not None:
                start = codes[j] != codes[prev]
            if not start and width:
                start = j // width != prev // width
            out[j] = x[j] if start else fn(out[prev], x[j])
            prev = j
    return out


@pytest.mark.parametrize("mode", ["seg_add", "seg_mul", "seg_max", "seg_min"])
@pytest.mark.parametrize("dtype", ["int64", "float64"])
@pytest.mark.parametrize("width", [1, 2, 3, 7, 53, 58])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("groups", [None, 5])
def test_blocked_and_reverse_plain_matches_loop(mode, dtype, width, reverse, groups):
    n = 53  # a multiple of none of the widths but 1 and 53
    rng = np.random.default_rng(width * 7 + reverse)
    if dtype == "int64":
        x = rng.integers(-(2**62), 2**62, n)
    elif mode == "seg_mul":
        x = rng.uniform(0.5, 1.5, n)
    else:
        x = rng.normal(0, 100, n)
    codes = None if groups is None else _sorted_codes(rng, n, groups)
    got = sk.scan_plain(mode, torch.as_tensor(x), None if codes is None else torch.as_tensor(codes),
                        width=width, reverse=reverse).numpy()
    want = _loop_blocked(mode, x, codes, width, reverse)
    if dtype == "int64" or mode in ("seg_max", "seg_min"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the wrapper on a CPU tensor is the plain version
    again = sk.scan(mode, torch.as_tensor(x), None if codes is None else torch.as_tensor(codes),
                    width=width, reverse=reverse).numpy()
    np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("n", [1, 2, 17, 1000])
def test_linear_reverse_matches_loop(n):
    rng = np.random.default_rng(n + 1)
    a = rng.uniform(0.0, 1.0, n)
    b = rng.normal(0, 10, n)
    got = sk.scan_plain("linear", torch.as_tensor(a), torch.as_tensor(b), reverse=True).numpy()
    want = _loop_linear(a[::-1], b[::-1])[::-1]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError):
        sk.scan("linear", torch.as_tensor(a), torch.as_tensor(b), width=3)
    with pytest.raises(ValueError):
        sk.scan("seg_add", torch.as_tensor(b), width=-1)


def test_int_wraparound_is_numpys():
    x = np.array([2**62, 2**62, 2**62, -5, 3], dtype=np.int64)
    got = sk.scan_plain("seg_add", torch.as_tensor(x)).numpy()
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal(got, np.cumsum(x))
    got = sk.scan_plain("seg_mul", torch.as_tensor(np.array([2**40, 2**40, 3], dtype=np.int64))).numpy()
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal(got, np.cumprod(np.array([2**40, 2**40, 3], dtype=np.int64)))


@pytest.mark.parametrize("op,mode", [("cumsum", "seg_add"), ("cumprod", "seg_mul"),
                                     ("cummax", "seg_max"), ("cummin", "seg_min")])
@pytest.mark.parametrize("dtype", ["int64", "float64"])
def test_segmented_plain_matches_jax_grouped_cumulative(op, mode, dtype):
    n = 3000
    rng = np.random.default_rng(11)
    codes = _sorted_codes(rng, n, 40)
    if dtype == "int64":
        x = rng.integers(-3, 4, n) if op == "cumprod" else rng.integers(-1000, 1000, n)
    else:
        x = rng.uniform(0.9, 1.1, n) if op == "cumprod" else rng.normal(0, 10, n)
    from_jax = np.asarray(jax_groupby_cumulative(op, [jnp.asarray(x)], jnp.asarray(codes))[0])
    got = sk.scan_plain(mode, torch.as_tensor(x), torch.as_tensor(codes)).numpy()
    if dtype == "int64" or mode in ("seg_max", "seg_min"):
        np.testing.assert_array_equal(got, from_jax)
    else:
        np.testing.assert_allclose(got, from_jax, rtol=RTOL, atol=ATOL)


def test_wrapper_on_cpu_tensor_is_plain_and_launches_nothing():
    rng = np.random.default_rng(3)
    a = torch.as_tensor(rng.uniform(0, 1, 500))
    b = torch.as_tensor(rng.normal(0, 1, 500))
    codes = torch.as_tensor(_sorted_codes(rng, 500, 9))
    before = sk.LAUNCHES
    assert torch.equal(sk.scan("linear", a, b), sk.scan_plain("linear", a, b))
    assert torch.equal(sk.scan("seg_add", b, codes), sk.scan_plain("seg_add", b, codes))
    assert torch.equal(sk.scan("seg_max", b), sk.scan_plain("seg_max", b))
    assert sk.LAUNCHES == before


def test_empty_and_bad_arguments():
    empty = torch.zeros(0, dtype=torch.float64)
    assert sk.scan("linear", empty, empty).shape == (0,)
    assert sk.scan("seg_add", empty).shape == (0,)
    with pytest.raises(ValueError):
        sk.scan("seg_sum", empty)
    with pytest.raises(ValueError):
        sk.scan("linear", empty)


def test_scan_source_is_built_with_the_others():
    assert "scan" in build.SOURCES
    path = build.library_path("scan")
    assert path.startswith(build.BUILD_DIR) and path == build.library_path("scan")
