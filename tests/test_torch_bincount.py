"""The torch port's group-code histogram held against the JAX package.

``bincount_plain`` (the CPU form of the CUDA ``bincount`` kernel) must equal
the Pallas kernel it replaces, run in interpret mode on the CPU, and above
the Pallas kernel's 512-slot cap the XLA scatter histogram.  Counts are
integers: equality is exact.  The CUDA kernel itself runs only on the card
(``chip_smoke.py`` holds it against ``bincount_plain`` there).
"""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from modin_tpu.ops.groupby import _jit_scatter_counts
from modin_tpu.ops.pallas.groupby_kernels import pallas_bincount

import modin_tpu_torch
from modin_tpu_torch.ops.cuda import build
from modin_tpu_torch.ops.cuda import groupby_kernels as gk


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


def _codes(seed: int, n: int, width: int) -> np.ndarray:
    # codes in [0, width]: the top value is the overflow bucket
    return np.random.default_rng(seed).integers(0, width + 1, n)


@pytest.mark.parametrize("n,width", [(777, 3), (50_000, 100), (12_345, 512)])
def test_plain_matches_pallas_interpret(n, width):
    codes = _codes(n, n, width)
    want = np.asarray(pallas_bincount(jnp.asarray(codes), width, interpret=True))
    got = gk.bincount_plain(torch.as_tensor(codes), width).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64


@pytest.mark.parametrize("n,width", [(5_000, 513), (40_000, 10_000), (3_000, 70_000)])
def test_plain_matches_scatter_above_pallas_cap(n, width):
    codes = _codes(width, n, width)
    want = np.asarray(_jit_scatter_counts(width)(jnp.asarray(codes)))
    got = gk.bincount_plain(torch.as_tensor(codes), width).numpy()
    np.testing.assert_array_equal(got, want)


def test_wrapper_on_cpu_tensor_is_plain_and_launches_nothing():
    codes = torch.as_tensor(_codes(3, 10_000, 100))
    before = gk.LAUNCHES
    np.testing.assert_array_equal(
        gk.bincount(codes, 100).numpy(), gk.bincount_plain(codes, 100).numpy()
    )
    assert gk.LAUNCHES == before


def test_out_of_range_codes_are_dropped():
    codes = torch.tensor([-5, -1, 0, 0, 2, 3, 4, 100, 2], dtype=torch.int64)
    np.testing.assert_array_equal(gk.bincount(codes, 3).numpy(), [2, 0, 2])


@pytest.mark.parametrize("n,width", [(0, 5), (10, 0), (0, 0)])
def test_empty_inputs(n, width):
    out = gk.bincount(torch.zeros(n, dtype=torch.int64), width)
    assert out.shape == (width,) and out.dtype == torch.int64
    assert int(out.sum()) == 0


def test_negative_width_raises():
    with pytest.raises(ValueError):
        gk.bincount(torch.zeros(3, dtype=torch.int64), -1)


def test_build_is_keyed_by_source_and_lands_in_build_dir():
    path = build.library_path("bincount")
    assert path == build.library_path("bincount")
    assert path.startswith(build.BUILD_DIR)
    assert path.endswith(".so")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()
