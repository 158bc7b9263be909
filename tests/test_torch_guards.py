"""Guards of the torch port's boundaries.

- No module of ``modin_tpu_torch`` imports ``jax`` or ``modin_tpu`` (an AST
  scan), and importing ``modin_tpu_torch.pandas`` leaves both out of
  ``sys.modules``.
- The layers under the pandas API (``core``, ``ops``) import and run
  without pandas.
- The device is explicit: left at the ``"cuda"`` default without a card,
  the entry points raise instead of carrying on on the CPU.
"""

import ast
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pandas
import pytest
import torch

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch.config import Device
from modin_tpu_torch.core.storage_formats.torch.query_compiler import (
    TorchQueryCompiler,
)

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = REPO_ROOT / "modin_tpu_torch"


@pytest.fixture(autouse=True, scope="module")
def _join_jax_watchdog_threads():
    """Let the JAX package's per-fetch watchdog threads end before the next
    test file runs in this worker (``tests/test_watch.py`` counts threads)."""
    yield
    for t in threading.enumerate():
        if t.name.startswith("modin-tpu-watchdog"):
            t.join(timeout=5)


def _forbidden(module: str) -> bool:
    return module in ("jax", "modin_tpu") or module.startswith(("jax.", "modin_tpu."))


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


# the modules of the third slice: the base compiler that defaults to
# pandas, the host-only compiler, the default methods, the API surface
SLICE3_MODULES = [
    "core/dataframe/algebra/default2pandas/default.py",
    "core/storage_formats/base/query_compiler.py",
    "core/storage_formats/native/query_compiler.py",
    "error_message.py",
    "ops/sorted_cache.py",
    "pandas/indexing.py",
    "pandas/plotting.py",
    "pandas/series_utils.py",
]


# the modules of the remaining IO and the interchange producer: the JSON,
# fixed-width, SQL and HDF dispatchers, the connection descriptor, the xlsx
# codec (the port's copies of pure-Python JAX-package modules), the
# producer and the consumer's namespace
SLICE13_MODULES = [
    "core/dataframe/torch/interchange/__init__.py",
    "core/dataframe/torch/interchange/dataframe.py",
    "core/io/column_stores/hdf_dispatcher.py",
    "core/io/excel/__init__.py",
    "core/io/excel/xlsx.py",
    "core/io/sql/__init__.py",
    "core/io/sql/sql_dispatcher.py",
    "core/io/text/fwf_dispatcher.py",
    "core/io/text/json_dispatcher.py",
    "db_conn.py",
    "pandas/api/__init__.py",
    "pandas/api/interchange/__init__.py",
]

#: the routing and memory modules (router, calibration store, ledgers,
#: optimizer), scanned like every other module
SLICE14_MODULES = [
    "core/memory.py",
    "ops/calibration.py",
    "ops/router.py",
    "plan/optimizer.py",
]


#: the derived-artifact cache, scanned like every other module
SLICE15_MODULES = [
    "views/__init__.py",
    "views/groupby_cache.py",
    "views/incremental.py",
    "views/reduce_cache.py",
    "views/registry.py",
]

SLICE16_MODULES = [
    "core/execution/recovery.py",
    "core/execution/resilience.py",
    "testing/__init__.py",
    "testing/faults.py",
]


#: continuous ingestion and durability with the utils they need, scanned
#: like every other module
SLICE21_MODULES = [
    "durability/__init__.py",
    "durability/checkpoint.py",
    "durability/errors.py",
    "durability/manager.py",
    "durability/wal.py",
    "ingest/__init__.py",
    "ingest/errors.py",
    "ingest/feed.py",
    "ingest/live.py",
    "utils/__init__.py",
    "utils/atomic_io.py",
    "utils/file_leaks.py",
]


#: the replicated serving fleet, the view exporter and the live telemetry
#: service, scanned like every other module
SLICE22_MODULES = [
    "fleet/__init__.py",
    "fleet/coordinator.py",
    "fleet/queries.py",
    "fleet/replica.py",
    "fleet/wire.py",
    "observability/watch/__init__.py",
    "observability/watch/httpd.py",
    "observability/watch/slo.py",
    "observability/watch/timeseries.py",
    "observability/watch/tripwires.py",
    "views/exporter.py",
]


def test_package_has_modules_to_scan():
    assert len(list(PACKAGE.rglob("*.py"))) >= 30
    scanned = {str(p.relative_to(PACKAGE)) for p in PACKAGE.rglob("*.py")}
    assert set(SLICE3_MODULES) <= scanned
    assert set(SLICE13_MODULES) <= scanned
    assert set(SLICE14_MODULES) <= scanned
    assert set(SLICE15_MODULES) <= scanned
    assert set(SLICE16_MODULES) <= scanned
    assert set(SLICE21_MODULES) <= scanned
    assert set(SLICE22_MODULES) <= scanned


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(REPO_ROOT)) for p in PACKAGE.rglob("*.py")),
)
def test_no_jax_or_modin_tpu_imports(path):
    bad = [m for m in _imported_modules(REPO_ROOT / path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def _run_python(code: str, env_extra=None) -> subprocess.CompletedProcess:
    import os

    env = dict(os.environ)
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_import_leaves_jax_and_modin_tpu_out():
    proc = _run_python(
        "import sys, modin_tpu_torch.pandas\n"
        "bad = [m for m in sys.modules if m in ('jax', 'modin_tpu') "
        "or m.startswith(('jax.', 'modin_tpu.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _import_without_jax_or_modin_tpu(modules) -> subprocess.CompletedProcess:
    names = [
        "modin_tpu_torch." + m[: -len(".py")].replace("/__init__", "").replace("/", ".")
        for m in modules
    ]
    return _run_python(
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'modin_tpu') "
        "or m.startswith(('jax.', 'modin_tpu.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )


def test_slice13_modules_import_without_jax_or_modin_tpu():
    proc = _import_without_jax_or_modin_tpu(SLICE13_MODULES)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_slice15_modules_import_without_jax_or_modin_tpu():
    proc = _import_without_jax_or_modin_tpu(SLICE15_MODULES)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_slice16_modules_import_without_jax_or_modin_tpu():
    proc = _import_without_jax_or_modin_tpu(SLICE16_MODULES)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_slice21_modules_import_without_jax_or_modin_tpu():
    proc = _import_without_jax_or_modin_tpu(SLICE21_MODULES)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_slice22_modules_import_without_jax_or_modin_tpu():
    proc = _import_without_jax_or_modin_tpu(SLICE22_MODULES)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_slice3_modules_import_without_jax_or_modin_tpu():
    proc = _import_without_jax_or_modin_tpu(SLICE3_MODULES)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_core_and_ops_run_without_pandas():
    # pandas made unimportable: the frame, the compiler and the kernels
    # still build a frame from numpy columns and group it
    proc = _run_python(
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "import numpy as np, modin_tpu_torch\n"
        "modin_tpu_torch.set_device('cpu')\n"
        "from modin_tpu_torch.core.storage_formats.torch.query_compiler import TorchQueryCompiler\n"
        "qc = TorchQueryCompiler.from_numpy_columns({'k': np.array([2, 1, 2]), 'v': np.array([1., 2., 3.])})\n"
        "r = qc.groupby_agg(['k'], 'sum', groupby_kwargs={}, agg_kwargs={}, drop=True)\n"
        "col = r._modin_frame.get_column(0).to_numpy()\n"
        "assert col.tolist() == [2.0, 4.0], col\n"
        "assert r._modin_frame._index.arrays[0].tolist() == [1, 2]\n"
        "s = qc.add(1).sum()._modin_frame.get_column(0).to_numpy()\n"
        "assert s.tolist() == [8.0, 9.0], s\n"
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_relational_core_runs_without_pandas():
    # filter, sort, concat, isin and merge below the pandas API, pandas
    # unimportable: row labels stay lazy, nothing asks pandas for them
    proc = _run_python(
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "import numpy as np, modin_tpu_torch\n"
        "modin_tpu_torch.set_device('cpu')\n"
        "from modin_tpu_torch.core.storage_formats.torch.query_compiler import TorchQueryCompiler\n"
        "qc = TorchQueryCompiler.from_numpy_columns({'k': np.array([3, 1, 2, 1]), 'v': np.array([1., 2., 3., 4.])})\n"
        "col = lambda q, i: q._modin_frame.get_column(i).to_numpy().tolist()\n"
        "f = qc.getitem_array(qc.gt(1).getitem_column_array(['k']))\n"
        "assert col(f, 1) == [1.0, 3.0], col(f, 1)\n"
        "s = qc.sort_rows_by_column_values(['k', 'v'], ascending=[True, False])\n"
        "assert col(s, 1) == [4.0, 2.0, 3.0, 1.0], col(s, 1)\n"
        "c = qc.concat(0, [qc])\n"
        "assert col(c, 0) == [3, 1, 2, 1] * 2\n"
        "assert col(qc.isin([1]), 0) == [False, True, False, True]\n"
        "m = qc.merge(qc, on='k', how='inner')\n"
        "assert col(m, 0) == [3, 1, 1, 2, 1, 1], col(m, 0)\n"
        "assert col(m, 2) == [1.0, 2.0, 4.0, 3.0, 2.0, 4.0], col(m, 2)\n"
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture
def cuda_default():
    Device.put("cuda")
    try:
        yield
    finally:
        Device.put("cpu")


ENTRY_POINTS = {
    "DataFrame": lambda: tpd.DataFrame({"a": [1, 2]}),
    "Series": lambda: tpd.Series([1, 2]),
    "from_pandas": lambda: tpd.from_pandas(pandas.DataFrame({"a": [1, 2]})),
    "from_numpy_columns": lambda: TorchQueryCompiler.from_numpy_columns(
        {"a": np.array([1, 2])}
    ),
    "get_device": modin_tpu_torch.get_device,
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_cuda_default_without_card_raises(entry, cuda_default):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points take it")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ENTRY_POINTS[entry]()


def test_device_setting_is_validated():
    with pytest.raises(ValueError):
        Device.put("tpu")
    assert Device.get() in Device.choices


def test_cpu_device_when_asked():
    modin_tpu_torch.set_device("cpu")
    df = tpd.DataFrame({"a": [1, 2]})
    assert df._query_compiler._modin_frame.get_column(0).data.device.type == "cpu"
