"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so one build takes seconds.  Builds land in
``modin_tpu_torch/_build/`` (git-ignored) under a file name that carries a
hash of the source and the flags: editing a source rebuilds it, and an
unchanged one is loaded from the earlier build.  Nothing is built at import
time; the first launch of a kernel builds it, and :func:`build_all` builds
every source at once (one ``nvcc`` process per source, all started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "_build",
)
SOURCES = ("bincount", "scan", "fused", "groupagg")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# compiler output (ptxas register/shared-memory report) of builds made by
# this process, by source name
BUILD_LOGS: Dict[str, str] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's usual home.  Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels of modin_tpu_torch cannot be built"
    )


def library_path(name: str) -> str:
    """Where the build of ``csrc/<name>.cu`` goes, keyed by content."""
    with open(os.path.join(_CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}_{digest[:16]}.so")


def _start(name: str) -> Tuple[str, str, subprocess.Popen]:
    out = library_path(name)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return out, tmp, proc


def _finish(name: str, out: str, tmp: str, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed to build csrc/{name}.cu (exit {proc.returncode}):\n{log}"
        )
    os.replace(tmp, out)
    BUILD_LOGS[name] = log


def build_all(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Build every source that has no current build, all in parallel;
    returns ``{name: library path}``.  Raises with the compiler's output
    when a build fails."""
    names = list(names or SOURCES)
    os.makedirs(BUILD_DIR, exist_ok=True)
    started = []
    paths = {}
    for name in names:
        path = library_path(name)
        paths[name] = path
        if not os.path.exists(path):
            started.append((name, *_start(name)))
    errors = []
    for name, out, tmp, proc in started:
        try:
            _finish(name, out, tmp, proc)
        except RuntimeError as err:
            errors.append(str(err))
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all([name])[name])
            _loaded[name] = lib
    return lib
