"""CUDA kernels for the groupby hot path.

``bincount``: the histogram behind int-key factorization (direct-range
coding), multi-key composite codes and the ``size`` aggregation.  It replaces
``modin_tpu/ops/pallas/groupby_kernels.py::_build_bincount`` (the one-hot VPU
kernel of the TPU) with ``csrc/bincount.cu``: a shared-memory histogram per
block up to :func:`smem_slots` slots, global atomics above — see the source
note for the bound and the design.

On a CUDA tensor :func:`bincount` launches the kernel (building it on first
use) and raises when it cannot; on a CPU tensor it computes the plain
version, :func:`bincount_plain`.  ``LAUNCHES`` counts kernel launches,
``ROWS`` the rows they read.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = 0
#: rows the launches read (the codes)
ROWS = 0

_LIB_NAME = "bincount"
_bound = False


def _lib() -> ctypes.CDLL:
    global _bound
    from modin_tpu_torch.ops.cuda.build import load

    lib = load(_LIB_NAME)
    if not _bound:
        lib.bincount_int64.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.bincount_int64.restype = ctypes.c_int
        lib.bincount_smem_slots.argtypes = []
        lib.bincount_smem_slots.restype = ctypes.c_int64
        lib.bincount_error_string.argtypes = [ctypes.c_int]
        lib.bincount_error_string.restype = ctypes.c_char_p
        _bound = True
    return lib


def _raise_cuda(lib: ctypes.CDLL, err: int, what: str) -> None:
    msg = lib.bincount_error_string(int(err)).decode(errors="replace")
    raise RuntimeError(f"bincount kernel: {what} failed with CUDA error {err}: {msg}")


def smem_slots(device: torch.device) -> int:
    """Widest histogram the shared-memory mode takes on ``device``."""
    lib = _lib()
    with torch.cuda.device(device):
        slots = int(lib.bincount_smem_slots())
    if slots < 0:
        _raise_cuda(lib, -slots, "reading the device attributes")
    return slots


def bincount_plain(codes: torch.Tensor, width: int) -> torch.Tensor:
    """Plain torch version: int64 counts of each code in ``[0, width)``;
    every other code is dropped (routed to a spare slot that is cut off)."""
    width = int(width)
    ids = torch.where((codes >= 0) & (codes < width), codes, width)
    counts = torch.zeros(width + 1, dtype=torch.int64, device=codes.device)
    counts.index_add_(0, ids, torch.ones_like(ids))
    return counts[:width]


def bincount(codes: torch.Tensor, width: int) -> torch.Tensor:
    """Counts per group code: int64 ``[width]``; codes outside
    ``[0, width)`` (the overflow/NaN bucket) are dropped."""
    global LAUNCHES, ROWS
    width = int(width)
    if width < 0:
        raise ValueError(f"bincount width must be >= 0, got {width}")
    if codes.device.type == "cpu":
        return bincount_plain(codes, width)
    if codes.device.type != "cuda":
        raise ValueError(f"bincount: unsupported device {codes.device}")
    if codes.dtype != torch.int64 or codes.dim() != 1:
        raise ValueError(
            f"bincount takes 1-D int64 codes, got {codes.dtype} of shape "
            f"{tuple(codes.shape)}"
        )
    if not codes.is_contiguous():
        raise ValueError("bincount takes contiguous codes")
    counts = torch.zeros(width, dtype=torch.int64, device=codes.device)
    n = codes.numel()
    if n == 0 or width == 0:
        return counts
    lib = _lib()
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = lib.bincount_int64(
            ctypes.c_void_p(codes.data_ptr()), n, width,
            ctypes.c_void_p(counts.data_ptr()), ctypes.c_void_p(stream),
        )
    if err != 0:
        _raise_cuda(lib, err, "launch")
    LAUNCHES += 1
    ROWS += n
    return counts
