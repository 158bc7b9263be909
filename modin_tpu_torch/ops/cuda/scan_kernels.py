"""CUDA kernel for the window and cumulative hot paths: deterministic scans.

``scan``: one kernel template (``csrc/scan.cu``) over a combine operator,
with these modes:

- ``"linear"``: y_t = a_t * y_{t-1} + b_t with y_{-1} = 0 over float64 ``a``
  and ``b`` (the ewm recurrences).  It replaces the JAX package's
  ``modin_tpu/ops/window.py::_linear_scan``, an XLA blocked associative scan;
- ``"seg_add"``, ``"seg_mul"``, ``"seg_max"``, ``"seg_min"``: cumulative
  add/mul/max/min of int64 or float64 values that restarts wherever the
  int64 group ``codes`` (sorted, so each group is one run) change, and, with
  ``width=w``, at every block of w rows (rows ``[k*w, (k+1)*w)``, the van
  Herk blocks of the rolling windows).  It replaces the segmented scan of
  ``modin_tpu/ops/groupby.py::_jit_grouped_cum``.  int64 add and mul wrap
  as numpy's do; max and min take NaN-free values.

Every mode takes ``reverse=True``: the scan runs from the last row to the
first (the suffix scans of van Herk), with no flipped copies.

The kernel makes one pass (24 B a row, 16 B without codes): persistent
blocks take tiles by ticket, and a tile's carry folds the totals of recent
tiles and Fenwick partials of earlier ones in an order fixed by its ticket
alone (no float atomics), so a float result repeats bit for bit and passes
through at most ceil(log2 tiles) + 56 combines.

On a CUDA tensor :func:`scan` launches the kernel (building it on first
use) and raises when it cannot; on a CPU tensor it computes the plain
version, :func:`scan_plain`, a doubling (Hillis-Steele) scan with the same
combine.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

LAUNCHES = 0

MODES = ("linear", "seg_add", "seg_mul", "seg_max", "seg_min")
_MODE_CODE = {"linear": 0, "seg_add": 1, "seg_mul": 2, "seg_max": 3, "seg_min": 4}
_DTYPE_CODE = {torch.int64: 0, torch.float64: 1}

_LIB_NAME = "scan"
_bound = False


def _lib() -> ctypes.CDLL:
    global _bound
    from modin_tpu_torch.ops.cuda.build import load

    lib = load(_LIB_NAME)
    if not _bound:
        lib.scan_run.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.scan_run.restype = ctypes.c_int
        lib.scan_scratch_bytes.argtypes = [ctypes.c_int64]
        lib.scan_scratch_bytes.restype = ctypes.c_int64
        lib.scan_tile_rows.argtypes = []
        lib.scan_tile_rows.restype = ctypes.c_int64
        lib.scan_error_string.argtypes = [ctypes.c_int]
        lib.scan_error_string.restype = ctypes.c_char_p
        _bound = True
    return lib


def _seg_combine(op: str):
    if op == "seg_add":
        return torch.add
    if op == "seg_mul":
        return torch.mul
    if op == "seg_max":
        return torch.maximum
    return torch.minimum


def _starts(n: int, codes: Optional[torch.Tensor], width: int, reverse: bool,
            device) -> torch.Tensor:
    """Segment starts in scan order: the first row scanned, a change of the
    code from the row scanned before, and a change of the block of
    ``width`` rows (blocks are fixed row ranges, in either direction)."""
    f = torch.zeros(n, dtype=torch.bool, device=device)
    if n == 0:
        return f
    f[0] = True
    if codes is not None and n > 1:
        c = codes.flip(0) if reverse else codes
        f[1:] |= c[1:] != c[:-1]
    if width and n > 1:
        rows = torch.arange(n, device=device)
        block = (rows.flip(0) if reverse else rows) // width
        f[1:] |= block[1:] != block[:-1]
    return f


def scan_plain(mode: str, x: torch.Tensor, aux: Optional[torch.Tensor] = None, *,
               width: int = 0, reverse: bool = False) -> torch.Tensor:
    """Plain torch version of :func:`scan`: ceil(log2 n) doubling steps, each
    combining every element with the one 2^k before it (in scan order)."""
    _check_options(mode, width)
    n = x.shape[0]
    d = 1
    if mode == "linear":
        a, b = (x.flip(0), aux.flip(0)) if reverse else (x.clone(), aux.clone())
        while d < n:
            # (a[i-d], b[i-d]) then (a[i], b[i])
            b_new = b.clone()
            b_new[d:] = a[d:] * b[:-d] + b[d:]
            a_new = a.clone()
            a_new[d:] = a[:-d] * a[d:]
            a, b = a_new, b_new
            d *= 2
        return b.flip(0) if reverse else b
    combine = _seg_combine(mode)
    v = x.flip(0) if reverse else x.clone()
    f = _starts(n, aux, width, reverse, x.device)
    while d < n:
        v_new = v.clone()
        v_new[d:] = torch.where(f[d:], v[d:], combine(v[:-d], v[d:]))
        f_new = f.clone()
        f_new[d:] = f[:-d] | f[d:]
        v, f = v_new, f_new
        d *= 2
    return v.flip(0) if reverse else v


def _check_options(mode: str, width: int) -> None:
    if mode not in _MODE_CODE:
        raise ValueError(f"scan mode must be one of {MODES}, got {mode!r}")
    if width < 0:
        raise ValueError(f"scan: width must be >= 0, got {width}")
    if width and mode == "linear":
        raise ValueError("scan: the linear mode takes no block width")


def _check(name: str, t: torch.Tensor, dtype: Optional[torch.dtype], n: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"scan: {name} is on {t.device}, not on a CUDA device")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"scan: {name} must be {dtype}, got {t.dtype}")
    if t.dim() != 1 or t.shape[0] != n:
        raise ValueError(f"scan: {name} must be 1-D of length {n}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"scan: {name} must be contiguous")


def scan(mode: str, x: torch.Tensor, aux: Optional[torch.Tensor] = None, *,
         width: int = 0, reverse: bool = False) -> torch.Tensor:
    """Inclusive scan of ``x``: for ``"linear"``, ``x`` is ``a`` and ``aux``
    is ``b`` (float64 both); for the ``seg_*`` modes, ``x`` holds int64 or
    float64 values and ``aux`` the sorted int64 group codes, or None.  A
    segment of a ``seg_*`` mode also starts at every block of ``width``
    rows (rows ``[k*width, (k+1)*width)``; 0: no blocks).  ``reverse``
    scans from the last row to the first.  Returns a new tensor of ``x``'s
    dtype."""
    global LAUNCHES
    width, reverse = int(width), bool(reverse)
    _check_options(mode, width)
    if mode == "linear" and aux is None:
        raise ValueError("scan: the linear mode takes a and b")
    if x.device.type == "cpu":
        return scan_plain(mode, x, aux, width=width, reverse=reverse)
    n = x.shape[0] if x.dim() == 1 else -1
    if mode == "linear":
        _check("a", x, torch.float64, n)
        _check("b", aux, torch.float64, n)
    else:
        if x.dtype not in _DTYPE_CODE:
            raise ValueError(f"scan: values must be int64 or float64, got {x.dtype}")
        _check("values", x, None, n)
        if aux is not None:
            _check("codes", aux, torch.int64, n)
    if aux is not None and aux.device != x.device:
        raise ValueError("scan: inputs lie on different devices")
    y = torch.empty_like(x)
    if n == 0:
        return y
    lib = _lib()
    scratch = torch.empty(int(lib.scan_scratch_bytes(n)), dtype=torch.uint8, device=x.device)
    b_ptr = aux.data_ptr() if mode == "linear" else None
    codes_ptr = aux.data_ptr() if (mode != "linear" and aux is not None) else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.scan_run(
            _MODE_CODE[mode], _DTYPE_CODE[x.dtype], ctypes.c_void_p(x.data_ptr()),
            ctypes.c_void_p(b_ptr), ctypes.c_void_p(codes_ptr),
            ctypes.c_void_p(y.data_ptr()), n, width, int(reverse),
            ctypes.c_void_p(scratch.data_ptr()), ctypes.c_void_p(stream),
        )
    if err != 0:
        msg = lib.scan_error_string(int(err)).decode(errors="replace")
        raise RuntimeError(f"scan kernel ({mode}): launch failed with CUDA error {err}: {msg}")
    LAUNCHES += 1
    return y
