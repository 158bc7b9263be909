"""The roofline's operation-rate probe: a float64 FMA loop on the card.

``csrc/peaks.cu`` is built like the port's kernels (``build.py``) but is no
port of a TPU kernel and runs on no query's path: the cost layer
(``observability/costs.py::measure_card_peaks``) launches it once to
measure the card's float64 rate.
"""

from __future__ import annotations

import ctypes

import torch

_LIB_NAME = "peaks"
_bound = False

#: FMA chains a thread runs (``kChains`` of the source)
CHAINS = 8


def _lib() -> ctypes.CDLL:
    global _bound
    from modin_tpu_torch.ops.cuda.build import load

    lib = load(_LIB_NAME)
    if not _bound:
        lib.peaks_fma_f64.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.peaks_fma_f64.restype = ctypes.c_int
        lib.peaks_fma_chains.argtypes = []
        lib.peaks_fma_chains.restype = ctypes.c_int
        lib.peaks_error_string.argtypes = [ctypes.c_int]
        lib.peaks_error_string.restype = ctypes.c_char_p
        _bound = True
    return lib


def fma_loop(out: torch.Tensor, iters: int, threads: int) -> None:
    """Launch the loop: one thread per element of the float64 ``out``
    (a multiple of ``threads``), ``iters`` steps of every chain."""
    if out.device.type != "cuda" or out.dtype != torch.float64 or out.numel() % threads:
        raise ValueError("fma_loop takes a CUDA float64 tensor of a multiple of `threads` elements")
    lib = _lib()
    if lib.peaks_fma_chains() != CHAINS:
        raise RuntimeError("peaks.cu runs another number of FMA chains than peaks_kernels.CHAINS")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.peaks_fma_f64(ctypes.c_void_p(out.data_ptr()), out.numel() // threads, threads, int(iters),
                                ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.peaks_error_string(int(err)).decode(errors="replace")
        raise RuntimeError(f"peaks kernel: launch failed with CUDA error {err}: {msg}")
