"""Small shared helpers of the torch port (no pandas, no device work)."""

from __future__ import annotations

import numpy as np
import torch

# label of the single column of a frame that stands for a Series
MODIN_UNNAMED_SERIES_LABEL = "__reduced__"

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}
_TORCH_TO_NP = {t: n for n, t in _NP_TO_TORCH.items()}


def torch_dtype(dtype: np.dtype) -> torch.dtype:
    """The torch dtype holding numpy ``dtype`` (KeyError when none does)."""
    return _NP_TO_TORCH[np.dtype(dtype)]


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of torch ``dtype``."""
    return _TORCH_TO_NP[dtype]


def has_torch_dtype(dtype: np.dtype) -> bool:
    return np.dtype(dtype) in _NP_TO_TORCH


def hashable(obj) -> bool:
    """Whether ``obj`` can be a label (a dict key)."""
    try:
        hash(obj)
    except TypeError:
        return False
    return True
