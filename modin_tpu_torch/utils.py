"""Small shared helpers of the torch port (no device work; pandas only
inside the functions that convert to it)."""

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


def _squeezed_series(df, squeeze: bool):
    """``df`` squeezed to a Series (without the unnamed-series label) when
    asked; anything else as it is."""
    import pandas

    if not squeeze or not isinstance(df, pandas.DataFrame):
        return df
    result = df.squeeze(axis=1)
    if isinstance(result, pandas.Series) and result.name == MODIN_UNNAMED_SERIES_LABEL:
        result.name = None
    return result


def qc_to_pandas_for_write(qc):
    """A query compiler as pandas for a writer: a Series-shaped compiler
    squeezes and sheds the unnamed-series label."""
    return _squeezed_series(qc.to_pandas(), getattr(qc, "_shape_hint", None) == "column")


def try_cast_to_pandas(obj, squeeze: bool = False):
    """``obj`` with every port object inside it (DataFrame, Series, query
    compiler; in lists, tuples and dict values) turned into plain pandas.
    A function of the port's pandas API becomes pandas' own namesake."""
    if hasattr(obj, "_to_pandas"):
        return _squeezed_series(obj._to_pandas(), squeeze)
    if hasattr(obj, "to_pandas") and hasattr(obj, "_shape_hint"):
        return _squeezed_series(obj.to_pandas(), squeeze or obj._shape_hint == "column")
    if isinstance(obj, (list, tuple)):
        return type(obj)([try_cast_to_pandas(o, squeeze=squeeze) for o in obj])
    if isinstance(obj, dict):
        return {k: try_cast_to_pandas(v, squeeze=squeeze) for k, v in obj.items()}
    if callable(obj):
        module = getattr(obj, "__module__", "") or ""
        name = getattr(obj, "__name__", None)
        if name and module.startswith("modin_tpu_torch.pandas"):
            import pandas

            owner = pandas.Series if module.endswith("series") else pandas.DataFrame
            return getattr(owner, name, obj)
    return obj
