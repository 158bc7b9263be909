"""API-layer helpers: wrapping pandas objects into the port's objects and back.

The port's counterpart of ``modin_tpu/pandas/utils.py`` (``from_pandas``)
and ``modin_tpu/utils::to_pandas``.
"""

from __future__ import annotations

from typing import Any

from modin_tpu_torch.core.storage_formats.torch.query_compiler import (
    TorchQueryCompiler,
)


def from_pandas(df: Any):
    """Convert a pandas DataFrame to a modin_tpu_torch DataFrame on the
    configured device."""
    from modin_tpu_torch.pandas.dataframe import DataFrame

    return DataFrame(query_compiler=TorchQueryCompiler.from_pandas(df))


def to_pandas(obj: Any) -> Any:
    """Convert a modin_tpu_torch DataFrame/Series to its pandas counterpart
    (anything else passes through)."""
    to_pd = getattr(obj, "_to_pandas", None)
    return to_pd() if to_pd is not None else obj
