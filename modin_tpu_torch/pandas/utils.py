"""API-layer helpers: wrapping pandas objects into the port's objects and back.

The port's counterpart of ``modin_tpu/pandas/utils.py`` (and of
``modin_tpu/utils.py::to_pandas``).
"""

from __future__ import annotations

from typing import Any

import pandas

from modin_tpu_torch.core.storage_formats.torch.query_compiler import (
    TorchQueryCompiler,
)


def from_pandas(df: pandas.DataFrame):
    """Convert a pandas DataFrame to a modin_tpu_torch DataFrame on the
    configured device."""
    from modin_tpu_torch.pandas.dataframe import DataFrame

    return DataFrame(query_compiler=TorchQueryCompiler.from_pandas(df))


def from_arrow(at: Any):
    """Convert a pyarrow Table to a modin_tpu_torch DataFrame."""
    from modin_tpu_torch.pandas.dataframe import DataFrame

    return DataFrame(query_compiler=TorchQueryCompiler.from_arrow(at))


def from_dataframe(df: Any):
    """Convert an interchange-protocol object to a modin_tpu_torch DataFrame."""
    from modin_tpu_torch.pandas.dataframe import DataFrame

    return DataFrame(query_compiler=TorchQueryCompiler.from_interchange_dataframe(df))


def to_pandas(obj: Any) -> Any:
    """Convert a modin_tpu_torch DataFrame/Series to its pandas counterpart
    (anything else passes through)."""
    to_pd = getattr(obj, "_to_pandas", None)
    return to_pd() if to_pd is not None else obj


SET_DATAFRAME_ATTRIBUTE_WARNING = (
    "modin_tpu_torch doesn't allow columns to be created via a new attribute name - see "
    "https://pandas.pydata.org/pandas-docs/stable/indexing.html#attribute-access"
)
