"""The interchange-protocol consumer (mirrors ``pandas.api.interchange``)."""

from typing import Any


def from_dataframe(df: Any, allow_copy: bool = True):
    """A modin_tpu_torch DataFrame of any ``__dataframe__`` protocol object."""
    from modin_tpu_torch.core.execution.dispatching.factories.dispatcher import (
        FactoryDispatcher,
    )
    from modin_tpu_torch.pandas.dataframe import DataFrame

    if hasattr(df, "__dataframe__"):
        df = df.__dataframe__(allow_copy=allow_copy)
    return DataFrame(query_compiler=FactoryDispatcher.from_interchange_dataframe(df))


__all__ = ["from_dataframe"]
