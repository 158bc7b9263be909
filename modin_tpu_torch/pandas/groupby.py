"""``DataFrameGroupBy`` of the torch port — a lazy groupby object.

The port's counterpart of ``modin_tpu/pandas/groupby.py``, cut to
``count``/``size``/``sum``/``mean``/``min``/``max``.  The object holds
(frame, by, groupby kwargs) and hands each aggregation to
``TorchQueryCompiler.groupby_agg``; the compiler runs what it can on the
device and defaults the rest to pandas, counted.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
from pandas.api.types import is_list_like

from modin_tpu_torch.pandas.base import BasePandasDataset
from modin_tpu_torch.utils import hashable


class DataFrameGroupBy:
    def __init__(
        self,
        df: Any,
        by: Any = None,
        level: Any = None,
        as_index: bool = True,
        sort: bool = True,
        group_keys: bool = True,
        observed: Any = True,
        dropna: bool = True,
    ) -> None:
        self._df = df
        self._by = by
        self._kwargs = {
            "level": level,
            "as_index": as_index,
            "sort": sort,
            "group_keys": group_keys,
            "observed": observed,
            "dropna": dropna,
        }

    def _resolve_by(self):
        """(by for the compiler, drop): column labels stay labels (drop=True),
        a Series becomes its query compiler."""
        by = self._by
        columns = self._df.columns
        if isinstance(by, BasePandasDataset):
            return by._query_compiler, False
        if hashable(by) and not isinstance(by, tuple):
            if by in columns:
                return [by], True
            return by, False
        if is_list_like(by) and not isinstance(by, np.ndarray):
            by_list = list(by)
            if all(
                hashable(o) and not isinstance(o, BasePandasDataset) and o in columns
                for o in by_list
            ):
                return by_list, True
            return [
                o._query_compiler if isinstance(o, BasePandasDataset) else o
                for o in by_list
            ], False
        return by, False

    def _groupby_agg(self, agg_func: str, agg_kwargs: Optional[dict] = None):
        by, drop = self._resolve_by()
        result_qc = self._df._query_compiler.groupby_agg(
            by=by,
            agg_func=agg_func,
            axis=0,
            groupby_kwargs=dict(self._kwargs),
            agg_args=(),
            agg_kwargs=dict(agg_kwargs or {}),
            drop=drop,
        )
        from modin_tpu_torch.pandas.dataframe import DataFrame
        from modin_tpu_torch.pandas.series import Series

        if result_qc._shape_hint == "column":
            return Series(query_compiler=result_qc)
        return DataFrame(query_compiler=result_qc)

    def sum(self, numeric_only: bool = False, min_count: int = 0):
        return self._groupby_agg("sum", {"numeric_only": numeric_only, "min_count": min_count})

    def count(self):
        return self._groupby_agg("count")

    def mean(self, numeric_only: bool = False):
        return self._groupby_agg("mean", {"numeric_only": numeric_only})

    def min(self, numeric_only: bool = False, min_count: int = -1):
        return self._groupby_agg("min", {"numeric_only": numeric_only, "min_count": min_count})

    def max(self, numeric_only: bool = False, min_count: int = -1):
        return self._groupby_agg("max", {"numeric_only": numeric_only, "min_count": min_count})

    def size(self):
        result = self._groupby_agg("size")
        if self._kwargs["as_index"]:
            # size is a Series in pandas when as_index=True
            from modin_tpu_torch.pandas.series import Series

            qc = result._query_compiler
            qc._shape_hint = "column"
            return Series(query_compiler=qc)
        return result
