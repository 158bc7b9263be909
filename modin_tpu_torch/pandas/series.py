"""``Series`` of the torch port: one column of a frame, or a result.

The port's counterpart of ``modin_tpu/pandas/series.py``.  Internally a
Series is a one-column query compiler (column label ``__reduced__`` when
unnamed) with ``_shape_hint == "column"``; the API squeezes on
materialization.  ``groupby`` gives the port's ``SeriesGroupBy``; the
window methods default to pandas.
"""

from __future__ import annotations

from typing import Any, Hashable, Iterator, Optional, Union

import numpy as np
import pandas
from pandas._libs.lib import no_default
from pandas.api.types import is_list_like
from pandas.core.dtypes.common import is_bool_dtype, is_integer

from modin_tpu_torch.pandas.base import BasePandasDataset, _install_fallbacks
from modin_tpu_torch.utils import (
    MODIN_UNNAMED_SERIES_LABEL,
    hashable,
    try_cast_to_pandas,
)


class Series(BasePandasDataset):
    _pandas_class = pandas.Series
    ndim = 1

    def __init__(
        self,
        data: Any = None,
        index: Any = None,
        dtype: Any = None,
        name: Any = None,
        copy: Any = None,
        query_compiler: Any = None,
    ) -> None:
        from modin_tpu_torch.pandas.dataframe import DataFrame

        if query_compiler is not None:
            assert data is None and index is None
            query_compiler._shape_hint = "column"
            self._set_query_compiler(query_compiler)
            if name is not None:
                self.name = name
            return
        if isinstance(data, Series):
            if index is None and dtype is None:
                self._set_query_compiler(data._query_compiler.copy())
                if name is not None:
                    self.name = name
                return
            data = data._to_pandas()
        if isinstance(data, DataFrame):
            raise ValueError("Data cannot be a DataFrame")
        if isinstance(data, dict):
            data = {
                k: (try_cast_to_pandas(v, squeeze=True) if isinstance(v, BasePandasDataset) else v)
                for k, v in data.items()
            }
        pandas_series = pandas.Series(
            data=data, index=index, dtype=dtype, name=name, copy=copy
        )
        frame = pandas_series.to_frame(
            pandas_series.name
            if pandas_series.name is not None
            else MODIN_UNNAMED_SERIES_LABEL
        )
        from modin_tpu_torch.core.storage_formats.torch.query_compiler import (
            TorchQueryCompiler,
        )

        qc = TorchQueryCompiler.from_pandas(frame)
        qc._shape_hint = "column"
        self._set_query_compiler(qc)

    # ------------------------------------------------------------------ #
    # Metadata
    # ------------------------------------------------------------------ #

    @property
    def name(self) -> Optional[Hashable]:
        columns = self._query_compiler.columns
        name = columns[0]
        if name == MODIN_UNNAMED_SERIES_LABEL:
            return None
        return name

    @name.setter
    def name(self, name: Optional[Hashable]) -> None:
        if name is None:
            name = MODIN_UNNAMED_SERIES_LABEL
        self._query_compiler.columns = pandas.Index([name])

    def rename(
        self,
        index: Any = None,
        *,
        axis: Any = None,
        copy: Any = None,
        inplace: bool = False,
        level: Any = None,
        errors: str = "ignore",
    ):
        non_mapping = index is None or (
            hashable(index) and not isinstance(index, (dict,))
            and not callable(index)
        )
        if non_mapping:
            if inplace:
                self.name = index
                return None
            result = self.copy()
            result.name = index
            return result
        result = self._default_to_pandas(
            "rename", index, level=level, errors=errors
        )
        if inplace:
            self._update_inplace(result._query_compiler)
            return None
        return result

    @property
    def dtype(self):
        return self._query_compiler.dtypes.iloc[0]

    @property
    def dtypes(self):
        return self.dtype

    @property
    def shape(self) -> tuple:
        return (len(self),)

    @property
    def hasnans(self) -> bool:
        return bool(self.isna().sum())

    @property
    def nbytes(self) -> int:
        return self._to_pandas().nbytes

    @property
    def is_unique(self) -> bool:
        return self.nunique(dropna=False) == len(self)

    @property
    def is_monotonic_increasing(self) -> bool:
        return self._query_compiler.is_monotonic_increasing()

    @property
    def is_monotonic_decreasing(self) -> bool:
        return self._query_compiler.is_monotonic_decreasing()

    @property
    def T(self) -> "Series":
        return self

    def transpose(self, *args: Any, **kwargs: Any) -> "Series":
        return self

    @property
    def array(self):
        return self._to_pandas().array

    def item(self):
        if len(self) != 1:
            raise ValueError("can only convert an array of size 1 to a Python scalar")
        return self._to_pandas().item()

    # ------------------------------------------------------------------ #
    # Display & materialization
    # ------------------------------------------------------------------ #

    def __repr__(self) -> str:
        import re

        num_rows = pandas.get_option("display.max_rows") or 60
        frame = self._build_repr_df(num_rows)
        series = frame[frame.columns[0]]
        if series.name == MODIN_UNNAMED_SERIES_LABEL:
            series.name = None
        result = repr(series)
        n = len(self)
        if n > num_rows:
            return re.sub(r"Length: \d+", f"Length: {n}", result)
        return result

    def _to_pandas(self) -> pandas.Series:
        df = self._query_compiler.to_pandas()
        series = df[df.columns[0]]
        if series.name == MODIN_UNNAMED_SERIES_LABEL:
            series.name = None
        return series

    def to_frame(self, name: Any = no_default):
        from modin_tpu_torch.pandas.dataframe import DataFrame

        if name is no_default:
            name = self.name
        new_qc = self._query_compiler.copy()
        new_qc.columns = pandas.Index(
            [name if name is not None else MODIN_UNNAMED_SERIES_LABEL]
        )
        new_qc._shape_hint = None
        result = DataFrame(query_compiler=new_qc)
        if name is None:
            result.columns = pandas.Index([0])
        return result

    def to_list(self) -> list:
        return self._to_pandas().to_list()

    tolist = to_list

    def to_numpy(self, dtype: Any = None, copy: bool = False, na_value: Any = no_default, **kwargs: Any) -> np.ndarray:
        return (
            self._query_compiler.to_numpy(dtype=dtype, copy=copy, na_value=na_value)
            .flatten()
        )

    def to_dict(self, into: Any = dict) -> dict:
        return self._to_pandas().to_dict(into=into)

    # ------------------------------------------------------------------ #
    # Reductions returning scalars
    # ------------------------------------------------------------------ #

    def _reduce_dimension(self, query_compiler) -> Any:
        if not hasattr(query_compiler, "to_pandas"):
            return query_compiler
        result = query_compiler.to_pandas()
        if result.shape == (1, 1):
            return result.iloc[0, 0]
        return result.squeeze()

    def count(self, axis: Any = 0, numeric_only: bool = False):
        return super().count(axis=axis)

    def nunique(self, dropna: bool = True) -> int:
        result = self._query_compiler.nunique(axis=0, dropna=dropna)
        if hasattr(result, "to_pandas"):
            return int(result.to_pandas().iloc[0, 0])
        return int(result)

    def unique(self):
        # pandas' own unique of the distinct values (in order of appearance)
        # gives pandas' result type: an ndarray, or an extension array
        return self._query_compiler.unique().to_pandas().iloc[:, 0].unique()

    def groupby(
        self,
        by: Any = None,
        level: Any = None,
        as_index: bool = True,
        sort: bool = True,
        group_keys: bool = True,
        observed: Any = True,
        dropna: bool = True,
    ):
        from modin_tpu_torch.pandas.groupby import SeriesGroupBy

        if by is None and level is None:
            raise TypeError("You have to supply one of 'by' and 'level'")
        return SeriesGroupBy(
            self, by=by, level=level, as_index=as_index, sort=sort,
            group_keys=group_keys, observed=observed, dropna=dropna,
        )

    def value_counts(self, normalize: bool = False, sort: bool = True, ascending: bool = False, bins: Any = None, dropna: bool = True):
        qc = self._query_compiler.series_value_counts(
            normalize=normalize, sort=sort, ascending=ascending, bins=bins, dropna=dropna
        )
        qc._shape_hint = "column"
        return Series(query_compiler=qc)

    def argmax(self, axis: Any = None, skipna: bool = True, *args: Any, **kwargs: Any) -> int:
        return self._default_to_pandas("argmax", axis=axis, skipna=skipna)

    def argmin(self, axis: Any = None, skipna: bool = True, *args: Any, **kwargs: Any) -> int:
        return self._default_to_pandas("argmin", axis=axis, skipna=skipna)

    def argsort(self, axis: Any = 0, kind: str = "quicksort", order: Any = None, stable: Any = None) -> "Series":
        qc = self._query_compiler.series_argsort(kind=kind)
        qc._shape_hint = "column"
        return Series(query_compiler=qc)

    def autocorr(self, lag: int = 1) -> float:
        return self._query_compiler.series_autocorr(lag=lag)

    def between(self, left: Any, right: Any, inclusive: str = "both") -> "Series":
        qc = self._query_compiler.series_between(left=left, right=right, inclusive=inclusive)
        qc._shape_hint = "column"
        return Series(query_compiler=qc)

    def corr(self, other: "Series", method: Any = "pearson", min_periods: Any = None) -> float:
        return self._default_to_pandas(
            "corr", try_cast_to_pandas(other, squeeze=True), method=method, min_periods=min_periods
        )

    def cov(self, other: "Series", min_periods: Any = None, ddof: int = 1) -> float:
        return self._default_to_pandas(
            "cov", try_cast_to_pandas(other, squeeze=True), min_periods=min_periods, ddof=ddof
        )

    def dot(self, other: Any):
        return self._binary_op("series_dot", other)

    def idxmax(self, axis: Any = 0, skipna: bool = True, *args: Any, **kwargs: Any):
        result = self._query_compiler.idxmax(axis=0, skipna=skipna)
        return self._reduce_dimension(result)

    def idxmin(self, axis: Any = 0, skipna: bool = True, *args: Any, **kwargs: Any):
        result = self._query_compiler.idxmin(axis=0, skipna=skipna)
        return self._reduce_dimension(result)

    def quantile(self, q: Any = 0.5, interpolation: str = "linear"):
        result_qc = self._query_compiler.quantile(q=q, interpolation=interpolation)
        if is_list_like(q):
            qc = result_qc
            qc._shape_hint = "column"
            return Series(query_compiler=qc)
        return self._reduce_dimension(result_qc)

    def mode(self, dropna: bool = True) -> "Series":
        qc = self._query_compiler.mode(dropna=dropna)
        qc._shape_hint = "column"
        return Series(query_compiler=qc)

    def describe(self, percentiles: Any = None, include: Any = None, exclude: Any = None) -> "Series":
        qc = self._query_compiler.describe(percentiles=percentiles)
        qc._shape_hint = "column"
        return Series(query_compiler=qc)

    def all(self, axis: Any = 0, bool_only: bool = False, skipna: bool = True, **kwargs: Any):
        return super().all(axis=axis, bool_only=bool_only, skipna=skipna, **kwargs)

    def searchsorted(self, value: Any, side: str = "left", sorter: Any = None):
        result = self._query_compiler.searchsorted(value=value, side=side, sorter=sorter)
        arr = result.to_numpy().flatten()
        if np.isscalar(value) and len(arr) == 1:
            return arr[0]
        return arr

    # ------------------------------------------------------------------ #
    # Item access
    # ------------------------------------------------------------------ #

    def __getitem__(self, key: Any) -> Any:
        if isinstance(key, Series) and key.dtype == bool:
            return Series(
                query_compiler=self._query_compiler.getitem_array(key._query_compiler)
            )
        if isinstance(key, (np.ndarray, pandas.Series, list)) and getattr(
            np.asarray(key), "dtype", None
        ) == np.dtype(bool):
            return Series(
                query_compiler=self._query_compiler.getitem_array(np.asarray(key))
            )
        if isinstance(key, slice):
            # pandas: slices through [] are positional unless labels are non-ints
            if (is_integer(key.start) or key.start is None) and (
                is_integer(key.stop) or key.stop is None
            ):
                return self.iloc[key]
            return self.loc[key]
        if is_list_like(key):
            return self.loc[list(key)]
        return self.loc[key]

    def __setitem__(self, key: Any, value: Any) -> None:
        if isinstance(value, BasePandasDataset):
            value = try_cast_to_pandas(value, squeeze=True)

        def setter(s: pandas.Series) -> pandas.Series:
            s = s.copy()
            s[key] = value
            return s

        df_setter = lambda df: setter(df.squeeze(axis=1)).to_frame(  # noqa: E731
            df.columns[0]
        )
        self._update_inplace(self._query_compiler.default_to_pandas(df_setter))

    def __getattr__(self, key: str) -> Any:
        return object.__getattribute__(self, key)

    def __iter__(self) -> Iterator:
        return iter(self._to_pandas())

    def __contains__(self, key: Hashable) -> bool:
        return key in self.index

    def keys(self) -> pandas.Index:
        return self.index

    def items(self) -> Iterator:
        return self._to_pandas().items()

    # ------------------------------------------------------------------ #
    # Function application
    # ------------------------------------------------------------------ #

    def apply(self, func: Any, convert_dtype: Any = no_default, args: tuple = (), *, by_row: Any = "compat", **kwargs: Any):
        result = self._default_to_pandas("apply", func, args=args, **kwargs)
        return result

    def map(self, arg: Any, na_action: Any = None, **kwargs: Any) -> "Series":
        if isinstance(arg, Series):
            arg = arg._to_pandas()
        if not kwargs:
            # dict mappings ride the QC (device translate for dict-encoded
            # string columns / numeric lookup kernel); other args take the
            # generated pandas default inside the same QC method
            return Series(
                query_compiler=self._query_compiler.series_map(
                    arg, na_action=na_action
                )
            )
        return self._default_to_pandas("map", arg, na_action=na_action, **kwargs)

    def aggregate(self, func: Any = None, axis: Any = 0, *args: Any, **kwargs: Any):
        return self._default_to_pandas("agg", func, axis, *args, **kwargs)

    agg = aggregate

    # ------------------------------------------------------------------ #
    # Ordering / structure
    # ------------------------------------------------------------------ #

    def sort_values(
        self,
        *,
        axis: Any = 0,
        ascending: Any = True,
        inplace: bool = False,
        kind: str = "quicksort",
        na_position: str = "last",
        ignore_index: bool = False,
        key: Any = None,
    ):
        from modin_tpu_torch.pandas.dataframe import DataFrame

        # sort via the single-column frame
        frame = self.to_frame("__sort_col__")
        sorted_frame = frame.sort_values(
            by="__sort_col__",
            ascending=ascending,
            kind=kind,
            na_position=na_position,
            ignore_index=ignore_index,
            key=key,
        )
        qc = sorted_frame._query_compiler.copy()
        qc.columns = pandas.Index(
            [self.name if self.name is not None else MODIN_UNNAMED_SERIES_LABEL]
        )
        qc._shape_hint = "column"
        result = Series(query_compiler=qc)
        if inplace:
            self._update_inplace(result._query_compiler)
            return None
        return result

    def nlargest(self, n: int = 5, keep: str = "first") -> "Series":
        return self._default_to_pandas("nlargest", n=n, keep=keep)

    def nsmallest(self, n: int = 5, keep: str = "first") -> "Series":
        return self._default_to_pandas("nsmallest", n=n, keep=keep)

    def explode(self, ignore_index: bool = False) -> "Series":
        return self._default_to_pandas("explode", ignore_index=ignore_index)

    def repeat(self, repeats: Any, axis: Any = None) -> "Series":
        qc = self._query_compiler.repeat(repeats)
        qc._shape_hint = "column"
        return Series(query_compiler=qc)

    def duplicated(self, keep: Any = "first") -> "Series":
        # pandas keeps the series name on the boolean result
        return self.to_frame("__dup__").duplicated(keep=keep).rename(self.name)

    def drop_duplicates(self, *, keep: Any = "first", inplace: bool = False, ignore_index: bool = False):
        # value-dedup of a Series IS row-dedup of its single-column frame
        new_qc = self._query_compiler.drop_duplicates(
            subset=None, keep=keep, ignore_index=ignore_index
        )
        new_qc._shape_hint = "column"
        if inplace:
            self._update_inplace(new_qc)
            return None
        return Series(query_compiler=new_qc)

    def _series_reset_index(self, level: Any, inplace: bool):
        """reset_index(drop=False) — becomes a DataFrame."""
        from modin_tpu_torch.pandas.dataframe import DataFrame

        if inplace:
            raise TypeError(
                "Cannot reset_index inplace on a Series to create a DataFrame"
            )
        pandas_result = self._to_pandas().reset_index(level=level, drop=False)
        return self._wrap_pandas(pandas_result)

    def reset_index(self, level: Any = None, *, drop: bool = False, name: Any = no_default, inplace: bool = False, allow_duplicates: bool = False):
        if drop and level is None:
            new_qc = self._query_compiler.reset_index(drop=True)
            new_qc._shape_hint = "column"
            if not inplace:
                result = Series(query_compiler=new_qc)
                if name is not no_default:
                    result.name = name
                return result
            self._update_inplace(new_qc)
            return None
        obj = self.copy()
        if name is not no_default:
            obj.name = name
        return obj._series_reset_index(level, inplace)

    def update(self, other: Any) -> None:
        if not isinstance(other, Series):
            other = Series(other)
        qc = self._query_compiler.series_update(other._query_compiler)
        self._update_inplace(qc)

    def case_when(self, caselist: list) -> "Series":
        caselist = [
            tuple(
                c._query_compiler if isinstance(c, Series) else c for c in case
            )
            for case in caselist
        ]
        qc = self._query_compiler.case_when(caselist)
        qc._shape_hint = "column"
        return Series(query_compiler=qc)

    def isin(self, values: Any) -> "Series":
        result = super().isin(values)
        result._query_compiler._shape_hint = "column"
        return result

    def where(self, cond: Any, other: Any = np.nan, *, inplace: bool = False, axis: Any = None, level: Any = None):
        return super().where(cond, other, inplace=inplace, axis=axis, level=level)

    def ravel(self, order: str = "C") -> np.ndarray:
        return self.to_numpy()

    def compare(self, other: "Series", align_axis: Any = 1, keep_shape: bool = False, keep_equal: bool = False, result_names: Any = ("self", "other")):
        return self._default_to_pandas(
            "compare", try_cast_to_pandas(other, squeeze=True), align_axis=align_axis,
            keep_shape=keep_shape, keep_equal=keep_equal, result_names=result_names,
        )

    def equals(self, other: Any) -> bool:
        return self._query_compiler.equals(
            other._query_compiler if isinstance(other, Series) else other
        )

    def pop(self, item: Any):
        result = self[item]
        self.drop(labels=[item], inplace=True)
        return result

    def divmod(self, other: Any, level: Any = None, fill_value: Any = None, axis: Any = 0):
        div, mod = self._query_compiler.divmod(
            try_cast_to_pandas(other, squeeze=True),
            level=level, fill_value=fill_value, axis=axis,
        )
        return self.__constructor__(div), self.__constructor__(mod)

    def rdivmod(self, other: Any, level: Any = None, fill_value: Any = None, axis: Any = 0):
        div, mod = self._query_compiler.rdivmod(
            try_cast_to_pandas(other, squeeze=True),
            level=level, fill_value=fill_value, axis=axis,
        )
        return self.__constructor__(div), self.__constructor__(mod)

    # ------------------------------------------------------------------ #
    # Accessors
    # ------------------------------------------------------------------ #

    @property
    def str(self):
        from modin_tpu_torch.pandas.series_utils import StringMethods

        return StringMethods(self)

    @property
    def dt(self):
        from modin_tpu_torch.pandas.series_utils import DatetimeProperties

        return DatetimeProperties(self)

    @property
    def cat(self):
        from modin_tpu_torch.pandas.series_utils import CategoryMethods

        return CategoryMethods(self)

    @property
    def list(self):
        from modin_tpu_torch.pandas.series_utils import ListAccessor

        return ListAccessor(self)

    @property
    def struct(self):
        from modin_tpu_torch.pandas.series_utils import StructAccessor

        return StructAccessor(self)

    @property
    def plot(self):
        return self._default_to_pandas(lambda s: s.plot)

    # ------------------------------------------------------------------ #
    # IO
    # ------------------------------------------------------------------ #

    def __divmod__(self, other: Any):
        return self.divmod(other)

    def __rdivmod__(self, other: Any):
        return self.rdivmod(other)

    def __matmul__(self, other: Any):
        return self.dot(other)

    def __int__(self) -> int:
        return int(self.item())

    def __float__(self) -> float:
        return float(self.item())


_install_fallbacks(Series, pandas.Series)
