"""Top-level functions of the port's pandas API: concat, merge, pivot_table,
to_datetime, get_dummies, ...

The port's counterpart of ``modin_tpu/pandas/general.py``.  ``concat`` of
frames and ``merge`` reach the device paths of the query compiler; the rest
run in pandas, and every such call counts one default in
``query_compiler.DEFAULTS_TO_PANDAS`` (``_wrap``).  The IO functions
(``read_csv``, ...) are in ``io.py``.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional, Union

import numpy as np
import pandas
from pandas._libs.lib import no_default

from modin_tpu_torch.error_message import ErrorMessage
from modin_tpu_torch.pandas.dataframe import DataFrame
from modin_tpu_torch.pandas.series import Series
from modin_tpu_torch.utils import MODIN_UNNAMED_SERIES_LABEL, try_cast_to_pandas


def _wrap(result: Any) -> Any:
    """Count one default to pandas and wrap its result in the port's
    objects (every caller computed ``result`` in pandas)."""
    from modin_tpu_torch.core.storage_formats.torch.query_compiler import (
        TorchQueryCompiler,
    )

    ErrorMessage.default_to_pandas("`pandas` top-level function")
    if isinstance(result, pandas.DataFrame):
        return DataFrame(query_compiler=TorchQueryCompiler.from_pandas(result))
    if isinstance(result, pandas.Series):
        frame = result.to_frame(
            result.name if result.name is not None else MODIN_UNNAMED_SERIES_LABEL
        )
        qc = TorchQueryCompiler.from_pandas(frame)
        qc._shape_hint = "column"
        return Series(query_compiler=qc)
    return result


def concat(
    objs: Iterable,
    *,
    axis: Any = 0,
    join: str = "outer",
    ignore_index: bool = False,
    keys: Any = None,
    levels: Any = None,
    names: Any = None,
    verify_integrity: bool = False,
    sort: bool = False,
    copy: Any = None,
) -> Union[DataFrame, Series]:
    if isinstance(objs, (pandas.Series, Series, DataFrame, str, pandas.DataFrame)):
        raise TypeError(
            "first argument must be an iterable of pandas objects, you passed "
            f"an object of type '{type(objs).__name__}'"
        )
    if isinstance(objs, dict):
        input_list_of_objs = list(objs.values())
        if keys is None:
            keys = list(objs.keys())
    else:
        input_list_of_objs = list(objs)
    if len(input_list_of_objs) == 0:
        raise ValueError("No objects to concatenate")
    list_of_objs = [obj for obj in input_list_of_objs if obj is not None]
    if len(list_of_objs) == 0:
        raise ValueError("All objects passed were None")

    axis_num = 0 if axis in (0, "index", None) else 1
    needs_fallback = (
        keys is not None
        or levels is not None
        or names is not None
        or verify_integrity
        or any(
            not isinstance(o, (DataFrame, Series, pandas.DataFrame, pandas.Series))
            for o in list_of_objs
        )
    )
    if needs_fallback:
        return _wrap(
            pandas.concat(
                try_cast_to_pandas(list_of_objs),
                axis=axis,
                join=join,
                ignore_index=ignore_index,
                keys=keys,
                levels=levels,
                names=names,
                verify_integrity=verify_integrity,
                sort=sort,
            )
        )

    all_series = all(isinstance(o, (Series, pandas.Series)) for o in list_of_objs)
    modin_objs = []
    for o in list_of_objs:
        if isinstance(o, pandas.DataFrame):
            o = DataFrame(o)
        elif isinstance(o, pandas.Series):
            o = Series(o)
        modin_objs.append(o)

    if all_series and axis_num == 0:
        return _wrap(
            pandas.concat(
                [o._to_pandas() for o in modin_objs],
                axis=axis, join=join, ignore_index=ignore_index, sort=sort,
            )
        )

    frames = []
    unnamed_counter = 0
    for o in modin_objs:
        if isinstance(o, Series):
            f = o.to_frame()
            if o.name is None and axis_num == 1:
                # pandas numbers only the unnamed series, sequentially
                f.columns = pandas.Index([unnamed_counter])
                unnamed_counter += 1
            frames.append(f)
        else:
            frames.append(o)
    base_qc = frames[0]._query_compiler
    other_qcs = [f._query_compiler for f in frames[1:]]
    if not other_qcs:
        result_qc = base_qc.copy()
        if ignore_index:
            result_qc = result_qc.reset_index(drop=True)
    else:
        result_qc = base_qc.concat(
            axis_num, other_qcs, join=join, ignore_index=ignore_index, sort=sort
        )
    return DataFrame(query_compiler=result_qc)


def merge(
    left: Any,
    right: Any,
    how: str = "inner",
    on: Any = None,
    left_on: Any = None,
    right_on: Any = None,
    left_index: bool = False,
    right_index: bool = False,
    sort: bool = False,
    suffixes: Any = ("_x", "_y"),
    copy: Any = None,
    indicator: bool = False,
    validate: Any = None,
) -> DataFrame:
    if isinstance(left, (pandas.DataFrame, pandas.Series)):
        left = DataFrame(left) if isinstance(left, pandas.DataFrame) else Series(left)
    if isinstance(left, Series):
        if left.name is None:
            raise ValueError("Cannot merge a Series without a name")
        left = left.to_frame()
    if not isinstance(left, DataFrame):
        raise TypeError(
            f"Can only merge Series or DataFrame objects, a {type(left)} was passed"
        )
    return left.merge(
        right,
        how=how,
        on=on,
        left_on=left_on,
        right_on=right_on,
        left_index=left_index,
        right_index=right_index,
        sort=sort,
        suffixes=suffixes,
        indicator=indicator,
        validate=validate,
    )


def merge_ordered(left: Any, right: Any, **kwargs: Any) -> DataFrame:
    return _wrap(
        pandas.merge_ordered(
            try_cast_to_pandas(left), try_cast_to_pandas(right), **kwargs
        )
    )


def merge_asof(left: Any, right: Any, **kwargs: Any) -> DataFrame:
    return _wrap(
        pandas.merge_asof(try_cast_to_pandas(left), try_cast_to_pandas(right), **kwargs)
    )


def pivot_table(data: Any, **kwargs: Any) -> DataFrame:
    if not isinstance(data, DataFrame):
        raise ValueError(f"can not create pivot table with instance of type {type(data)}")
    return data.pivot_table(**kwargs)


def pivot(data: Any, **kwargs: Any) -> DataFrame:
    if not isinstance(data, DataFrame):
        raise ValueError(f"can not pivot with instance of type {type(data)}")
    return data.pivot(**kwargs)


def crosstab(*args: Any, **kwargs: Any) -> DataFrame:
    return _wrap(pandas.crosstab(*try_cast_to_pandas(args), **try_cast_to_pandas(kwargs)))


def lreshape(data: Any, groups: dict, dropna: bool = True) -> DataFrame:
    return _wrap(pandas.lreshape(try_cast_to_pandas(data), groups, dropna=dropna))


def wide_to_long(df: Any, *args: Any, **kwargs: Any) -> DataFrame:
    return _wrap(pandas.wide_to_long(try_cast_to_pandas(df), *args, **kwargs))


def melt(frame: Any, **kwargs: Any) -> DataFrame:
    return frame.melt(**kwargs) if isinstance(frame, DataFrame) else _wrap(
        pandas.melt(try_cast_to_pandas(frame), **kwargs)
    )


def get_dummies(
    data: Any,
    prefix: Any = None,
    prefix_sep: str = "_",
    dummy_na: bool = False,
    columns: Any = None,
    sparse: bool = False,
    drop_first: bool = False,
    dtype: Any = None,
) -> DataFrame:
    if sparse:
        raise NotImplementedError("SparseDataFrame is not implemented in modin_tpu_torch")
    if not isinstance(data, (DataFrame, Series)):
        return _wrap(
            pandas.get_dummies(
                data, prefix=prefix, prefix_sep=prefix_sep, dummy_na=dummy_na,
                columns=columns, sparse=sparse, drop_first=drop_first, dtype=dtype,
            )
        )
    if isinstance(data, Series):
        # string/categorical series one-hot on device through the dictionary
        # codes (one equality kernel per category)
        fast = getattr(data._query_compiler, "series_get_dummies", None)
        if fast is not None:
            qc = fast(
                prefix=prefix, prefix_sep=prefix_sep, dummy_na=dummy_na,
                drop_first=drop_first, dtype=dtype,
            )
            if qc is not None:
                return DataFrame(query_compiler=qc)
        # pandas encodes a Series regardless of dtype; go through the Series
        # kernel directly so numeric series are one-hot encoded too
        return _wrap(
            pandas.get_dummies(
                data._to_pandas(), prefix=prefix, prefix_sep=prefix_sep,
                dummy_na=dummy_na, drop_first=drop_first, dtype=dtype,
            )
        )
    qc = data._query_compiler.get_dummies(
        columns,
        prefix=prefix, prefix_sep=prefix_sep, dummy_na=dummy_na,
        drop_first=drop_first, dtype=dtype,
    )
    return DataFrame(query_compiler=qc)


def cut(x: Any, bins: Any, **kwargs: Any):
    return _wrap(pandas.cut(try_cast_to_pandas(x, squeeze=True), bins, **kwargs))


def qcut(x: Any, q: Any, **kwargs: Any):
    return _wrap(pandas.qcut(try_cast_to_pandas(x, squeeze=True), q, **kwargs))


def unique(values: Any) -> np.ndarray:
    if isinstance(values, Series):
        return values.unique()
    return pandas.unique(try_cast_to_pandas(values))


def factorize(values: Any, **kwargs: Any):
    return pandas.factorize(try_cast_to_pandas(values, squeeze=True), **kwargs)


def value_counts(values: Any, **kwargs: Any) -> Series:
    if isinstance(values, Series):
        return values.value_counts(**kwargs)
    return _wrap(pandas.Series(try_cast_to_pandas(values)).value_counts(**kwargs))


def to_datetime(arg: Any, **kwargs: Any):
    if isinstance(arg, Series):
        qc = arg._query_compiler.to_datetime(**kwargs)
        if hasattr(qc, "to_pandas"):
            qc._shape_hint = "column"
            return Series(query_compiler=qc)
        return qc
    if isinstance(arg, DataFrame):
        return _wrap(pandas.to_datetime(arg._to_pandas(), **kwargs))
    return pandas.to_datetime(arg, **kwargs)


def to_numeric(arg: Any, errors: str = "raise", downcast: Any = None, **kwargs: Any):
    if isinstance(arg, Series):
        qc = arg._query_compiler.to_numeric(errors=errors, downcast=downcast, **kwargs)
        if hasattr(qc, "to_pandas"):
            qc._shape_hint = "column"
            return Series(query_compiler=qc)
        return qc
    return pandas.to_numeric(try_cast_to_pandas(arg), errors=errors, downcast=downcast, **kwargs)


def to_timedelta(arg: Any, unit: Any = None, errors: str = "raise"):
    if isinstance(arg, Series):
        qc = arg._query_compiler.to_timedelta(unit=unit, errors=errors)
        if hasattr(qc, "to_pandas"):
            qc._shape_hint = "column"
            return Series(query_compiler=qc)
        return qc
    return pandas.to_timedelta(try_cast_to_pandas(arg), unit=unit, errors=errors)


def notna(obj: Any):
    if isinstance(obj, (DataFrame, Series)):
        return obj.notna()
    return pandas.notna(obj)


notnull = notna


def isna(obj: Any):
    if isinstance(obj, (DataFrame, Series)):
        return obj.isna()
    return pandas.isna(obj)


isnull = isna


def json_normalize(data: Any, **kwargs: Any) -> DataFrame:
    return _wrap(pandas.json_normalize(try_cast_to_pandas(data), **kwargs))


def from_dummies(data: Any, **kwargs: Any) -> DataFrame:
    return _wrap(pandas.from_dummies(try_cast_to_pandas(data), **kwargs))


def bdate_range(*args: Any, **kwargs: Any):
    return pandas.bdate_range(*args, **kwargs)


def date_range(*args: Any, **kwargs: Any):
    return pandas.date_range(*args, **kwargs)


def period_range(*args: Any, **kwargs: Any):
    return pandas.period_range(*args, **kwargs)


def timedelta_range(*args: Any, **kwargs: Any):
    return pandas.timedelta_range(*args, **kwargs)


def interval_range(*args: Any, **kwargs: Any):
    return pandas.interval_range(*args, **kwargs)
