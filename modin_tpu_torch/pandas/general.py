"""Top-level functions of the port's pandas API: ``concat`` and ``merge``.

The port's counterpart of ``modin_tpu/pandas/general.py``, cut to these
two.  ``concat`` of frames runs on the device (rows of frames with equal
columns and dtypes, or columns of index-aligned frames); Series, ``keys``,
``levels``, ``names`` and ``verify_integrity`` go to pandas, counted in
``DEFAULTS_TO_PANDAS`` like every other declined query.
"""

from __future__ import annotations

from typing import Any, Iterable

import pandas

from modin_tpu_torch.core.storage_formats.torch.query_compiler import (
    TorchQueryCompiler,
)
from modin_tpu_torch.pandas.base import BasePandasDataset
from modin_tpu_torch.pandas.dataframe import DataFrame
from modin_tpu_torch.pandas.series import Series


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
) -> Any:
    if isinstance(objs, (pandas.Series, pandas.DataFrame, BasePandasDataset, str)):
        raise TypeError(
            "first argument must be an iterable of pandas objects, you passed "
            f"an object of type '{type(objs).__name__}'"
        )
    if isinstance(objs, dict):
        if keys is None:
            keys = list(objs.keys())
        objs = list(objs.values())
    objs = [o for o in objs if o is not None]
    if not objs:
        raise ValueError("No objects to concatenate")
    if not all(isinstance(o, (BasePandasDataset, pandas.DataFrame, pandas.Series)) for o in objs):
        raise TypeError("cannot concatenate objects that are not Series or DataFrame")
    axis_num = 0 if axis in (0, "index") else 1
    qcs = [BasePandasDataset._to_compiler(o) for o in objs]
    kwargs = {"join": join, "ignore_index": ignore_index, "sort": sort}
    if keys is not None or levels is not None or names is not None or verify_integrity:
        kwargs.update(keys=keys, levels=levels, names=names, verify_integrity=verify_integrity)
    elif all(qc._shape_hint != "column" for qc in qcs):
        return DataFrame(query_compiler=qcs[0].concat(axis_num, qcs[1:], **kwargs))

    def pandas_concat(*pandas_objs):
        return pandas.concat(list(pandas_objs), axis=axis, **kwargs)

    return BasePandasDataset._wrap(qcs[0]._default_to_pandas(pandas_concat, *qcs[1:]))


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
    if isinstance(left, pandas.DataFrame):
        left = DataFrame(left)
    elif isinstance(left, (Series, pandas.Series)):
        if left.name is None:
            raise ValueError("Cannot merge a Series without a name")
        frame = BasePandasDataset._to_compiler(left)._modin_frame
        left = DataFrame(query_compiler=TorchQueryCompiler(frame))
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
