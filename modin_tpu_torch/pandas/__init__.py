"""The pandas API of the torch port: ``import modin_tpu_torch.pandas as pd``.

The port's counterpart of ``modin_tpu/pandas/__init__.py``: the whole pandas
namespace, with the port's ``DataFrame`` and ``Series`` and the top-level
functions of ``general.py`` in place of pandas' own; types, dtypes, options
and other utilities pass through to pandas.  Every method of ``DataFrame``
and ``Series`` exists; what the device does not run defaults to pandas,
counted in ``query_compiler.DEFAULTS_TO_PANDAS``.

The IO functions (``read_csv``, ``read_parquet``, ..., ``to_pickle``) are a
later slice of the port and are absent: asking for one raises
AttributeError instead of handing back a pandas frame.
"""

from __future__ import annotations

import pandas

__pandas_version__ = pandas.__version__

# --- pass-through re-exports (types, dtypes, options, utilities) ---------- #
from pandas import (  # noqa: F401
    NA,
    ArrowDtype,
    BooleanDtype,
    Categorical,
    CategoricalDtype,
    CategoricalIndex,
    DateOffset,
    DatetimeIndex,
    DatetimeTZDtype,
    Flags,
    Float32Dtype,
    Float64Dtype,
    Grouper,
    Index,
    IndexSlice,
    Int8Dtype,
    Int16Dtype,
    Int32Dtype,
    Int64Dtype,
    Interval,
    IntervalDtype,
    IntervalIndex,
    MultiIndex,
    NamedAgg,
    NaT,
    Period,
    PeriodDtype,
    PeriodIndex,
    RangeIndex,
    SparseDtype,
    StringDtype,
    Timedelta,
    TimedeltaIndex,
    Timestamp,
    UInt8Dtype,
    UInt16Dtype,
    UInt32Dtype,
    UInt64Dtype,
    array,
    arrays,
    describe_option,
    eval,
    get_option,
    infer_freq,
    option_context,
    options,
    reset_option,
    set_eng_float_format,
    set_option,
    test,
    testing,
)

from modin_tpu_torch.pandas.dataframe import DataFrame  # noqa: E402,F401
from modin_tpu_torch.pandas.general import (  # noqa: E402,F401
    bdate_range,
    concat,
    crosstab,
    cut,
    date_range,
    factorize,
    from_dummies,
    get_dummies,
    interval_range,
    isna,
    isnull,
    json_normalize,
    lreshape,
    melt,
    merge,
    merge_asof,
    merge_ordered,
    notna,
    notnull,
    period_range,
    pivot,
    pivot_table,
    qcut,
    timedelta_range,
    to_datetime,
    to_numeric,
    to_timedelta,
    unique,
    value_counts,
    wide_to_long,
)
from modin_tpu_torch.pandas.plotting import Plotting as plotting  # noqa: E402,F401
from modin_tpu_torch.pandas.series import Series  # noqa: E402,F401
from modin_tpu_torch.pandas.utils import from_pandas, to_pandas  # noqa: E402,F401

__version__ = pandas.__version__

# the IO slice of the port is still to come (ROADMAP Queue 1 item 8)
IO_FUNCTIONS = frozenset(
    [
        "ExcelFile", "HDFStore", "read_clipboard", "read_csv", "read_excel",
        "read_feather", "read_fwf", "read_hdf", "read_html", "read_json",
        "read_orc", "read_parquet", "read_pickle", "read_sas", "read_spss",
        "read_sql", "read_sql_query", "read_sql_table", "read_stata",
        "read_table", "read_xml", "to_pickle",
    ]
)

__all__ = [
    "DataFrame", "Series", "concat", "eval", "unique", "value_counts", "cut",
    "to_numeric", "factorize", "qcut", "to_datetime", "get_dummies", "isna",
    "isnull", "merge", "pivot_table", "date_range", "Index", "MultiIndex",
    "bdate_range", "period_range", "DatetimeIndex", "to_timedelta",
    "set_eng_float_format", "options", "set_option", "get_option",
    "reset_option", "option_context", "CategoricalIndex", "Timedelta",
    "Timestamp", "NaT", "PeriodIndex", "Categorical", "__version__", "melt",
    "crosstab", "plotting", "Interval", "UInt8Dtype", "UInt16Dtype",
    "UInt32Dtype", "UInt64Dtype", "SparseDtype", "Int8Dtype", "Int16Dtype",
    "Int32Dtype", "Int64Dtype", "CategoricalDtype", "DatetimeTZDtype",
    "IntervalDtype", "PeriodDtype", "BooleanDtype", "StringDtype", "NA",
    "RangeIndex", "TimedeltaIndex", "IntervalIndex", "IndexSlice", "Grouper",
    "array", "Period", "DateOffset", "timedelta_range", "infer_freq",
    "interval_range", "describe_option", "notnull", "notna", "pivot", "test",
    "lreshape", "wide_to_long", "merge_asof", "merge_ordered",
    "json_normalize", "NamedAgg", "from_dummies", "from_pandas", "to_pandas",
]


def __getattr__(name: str):
    """Anything else pandas has passes through, apart from the IO
    functions, which the port does not have yet."""
    if name in IO_FUNCTIONS:
        raise AttributeError(
            f"modin_tpu_torch.pandas has no {name!r}: the IO functions are a "
            "later slice of the port"
        )
    try:
        return getattr(pandas, name)
    except AttributeError:
        raise AttributeError(
            f"module 'modin_tpu_torch.pandas' has no attribute '{name}'"
        ) from None
