"""``BaseIO`` — the serial pandas implementation of every reader and writer.

The port's counterpart of ``modin_tpu/core/io/io.py``: each ``read_*``
reads with pandas and wraps the result in the bound query compiler; each
``to_*`` writes the frame through pandas.  Both count one default to pandas
(``ErrorMessage.default_to_pandas``).  The engine's IO class
(``core/execution/torch_engine/io.py``) overrides the formats that have a
dispatcher of their own.
"""

from __future__ import annotations

from typing import Any

import pandas

from modin_tpu_torch.error_message import ErrorMessage
from modin_tpu_torch.utils import MODIN_UNNAMED_SERIES_LABEL

READERS = (
    "read_parquet", "read_csv", "read_pickle", "read_table", "read_fwf",
    "read_clipboard", "read_excel", "read_hdf", "read_feather", "read_stata",
    "read_sas", "read_html", "read_sql", "read_sql_query", "read_sql_table",
    "read_json", "read_xml", "read_spss", "read_orc",
)
WRITERS = (
    "to_csv", "to_parquet", "to_json", "to_xml", "to_excel", "to_hdf",
    "to_feather", "to_stata", "to_pickle", "to_sql", "to_orc",
)


class BaseIO:
    """Default implementation of the IO functions."""

    query_compiler_cls: type = None

    @classmethod
    def _wrap(cls, pandas_obj: Any) -> Any:
        if isinstance(pandas_obj, pandas.Series):
            name = pandas_obj.name if pandas_obj.name is not None else MODIN_UNNAMED_SERIES_LABEL
            qc = cls.query_compiler_cls.from_pandas(pandas_obj.to_frame(name))
            qc._shape_hint = "column"
            return qc
        if isinstance(pandas_obj, pandas.DataFrame):
            return cls.query_compiler_cls.from_pandas(pandas_obj)
        return pandas_obj


def _make_default_reader(name: str):
    pandas_fn = getattr(pandas, name)

    @classmethod
    def reader(cls, **kwargs: Any) -> Any:
        ErrorMessage.default_to_pandas(f"`{name}`")
        result = pandas_fn(**kwargs)
        if isinstance(result, dict):  # read_excel(sheet_name=None)
            return {k: cls._wrap(v) for k, v in result.items()}
        if isinstance(result, list):  # read_html
            return [cls._wrap(v) for v in result]
        return cls._wrap(result)

    reader.__func__.__name__ = name
    return reader


def _make_default_writer(method_name: str):
    @classmethod
    def writer(cls, qc: Any, **kwargs: Any) -> Any:
        from modin_tpu_torch.utils import qc_to_pandas_for_write

        ErrorMessage.default_to_pandas(f"`{method_name}`")
        obj = qc_to_pandas_for_write(qc)
        if not hasattr(obj, method_name):
            # a frame-only writer driven from a Series-shaped compiler
            obj = qc.to_pandas()
        return getattr(obj, method_name)(**kwargs)

    writer.__func__.__name__ = method_name
    return writer


for _name in READERS:
    if hasattr(pandas, _name):
        setattr(BaseIO, _name, _make_default_reader(_name))
for _name in WRITERS:
    setattr(BaseIO, _name, _make_default_writer(_name))
