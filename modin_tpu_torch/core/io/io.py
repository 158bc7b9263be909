"""``BaseIO`` — the serial pandas implementation of every reader and writer.

The port's counterpart of ``modin_tpu/core/io/io.py``: each ``read_*``
reads with pandas and wraps the result in the bound query compiler; each
``to_*`` writes the frame through pandas.  Both count one default to pandas
(``ErrorMessage.default_to_pandas``).  The engine's IO class
(``core/execution/torch_engine/io.py``) overrides the formats that have a
dispatcher of their own.

Excel reads and writes with pandas where an engine (openpyxl, xlrd,
calamine, pyxlsb) is installed, counted as a default; where none is, the
port's own OOXML codec (``core/io/excel/xlsx.py``) serves the forms it
supports, uncounted, and every other form raises ``ImportError``, as the
JAX package's ``core/io/io.py`` does.
"""

from __future__ import annotations

import inspect
import zipfile
from typing import Any, Optional

import numpy as np
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

    @classmethod
    def from_interchange_dataframe(cls, df: Any) -> Any:
        """A query compiler of an interchange-protocol dataframe."""
        return cls.query_compiler_cls.from_interchange_dataframe(df)


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


# ---- Excel without an engine: the port's own xlsx codec ---------------- #

_NATIVE_READ_EXCEL_KEYS = {
    "io", "sheet_name", "header", "names", "skiprows", "nrows", "usecols",
    "index_col", "dtype", "engine",
}
_EXCEL_ENGINES = ("openpyxl", "xlrd", "python_calamine", "pyxlsb")


def _native_read_excel_unsupported(kwargs: dict) -> Optional[str]:
    """Why the native codec cannot read with ``kwargs``; None where it can."""
    if kwargs.get("engine") is not None:
        return f"engine={kwargs['engine']!r} was explicitly requested"
    sig = inspect.signature(pandas.read_excel)
    for key, value in kwargs.items():
        if key in _NATIVE_READ_EXCEL_KEYS:
            continue
        param = sig.parameters.get(key)
        if param is not None and value is not param.default:
            return f"{key}={value!r}"
    header = kwargs.get("header", 0)
    if not (header is None or isinstance(header, (int, np.integer))):
        return f"header={header!r} (only a single row index)"
    if callable(kwargs.get("skiprows")):
        return "callable skiprows"
    usecols = kwargs.get("usecols")
    if usecols is not None and not isinstance(usecols, (list, tuple, range, np.ndarray)):
        return f"usecols={usecols!r} (only a list of positions/labels)"
    index_col = kwargs.get("index_col")
    if index_col is not None and not isinstance(index_col, (int, np.integer, list, tuple)):
        return f"index_col={index_col!r}"
    return None


def _no_excel_engine_installed() -> bool:
    for mod in _EXCEL_ENGINES:
        try:
            __import__(mod)
        except ImportError:
            continue
        return False
    return True


def _not_a_workbook(path: Any) -> ImportError:
    return ImportError(
        "read_excel: no engine installed (openpyxl/xlrd) and the native "
        f"parser only supports OOXML .xlsx files; {path!r} is not a readable "
        ".xlsx workbook"
    )


def _read_excel_native(kwargs: dict) -> Any:
    """``read_excel`` by the native codec: pandas objects (a dict for a
    list or None of sheets); ``ImportError`` for what it does not read."""
    from modin_tpu_torch.core.io.excel import read_xlsx

    reason = _native_read_excel_unsupported(kwargs)
    if reason is not None:
        raise ImportError(
            f"read_excel: no engine installed and the native xlsx parser does not support {reason}"
        )
    native_kwargs = {
        k: v for k, v in kwargs.items() if k in _NATIVE_READ_EXCEL_KEYS and k not in ("io", "engine")
    }
    try:
        return read_xlsx(kwargs["io"], **native_kwargs)
    except zipfile.BadZipFile as err:
        raise _not_a_workbook(kwargs["io"]) from err


@classmethod
def _read_excel_with_native_fallback(cls, **kwargs: Any) -> Any:
    try:
        result = pandas.read_excel(**kwargs)
    except zipfile.BadZipFile as err:
        # pandas' format sniffing opened the zip: with an engine installed
        # this is a corrupt file, pandas' own error
        if not _no_excel_engine_installed():
            raise
        raise _not_a_workbook(kwargs.get("io")) from err
    except ImportError as err:
        try:
            result = _read_excel_native(kwargs)
        except ImportError as native_err:
            raise native_err from err
    else:
        ErrorMessage.default_to_pandas("`read_excel`")
    if isinstance(result, dict):
        return {k: cls._wrap(v) for k, v in result.items()}
    return cls._wrap(result)


@classmethod
def _to_excel_with_native_fallback(cls, qc: Any, **kwargs: Any) -> Any:
    from modin_tpu_torch.utils import qc_to_pandas_for_write

    obj = qc_to_pandas_for_write(qc)
    try:
        result = obj.to_excel(**kwargs)
    except ImportError as err:
        sig = inspect.signature(pandas.DataFrame.to_excel)

        def is_default(k: Any, v: Any) -> bool:
            if k not in sig.parameters:
                return False
            try:
                return bool(v == sig.parameters[k].default)
            except (TypeError, ValueError):  # an array-valued argument
                return False

        unsupported = {
            k: v for k, v in kwargs.items()
            if k not in ("excel_writer", "sheet_name", "index", "header")
            and not is_default(k, v)
            # the native writer never merges cells: any bool is the same
            and not (k == "merge_cells" and isinstance(v, bool))
        }
        if unsupported or not isinstance(kwargs.get("header", True), bool):
            raise ImportError(
                "to_excel: no engine installed and the native xlsx writer "
                f"does not support {sorted(unsupported)}"
            ) from err
        from modin_tpu_torch.core.io.excel import write_xlsx

        write_xlsx(
            obj.to_frame() if isinstance(obj, pandas.Series) else obj,
            kwargs["excel_writer"],
            sheet_name=kwargs.get("sheet_name", "Sheet1"),
            index=kwargs.get("index", True),
            header=kwargs.get("header", True),
        )
        return None
    ErrorMessage.default_to_pandas("`to_excel`")
    return result


BaseIO.read_excel = _read_excel_with_native_fallback
BaseIO.to_excel = _to_excel_with_native_fallback
