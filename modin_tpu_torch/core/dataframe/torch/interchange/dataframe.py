"""The DataFrame interchange protocol over a ``TorchDataframe``.

The port's counterpart of ``modin_tpu/core/dataframe/tpu/interchange/
dataframe.py``: the producer sits on the frame's columns, and no pandas frame
of the whole is built.

- A device column that still holds its ``host_cache`` exports that numpy
  array, without a copy.
- A computed device column is fetched once, when a consumer first asks for
  it, and held for the producer's life: a consumer that selects 2 of 50
  columns fetches 2 (``COLUMN_FETCHES`` counts the fetches).
- Host (string, categorical, extension) columns hand over pandas' own
  protocol column, one column, for the variable-width layouts.

The buffers are host memory: consumers (pandas' ``from_dataframe``, pyarrow)
read ``Buffer.ptr`` as a host address, so ``__dlpack_device__`` reports the
CPU.  Floats carry NaN for missing values, ints and bools are not nullable,
and datetimes export the int64 NaT sentinel, the protocol's USE_SENTINEL.
"""

from __future__ import annotations

import enum
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import pandas

# device columns without a host copy that producers fetched to the host
COLUMN_FETCHES = 0


class DtypeKind(enum.IntEnum):
    INT = 0
    UINT = 1
    FLOAT = 2
    BOOL = 20
    STRING = 21
    DATETIME = 22
    CATEGORICAL = 23


class ColumnNullType(enum.IntEnum):
    NON_NULLABLE = 0
    USE_NAN = 1
    USE_SENTINEL = 2
    USE_BITMASK = 3
    USE_BYTEMASK = 4


_NP_TO_ARROW_FMT = {
    "int8": "c", "int16": "s", "int32": "i", "int64": "l",
    "uint8": "C", "uint16": "S", "uint32": "I", "uint64": "L",
    "float32": "f", "float64": "g", "bool": "b",
}

_NAT = np.iinfo(np.int64).min


class TorchBuffer:
    """Protocol buffer over a (host) numpy array — zero-copy view."""

    def __init__(self, array: np.ndarray, allow_copy: bool = True):
        if not array.flags.c_contiguous:
            if not allow_copy:
                raise RuntimeError(
                    "non-contiguous buffer requires a copy (allow_copy=False)"
                )
            array = np.ascontiguousarray(array)
        self._array = array

    @property
    def bufsize(self) -> int:
        return self._array.nbytes

    @property
    def ptr(self) -> int:
        return self._array.__array_interface__["data"][0]

    def __dlpack__(self):
        return self._array.__dlpack__()

    def __dlpack_device__(self) -> Tuple[int, int]:
        return (1, 0)  # kDLCPU

    def __repr__(self) -> str:
        return f"TorchBuffer(size={self.bufsize}, ptr={self.ptr:#x})"


class TorchColumnXchg:
    """Protocol column over one TorchDataframe column."""

    def __init__(self, column: Any, allow_copy: bool = True, fetched: Optional[dict] = None):
        self._column = column
        self._allow_copy = allow_copy
        # the producer's host values by column, shared by its columns
        self._fetched = {} if fetched is None else fetched

    def _data(self) -> np.ndarray:
        global COLUMN_FETCHES
        values = self._fetched.get(self._column)
        if values is None:
            # to_numpy hands over host_cache as it is; a computed column
            # comes over once
            if self._column.host_cache is None:
                COLUMN_FETCHES += 1
            values = self._fetched[self._column] = self._column.to_numpy()
        return values

    def size(self) -> int:
        return self._column.length

    @property
    def offset(self) -> int:
        return 0

    @property
    def dtype(self) -> Tuple[DtypeKind, int, str, str]:
        dt = np.dtype(self._column.pandas_dtype)
        if dt.kind == "M":
            unit = np.datetime_data(dt)[0]
            return (DtypeKind.DATETIME, 64, f"ts{unit[0]}:", "=")
        if dt.kind == "m":
            unit = np.datetime_data(dt)[0]
            return (DtypeKind.DATETIME, 64, f"tD{unit[0]}", "=")
        kind = {
            "i": DtypeKind.INT, "u": DtypeKind.UINT, "f": DtypeKind.FLOAT,
            "b": DtypeKind.BOOL,
        }[dt.kind]
        # numpy's byte order, as pandas' producer gives it ("|" for one byte)
        return (kind, dt.itemsize * 8, _NP_TO_ARROW_FMT[dt.name], dt.byteorder)

    @property
    def describe_categorical(self) -> dict:
        raise TypeError("not a categorical column")

    @property
    def describe_null(self) -> Tuple[int, Any]:
        dt = np.dtype(self._column.pandas_dtype)
        if dt.kind == "f":
            return (ColumnNullType.USE_NAN, None)
        if dt.kind in "mM":
            return (ColumnNullType.USE_SENTINEL, _NAT)
        return (ColumnNullType.NON_NULLABLE, None)

    @property
    def null_count(self) -> int:
        dt = np.dtype(self._column.pandas_dtype)
        if dt.kind == "f":
            return int(np.isnan(self._data()).sum())
        if dt.kind in "mM":
            return int((self._data().view("int64") == _NAT).sum())
        return 0

    @property
    def metadata(self) -> Dict[str, Any]:
        return {}

    def num_chunks(self) -> int:
        return 1

    def get_chunks(self, n_chunks: Optional[int] = None) -> Iterable["TorchColumnXchg"]:
        yield self

    def get_buffers(self) -> Dict[str, Any]:
        values = self._data()
        if values.dtype.kind in "mM":
            values = values.view("int64")
        return {
            "data": (TorchBuffer(values, self._allow_copy), self.dtype),
            "validity": None,
            "offsets": None,
        }


class TorchDataFrameXchg:
    """Protocol dataframe over a TorchDataframe (lazy, per-column buffers)."""

    version = 0

    def __init__(
        self,
        modin_frame: Any,
        nan_as_null: bool = False,
        allow_copy: bool = True,
    ):
        self._frame = modin_frame
        self._nan_as_null = nan_as_null
        self._allow_copy = allow_copy
        # host values of the device columns fetched so far, by column
        # object (which the dict keeps alive, so no key is reused); the
        # producers that ``__dataframe__`` and a column selection make
        # share it
        self._fetched: dict = {}

    def __dataframe__(self, nan_as_null: bool = False, allow_copy: bool = True):
        producer = TorchDataFrameXchg(self._frame, nan_as_null, allow_copy)
        producer._fetched = self._fetched
        return producer

    @property
    def metadata(self) -> Dict[str, Any]:
        # consumers (pandas included) restore the index from "pandas.index"
        return {"pandas.index": self._frame.index}

    def num_columns(self) -> int:
        return self._frame.num_cols

    def num_rows(self) -> int:
        return len(self._frame)

    def num_chunks(self) -> int:
        return 1

    def column_names(self) -> List[Any]:
        return list(self._frame.columns)

    def _make_column(self, position: int):
        col = self._frame._columns[position]
        if col.is_device:
            return TorchColumnXchg(col, self._allow_copy, self._fetched)
        # host (string/categorical/extension) columns: pandas' own protocol
        # column handles variable-width layouts; one column, not the frame
        label = self._frame.columns[position]
        data = col.data
        if isinstance(data, np.ndarray) and data.dtype == object:
            data = pandas.Series(data, dtype=object)  # pandas 3 would infer str
        return (
            pandas.DataFrame({label: data})
            .__dataframe__(self._nan_as_null, self._allow_copy)
            .get_column(0)
        )

    def get_column(self, i: int):
        return self._make_column(i)

    def get_column_by_name(self, name: str):
        positions = self._frame.column_position(name)
        return self._make_column(positions[0])

    def get_columns(self) -> List[Any]:
        return [self._make_column(i) for i in range(self._frame.num_cols)]

    def select_columns(self, indices: Sequence[int]) -> "TorchDataFrameXchg":
        selected = TorchDataFrameXchg(
            self._frame.select_columns_by_position([int(i) for i in indices]),
            self._nan_as_null,
            self._allow_copy,
        )
        selected._fetched = self._fetched
        return selected

    def select_columns_by_name(self, names: Sequence[str]) -> "TorchDataFrameXchg":
        positions = [self._frame.column_position(n)[0] for n in names]
        return self.select_columns(positions)

    def get_chunks(self, n_chunks: Optional[int] = None) -> Iterable["TorchDataFrameXchg"]:
        if not n_chunks or n_chunks <= 1:
            yield self
            return
        # the spec requires EXACTLY n_chunks chunks (trailing ones may be
        # short or empty), matching the pandas producer's stepping
        n = len(self._frame)
        step = n // n_chunks
        if n % n_chunks:
            step += 1
        for start in range(0, max(step, 1) * n_chunks, max(step, 1)):
            yield TorchDataFrameXchg(
                self._frame.take_rows_positional(slice(start, min(start + step, n))),
                self._nan_as_null,
                self._allow_copy,
            )
