"""``TorchDataframe`` — the columnar core frame on one torch device.

The port's counterpart of ``modin_tpu/core/dataframe/tpu/dataframe.py``.  A
frame is:

- host metadata: column labels (a pandas Index or a plain list), a lazy row
  index (:class:`LazyIndex`), per-column logical dtypes;
- per column, either a **DeviceColumn** (a 1-D torch tensor on the frame's
  device) or a **HostColumn** (numpy/extension array for object, string and
  other dtypes that have no tensor form).

One device holds every column whole: no sharding, no row padding.
Datetimes/timedeltas live on the device as int64 with a logical-dtype tag;
NaT is the int64 min sentinel, pandas' own representation.

pandas is imported only inside :meth:`TorchDataframe.from_pandas` and
:meth:`TorchDataframe.to_pandas`; :meth:`TorchDataframe.from_numpy_columns`
builds a frame from numpy arrays without it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from modin_tpu_torch.core.dataframe.torch.metadata import LazyIndex
from modin_tpu_torch.parallel.engine import TorchWrapper
from modin_tpu_torch.utils import has_torch_dtype


def _is_device_dtype(dtype: Any) -> bool:
    """Whether a pandas dtype can live on the device."""
    if not isinstance(dtype, np.dtype):
        return False
    if dtype.kind in "biuf" and has_torch_dtype(dtype):
        return True
    # naive datetime64/timedelta64 (any unit) as int64 + logical tag; the NaT
    # sentinel (int64 min) is unit-independent
    return dtype.kind in "mM" and dtype.itemsize == 8


class DeviceColumn:
    """One column as a 1-D tensor on the frame's device.

    ``host_cache`` keeps the original host numpy array of a column that came
    from the host unchanged: ``to_numpy`` answers from it without a device
    fetch.  Any computed column has none.
    """

    __slots__ = ("data", "pandas_dtype", "length", "host_cache")
    is_device = True

    def __init__(
        self,
        data: torch.Tensor,
        pandas_dtype: np.dtype,
        length: Optional[int] = None,
        host_cache: Optional[np.ndarray] = None,
    ):
        self.data = data
        self.pandas_dtype = np.dtype(pandas_dtype)
        self.length = int(length) if length is not None else int(data.shape[0])
        self.host_cache = host_cache

    @classmethod
    def from_numpy(cls, values: np.ndarray, device: Optional[torch.device] = None) -> "DeviceColumn":
        device_values = values.view("int64") if values.dtype.kind in "mM" else values
        return cls(
            TorchWrapper.put(np.ascontiguousarray(device_values), device),
            values.dtype,
            length=len(values),
            host_cache=values,
        )

    def to_numpy(self) -> np.ndarray:
        if self.host_cache is not None:
            return self.host_cache
        values = TorchWrapper.materialize(self.data)[: self.length]
        if self.pandas_dtype.kind in "mM":
            return values.view(self.pandas_dtype)
        if values.dtype != self.pandas_dtype:
            values = values.astype(self.pandas_dtype)
        return values


class HostColumn:
    """One column kept on the host (object/string/categorical/extension
    dtypes and numeric dtypes without a tensor form)."""

    __slots__ = ("data",)
    is_device = False

    def __init__(self, data: Any):
        # data: 1-D numpy array or pandas ExtensionArray
        self.data = data

    @property
    def pandas_dtype(self) -> Any:
        return self.data.dtype

    @property
    def length(self) -> int:
        return len(self.data)

    def to_numpy(self) -> np.ndarray:
        return np.asarray(self.data)


Column = Union[DeviceColumn, HostColumn]


class TorchDataframe:
    """Columnar frame: host metadata + device/host column store."""

    def __init__(
        self,
        columns: List[Column],
        col_labels: Sequence[Any],
        index: Any = None,
        nrows: Optional[int] = None,
    ):
        self._columns = columns
        self._col_labels = col_labels
        if not isinstance(index, LazyIndex):
            if index is None and nrows is None:
                nrows = columns[0].length if columns else 0
            index = LazyIndex(index, nrows)
        self._index = index

    # ------------------------------------------------------------------ #
    # Construction / materialization
    # ------------------------------------------------------------------ #

    @classmethod
    def from_pandas(cls, df: Any, device: Optional[torch.device] = None) -> "TorchDataframe":
        import pandas

        columns: List[Column] = []
        for i in range(df.shape[1]):
            series = df.iloc[:, i]
            if _is_device_dtype(series.dtype):
                columns.append(DeviceColumn.from_numpy(series.to_numpy(), device))
            else:
                arr = series.array.copy()
                if isinstance(arr, pandas.arrays.NumpyExtensionArray):
                    # store the raw ndarray: NumpyEADtype('object') fails ==
                    # against np.dtype(object)
                    arr = np.asarray(arr)
                columns.append(HostColumn(arr))
        return cls(columns, df.columns, df.index, nrows=len(df))

    @classmethod
    def from_numpy_columns(
        cls,
        columns: Dict[Any, np.ndarray],
        index: Any = None,
        device: Optional[torch.device] = None,
    ) -> "TorchDataframe":
        """Frame from ``{label: 1-D numpy array}``, the form that
        ``DeviceColumn.to_numpy()`` gives on either side of the port;
        ``index=None`` is the default range."""
        cols: List[Column] = []
        lengths = set()
        for values in columns.values():
            values = np.asarray(values)
            lengths.add(len(values))
            if _is_device_dtype(values.dtype):
                cols.append(DeviceColumn.from_numpy(values, device))
            else:
                cols.append(HostColumn(values))
        if len(lengths) > 1:
            raise ValueError(f"columns of unequal lengths {sorted(lengths)}")
        nrows = lengths.pop() if lengths else (0 if index is None else len(index))
        return cls(cols, list(columns), index, nrows=nrows)

    def to_pandas(self) -> Any:
        import pandas

        idx = self.index
        data = {}
        for i, col in enumerate(self._columns):
            if col.is_device:
                data[i] = col.to_numpy()
            else:
                arr = col.data
                if isinstance(arr, np.ndarray) and arr.dtype == object:
                    # an explicit-dtype Series is the only construction that
                    # round-trips object EXACTLY (pandas 3 infers str)
                    arr = pandas.Series(arr, index=idx, dtype=object)
                data[i] = arr
        df = pandas.DataFrame(data, index=idx, copy=False)
        df.columns = (
            self._col_labels
            if isinstance(self._col_labels, pandas.Index)
            else pandas.Index(list(self._col_labels))
        )
        return df

    # ------------------------------------------------------------------ #
    # Metadata
    # ------------------------------------------------------------------ #

    @property
    def index(self) -> Any:
        """The row labels as a pandas Index (imports pandas)."""
        return self._index.get()

    @property
    def columns(self) -> Sequence[Any]:
        return self._col_labels

    def __len__(self) -> int:
        if self._columns:
            return self._columns[0].length
        return len(self._index)

    @property
    def num_cols(self) -> int:
        return len(self._columns)

    def with_columns(
        self,
        columns: List[Column],
        col_labels: Optional[Sequence[Any]] = None,
        index: Any = None,
        nrows: Optional[int] = None,
    ) -> "TorchDataframe":
        return TorchDataframe(
            columns,
            col_labels if col_labels is not None else self._col_labels,
            index if index is not None else self._index,
            nrows=nrows,
        )

    def select_columns_by_position(self, positions: Sequence[int]) -> "TorchDataframe":
        labels = list(self._col_labels)
        return TorchDataframe(
            [self._columns[i] for i in positions],
            [labels[i] for i in positions],
            self._index,
        )

    # ------------------------------------------------------------------ #
    # Row selection and concatenation
    #
    # A column these produce carries no host cache: the JAX package gathers
    # the host copy beside the device one, host work that the query would
    # pay for every row.  ``to_pandas`` fetches such a column instead.
    # ------------------------------------------------------------------ #

    def take_rows_positional(self, positions: Any) -> "TorchDataframe":
        """Gather rows by position: a slice, or ints (negative from the end)."""
        n = len(self)
        if isinstance(positions, slice):
            positions = np.arange(*positions.indices(n), dtype=np.int64)
        else:
            positions = np.asarray(positions, dtype=np.int64)
            positions = np.where(positions < 0, positions + n, positions)
            if len(positions) and (positions.min() < 0 or positions.max() >= n):
                raise IndexError(f"positions out of bounds for {n} rows")
        return self._take_host_positions(positions)

    def _take_host_positions(self, pos_arr: np.ndarray) -> "TorchDataframe":
        from modin_tpu_torch.ops.structural import gather_columns

        device_idx = [i for i, c in enumerate(self._columns) if c.is_device]
        datas, n_out = gather_columns(
            [self._columns[i].data for i in device_idx], pos_arr
        )
        new_columns: List[Column] = list(self._columns)
        for i, d in zip(device_idx, datas):
            new_columns[i] = DeviceColumn(d, self._columns[i].pandas_dtype, length=n_out)
        for i, col in enumerate(self._columns):
            if not col.is_device:
                new_columns[i] = HostColumn(col.data.take(pos_arr))
        new_index = self._index.map_after(lambda idx: idx.take(pos_arr), n_out)
        return self.with_columns(new_columns, index=new_index, nrows=n_out)

    def filter_rows_mask(self, mask: np.ndarray) -> "TorchDataframe":
        """Boolean-mask rows with a host mask (its positions go to the
        device once, for every column's gather)."""
        mask = np.asarray(mask)
        if len(mask) != len(self):
            raise ValueError(f"Item wrong length {len(mask)} instead of {len(self)}.")
        return self._take_host_positions(np.nonzero(mask)[0])

    def filter_rows_mask_device(self, mask: torch.Tensor) -> "TorchDataframe":
        """Boolean-filter rows on the device with a device mask; the only
        host sync is the kept count."""
        from modin_tpu_torch.ops.structural import compact_rows

        device_idx = [i for i, c in enumerate(self._columns) if c.is_device]
        datas, _, positions = compact_rows(
            [self._columns[i].data for i in device_idx], mask, len(self)
        )
        return self._with_gathered(device_idx, datas, positions)

    def take_rows_device(self, positions: torch.Tensor, index: Optional[LazyIndex] = None) -> "TorchDataframe":
        """Rows by a device positions tensor (a sort's permutation).
        ``index`` replaces the row labels; by default they are this frame's,
        taken lazily."""
        from modin_tpu_torch.ops.structural import gather_columns_device

        device_idx = [i for i, c in enumerate(self._columns) if c.is_device]
        datas = gather_columns_device([self._columns[i].data for i in device_idx], positions)
        return self._with_gathered(device_idx, datas, positions, index)

    def _with_gathered(
        self,
        device_idx: List[int],
        datas: List[torch.Tensor],
        positions: torch.Tensor,
        index: Optional[LazyIndex] = None,
    ) -> "TorchDataframe":
        """This frame's rows at device ``positions``: ``datas`` are its
        device columns ``device_idx`` already gathered; host columns and
        the row labels fetch the positions once, when first needed."""
        n_out = int(positions.shape[0])
        new_columns: List[Column] = list(self._columns)
        for i, d in zip(device_idx, datas):
            new_columns[i] = DeviceColumn(d, self._columns[i].pandas_dtype, length=n_out)

        host_positions_cache: Dict[str, np.ndarray] = {}

        def host_positions() -> np.ndarray:
            if "pos" not in host_positions_cache:
                host_positions_cache["pos"] = TorchWrapper.materialize(positions)
            return host_positions_cache["pos"]

        for i, col in enumerate(self._columns):
            if not col.is_device:
                new_columns[i] = HostColumn(col.data.take(host_positions()))
        if index is None:
            index = self._index.map_after(lambda idx: idx.take(host_positions()), n_out)
        return self.with_columns(new_columns, index=index, nrows=n_out)

    def concat_rows(self, others: List["TorchDataframe"]) -> "TorchDataframe":
        """Row-wise concat of frames whose columns line up one to one with
        equal dtypes, all on the device; the row labels append lazily."""
        from modin_tpu_torch.ops.structural import concat_columns

        frames = [self, *others]
        for ci in range(self.num_cols):
            cols = [f._columns[ci] for f in frames]
            if not all(c.is_device for c in cols) or len({c.data.dtype for c in cols}) != 1:
                raise ValueError("concat_rows takes device columns of one dtype each")
        lengths = [len(f) for f in frames]
        datas, total = concat_columns(
            [[c.data for c in f._columns] for f in frames], lengths
        )
        new_columns: List[Column] = [
            DeviceColumn(d, c.pandas_dtype, length=total)
            for c, d in zip(self._columns, datas)
        ]
        lazies = [f._index for f in frames]

        def build_index() -> Any:
            return lazies[0].get().append([lz.get() for lz in lazies[1:]])

        return self.with_columns(
            new_columns, index=LazyIndex(build_index, total), nrows=total
        )

    def get_column(self, position: int) -> Column:
        return self._columns[position]

    def column_position(self, label: Any) -> List[int]:
        return [i for i, lab in enumerate(self._col_labels) if _label_eq(lab, label)]

    def finalize(self) -> None:
        """Block until device work for this frame completes."""
        TorchWrapper.wait()


def _label_eq(a: Any, b: Any) -> bool:
    try:
        return bool(a == b)
    except (TypeError, ValueError):
        return False
