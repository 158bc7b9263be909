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

pandas is imported only inside :func:`column_of_series` (and so
:meth:`TorchDataframe.from_pandas`), :meth:`TorchDataframe.to_pandas` and
:meth:`TorchDataframe.to_numpy_stacked`; :meth:`TorchDataframe.from_numpy_columns`
builds a frame from numpy arrays without it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from modin_tpu_torch.logging import ClassLogger
from modin_tpu_torch.core import memory
from modin_tpu_torch.core.dataframe.torch.metadata import LazyIndex
from modin_tpu_torch.ops.lazy import LazyExpr, is_lazy, materialize, materialize_exprs
from modin_tpu_torch.parallel.engine import TorchWrapper
from modin_tpu_torch.utils import has_torch_dtype, numpy_dtype, torch_dtype


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
    """One column as a 1-D tensor on the frame's device, or as a deferred
    expression over such tensors (:class:`~modin_tpu_torch.ops.lazy.
    LazyExpr`) until a consumer needs its values: ``data`` materializes
    it, ``raw`` hands it over as it is, so a chain can grow or fold into a
    reduction.

    ``host_cache`` keeps the original host numpy array of a column that came
    from the host unchanged: ``to_numpy`` answers from it without a device
    fetch.  Any computed column has none until it spills.  ``_sorted_rep``
    holds the column's sorted representation once a sort-shaped reduction
    built it (``ops/sorted_cache.py``); replacing ``data`` drops it.
    ``_view_token``/``_view_parent`` are the column's identity in the
    derived-artifact registry (``views/registry.py``) and its append link;
    every change of the tensor drops the artifacts under the token
    (:meth:`_invalidate_derived`).

    The memory protocol (``core/memory.py``, the JAX column's): a concrete
    tensor registers with the device ledger at construction, a deferred one
    when it materializes, and ``host_cache`` with the host ledger; the
    device ledger's LRU order is the order of registration (a read does not
    refresh it; a restore does).  The same registration stamps the tensor's
    device epoch (``_device_epoch``) and attaches the column's ``lineage``
    record (``core/execution/recovery.py``): how a re-seat makes the tensor
    again after a device loss.  A
    **spilled** column (``_data is None``) keeps an exact host copy and
    restores on its next ``data``/``raw`` read through ``TorchWrapper.put``,
    which admits first.  A column a fused launch consumed is ``donated``:
    spilled the same way, after the launch was enqueued.
    """

    __slots__ = (
        "_data", "pandas_dtype", "length", "host_cache", "_sorted_rep", "_ledger_key", "_dev_key",
        "donated", "_home", "_view_token", "_view_parent", "lineage", "_device_epoch", "__weakref__",
    )
    is_device = True
    is_derived_cache = False

    def __init__(
        self,
        data: torch.Tensor,
        pandas_dtype: np.dtype,
        length: Optional[int] = None,
        host_cache: Optional[np.ndarray] = None,
    ):
        self._data = data
        self._sorted_rep = None
        self._view_token = None
        self._view_parent = None
        self.pandas_dtype = np.dtype(pandas_dtype)
        self.length = int(length) if length is not None else int(data.shape[0])
        self.host_cache = host_cache
        self._ledger_key = None
        self._dev_key = None
        self.donated = False
        # (torch dtype, device) of a spilled column's tensor
        self._home = None
        self.lineage = None
        self._device_epoch = 0
        if host_cache is not None:
            memory.ledger.register(self)
        if isinstance(data, torch.Tensor):
            self._register_device()

    @property
    def data(self) -> torch.Tensor:
        if self._data is None:
            self._restore()
        elif isinstance(self._data, LazyExpr):
            self._adopt(materialize(self._data))
        return self._data

    @property
    def raw(self) -> Any:
        """The tensor or the deferred expression, unmaterialized (a spilled
        column restores first)."""
        if self._data is None:
            self._restore()
        return self._data

    @property
    def is_lazy(self) -> bool:
        return is_lazy(self._data)

    @property
    def is_spilled(self) -> bool:
        """The tensor was dropped; ``host_cache`` is the exact only copy."""
        return self._data is None

    @property
    def dtype(self) -> torch.dtype:
        """The torch dtype of the values (a lazy column's without computing,
        a spilled one's without restoring)."""
        return self._home[0] if self._data is None else self._data.dtype

    @property
    def device(self) -> torch.device:
        return self._home[1] if self._data is None else self._data.device

    @data.setter
    def data(self, value: torch.Tensor) -> None:
        memory.ledger.forget(self)
        self.host_cache = None
        self.lineage = None
        self._adopt(value)

    def _adopt(self, value: Any) -> None:
        """Take ``value`` as the column's values: a materialized expression's
        tensor, a restored or re-seated one, or a replacement.  The sorted
        representation and the old tensor's ledger entry go; a concrete
        tensor registers."""
        memory.device_ledger.deregister(self)
        self._invalidate_derived()
        self._data = value
        self._home = None
        self.donated = False
        if isinstance(value, torch.Tensor):
            self._register_device()

    def _register_device(self) -> None:
        """Track the concrete tensor in the device ledger, stamp the current
        device epoch, index the tensor for op replay and attach the lineage
        record where the column has none yet."""
        from modin_tpu_torch.core.execution import recovery

        memory.device_ledger.register(self)
        self._device_epoch = recovery.current_epoch()
        recovery.note_column_data(self)
        if self.lineage is None:
            recovery.attach_lineage(self)

    # -- spill, restore, donation ------------------------------------------ #

    def _exact_shape(self) -> bool:
        return isinstance(self._data, torch.Tensor) and self._data.shape[0] == self.length

    def _invalidate_derived(self) -> None:
        """Drop every derived cache answering for this column's tensor, which
        is about to change (spill, restore, materialization, donation,
        replacement): the sorted representation and the registry's
        artifacts under the column's token."""
        if self._sorted_rep is not None:
            from modin_tpu_torch.ops import sorted_cache

            sorted_cache.invalidate(self)
        if self._view_token is not None:
            from modin_tpu_torch.views import registry

            registry.invalidate_column(self, reason="buffer")

    def _drop_tensor(self) -> int:
        self._invalidate_derived()
        freed = memory.device_ledger.deregister(self)
        self._home = (self._data.dtype, self._data.device)
        self._data = None
        return freed

    def spill(self) -> int:
        """Drop the tensor, keeping an exact host copy (fetched when the
        column has none); returns the device bytes the ledger got back (0
        when the column cannot spill now: deferred, already spilled, or a
        tensor longer than the column)."""
        if not self._exact_shape():
            return 0
        cache = self.host_cache
        if cache is None:
            nbytes = int(self._data.numel() * self._data.element_size())
            cache = memory.timed_copy("memory.device.spill_copy", self.to_numpy)
            memory.count("memory.device.spill_copy")
            memory.count("memory.device.spill_copy_bytes", nbytes)
        # the tensor goes first: a tight host budget must see the column
        # spilled, or it could drop the only copy as it registers
        freed = self._drop_tensor()
        if self.host_cache is None:
            self.host_cache = cache
            memory.ledger.register(self)
        return freed

    def _restore(self) -> None:
        """Upload a spilled column's host copy as a fresh tensor."""
        if self.host_cache is None:
            if self.donated:
                from modin_tpu_torch.core.execution.resilience import DONATED_MARKER

                raise RuntimeError(f"the column's tensor {DONATED_MARKER} and it has no host copy")
            raise RuntimeError("spilled DeviceColumn has no host copy to restore from")
        was_donated = self.donated
        memory.timed_copy("memory.device.restore", self.reseat_from_host)
        memory.count("memory.device.restore")
        memory.count("memory.device.restore_bytes", self._data.numel() * self._data.element_size())
        if was_donated:
            memory.count("fuse.donated_restore")

    def donation_eligible(self) -> bool:
        """The local half of the donation proof: a concrete tensor of the
        column's own length with an exact host copy to restore from."""
        return self._exact_shape() and self.host_cache is not None

    def donation_safe(self) -> bool:
        """:meth:`donation_eligible`, and the device ledger's proof that no
        other live column holds the same storage."""
        return self.donation_eligible() and memory.device_ledger.buffer_consumers(self._data) == 1

    def mark_donated(self) -> int:
        """A fused launch consumed this column's tensor: drop it (after the
        launch was enqueued: the caching allocator reuses the storage only
        in the current stream's order), keep the host copy authoritative;
        the next read restores.  Returns the bytes the ledger got back."""
        if not self._exact_shape():
            return 0
        freed = self._drop_tensor()
        self.donated = True
        return freed

    def reseat_from_host(self) -> None:
        """Upload the exact host copy as a fresh tensor (a restore, and the
        ``host`` lineage's re-seat), on the column's own device."""
        values = self.host_cache  # one read: the host ledger may drop it
        if values is None:
            raise RuntimeError("no host copy to re-seat from")
        dtype, device = self._home if self._data is None else (self._data.dtype, self._data.device)
        device_values = values.view("int64") if values.dtype.kind in "mM" else values
        t = TorchWrapper.put(np.ascontiguousarray(device_values), device)
        self._adopt(t if t.dtype == dtype else t.to(dtype))

    def adopt_host_cache(self, values: np.ndarray, drop_tensor: bool = False) -> None:
        """Take ``values`` as the exact host copy, registered with the host
        ledger; ``drop_tensor`` drops the (lost) tensor first, so the copy
        counts as the only one while it registers."""
        if drop_tensor and isinstance(self._data, torch.Tensor):
            self._drop_tensor()
        memory.ledger.forget(self)
        self.host_cache = values
        memory.ledger.register(self)

    def host_checkpoint(self) -> None:
        """Keep an exact host copy (a lineage depth cut): one fetch now makes
        the column recoverable at depth 0 from then on."""
        if self.host_cache is None:
            self.adopt_host_cache(self.to_numpy())

    @classmethod
    def from_numpy(cls, values: np.ndarray, device: Optional[torch.device] = None) -> "DeviceColumn":
        device_values = values.view("int64") if values.dtype.kind in "mM" else values
        return cls(
            TorchWrapper.put(np.ascontiguousarray(device_values), device),
            values.dtype,
            length=len(values),
            host_cache=values,
        )

    @classmethod
    def spilled(cls, values: np.ndarray, device: Optional[torch.device] = None) -> "DeviceColumn":
        """A column born spilled: ``values`` (exact) is its only copy until a
        read restores it to ``device`` (an out-of-core result claims no
        device memory until a consumer reads it)."""
        if device is None:
            from modin_tpu_torch.parallel.mesh import get_device

            device = get_device()
        col = cls(None, values.dtype, length=len(values), host_cache=values)
        col._home = (torch_dtype(np.dtype("int64") if values.dtype.kind in "mM" else values.dtype), device)
        return col

    def to_numpy(self) -> np.ndarray:
        cache = self.host_cache
        if cache is not None:
            memory.ledger.touch(self)
            return cache
        try:
            values = TorchWrapper.materialize(self.data)
        except Exception as err:  # recover_for_read re-seats on a classified DeviceLost only; anything else re-raises
            from modin_tpu_torch.core.execution.recovery import recover_for_read

            if not recover_for_read(self, err):
                raise
            # the column was re-seated from its lineage: fetch once more
            values = TorchWrapper.materialize(self.data)
        return self.host_values(values[: self.length])

    def host_values(self, values: np.ndarray) -> np.ndarray:
        """Fetched device values in the column's pandas dtype."""
        if self.pandas_dtype.kind in "mM":
            return values.view(self.pandas_dtype)
        if values.dtype != self.pandas_dtype:
            values = values.astype(self.pandas_dtype)
        return values


class HostColumn:
    """One column kept on the host (object/string/categorical/extension
    dtypes and numeric dtypes without a tensor form).

    ``_dict_cache``/``_cat_cache`` hold the column's dictionary encoding once
    a device path built it (``ops/dictionary.py``): the codes on the device,
    the categories here.  A new column (a filter's, a sort's) encodes anew.
    """

    __slots__ = ("data", "_dict_cache", "_cat_cache", "__weakref__")
    is_device = False

    def __init__(self, data: Any):
        # data: 1-D numpy array or pandas ExtensionArray
        self.data = data
        self._dict_cache = None
        self._cat_cache = None

    @property
    def pandas_dtype(self) -> Any:
        return self.data.dtype

    @property
    def length(self) -> int:
        return len(self.data)

    def to_numpy(self) -> np.ndarray:
        return np.asarray(self.data)


Column = Union[DeviceColumn, HostColumn]


def column_of_series(series: Any, device: Optional[torch.device] = None) -> Column:
    """A frame column of a copy of a pandas Series: on the device where its
    dtype can live, else on the host."""
    import pandas

    if _is_device_dtype(series.dtype):
        return DeviceColumn.from_numpy(series.to_numpy(), device)
    arr = series.array.copy()
    if isinstance(arr, pandas.arrays.NumpyExtensionArray):
        # store the raw ndarray: NumpyEADtype('object') fails == against
        # np.dtype(object)
        arr = np.asarray(arr)
    return HostColumn(arr)


class TorchDataframe(ClassLogger, modin_layer="CORE-FRAME"):
    """Columnar frame: host metadata + device/host column store.

    ``_blocks`` is None, or for each column the number of the pandas block
    that held it in the frame ``from_pandas`` was given (row selections and
    column subsets keep it): pandas picks some result dtypes per block, not
    per column (a grouped sum of narrow ints widens a whole block), and the
    port follows it where it knows the layout.
    """

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
        self._blocks: Optional[List[int]] = None

    # ------------------------------------------------------------------ #
    # Construction / materialization
    # ------------------------------------------------------------------ #

    @classmethod
    def from_pandas(cls, df: Any, device: Optional[torch.device] = None) -> "TorchDataframe":
        import pandas

        from modin_tpu_torch.core.execution.resilience import DeviceFailure
        from modin_tpu_torch.parallel.mesh import get_device

        columns = []
        for i in range(df.shape[1]):
            series = df.iloc[:, i]
            try:
                columns.append(column_of_series(series, device))
            except DeviceFailure:
                # the upload failed past the seam's own recovery (counted
                # there).  On the card that raises: no column stays on the
                # host in the device's place.  On the CPU it stays on the
                # host, where pandas answers, as in the JAX package
                if (device if device is not None else get_device()).type == "cuda":
                    raise
                columns.append(HostColumn(series.to_numpy()))
        frame = cls(columns, df.columns, df.index, nrows=len(df))
        blknos = getattr(getattr(df, "_mgr", None), "blknos", None)
        if blknos is not None and len(blknos) == len(columns):
            frame._blocks = [int(b) for b in blknos]
        return frame

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

    def materialize_device(self, positions: Optional[Sequence[int]] = None) -> None:
        """Materialize the deferred device columns (those at ``positions``,
        or all) in one fused run: a multi-column consumer calls this before
        touching ``data``, so N lazy columns cost one launch, not N."""
        cols = self._columns if positions is None else [self._columns[i] for i in positions]
        lazy_cols = [c for c in cols if c.is_device and c.is_lazy]
        if not lazy_cols:
            return
        for col, value in zip(lazy_cols, materialize_exprs([c.raw for c in lazy_cols])):
            col._adopt(value)

    def device_datas(self, positions: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
        """The values of the device columns at ``positions`` (or all), the
        deferred ones materialized together in one fused run: what a
        consumer of several columns' values takes."""
        positions = list(range(len(self._columns))) if positions is None else list(positions)
        self.materialize_device(positions)
        return [self._columns[i].data for i in positions]

    def to_pandas(self) -> Any:
        self.materialize_device()
        return self._assemble_pandas(
            {i: c.to_numpy() for i, c in enumerate(self._columns) if c.is_device},
            slice(None),
            self.index,
        )

    def to_numpy_stacked(self) -> Optional[np.ndarray]:
        """The frame as ``pandas.DataFrame.to_numpy()`` gives it, stacked on
        the device in pandas' common dtype and fetched in one
        device-to-host copy; None where the device cannot give pandas'
        array (a host or datetime column, a common dtype without a tensor
        form: object for bools beside numbers, uint64)."""
        from pandas.core.dtypes.cast import find_common_type

        cols = self._columns
        if not cols or not all(c.is_device and c.pandas_dtype.kind in "biuf" for c in cols):
            return None
        common = find_common_type([c.pandas_dtype for c in cols])
        if not isinstance(common, np.dtype) or not has_torch_dtype(common):
            return None
        datas = self.device_datas()
        stacked = torch.empty(
            (len(self), len(cols)), dtype=torch_dtype(common), device=datas[0].device
        )
        for i, data in enumerate(datas):
            stacked[:, i] = data  # casts as numpy's astype does
        host = TorchWrapper.materialize(stacked)
        del stacked, datas
        return host

    def window_to_pandas(self, start: int, stop: int) -> Any:
        """Rows ``[start, stop)`` as a pandas DataFrame.  The device columns
        without a host copy come over together, in one device-to-host copy
        of their bytes; the others are sliced on the host."""
        self.materialize_device()
        fetch = [
            i for i, c in enumerate(self._columns) if c.is_device and c.host_cache is None
        ]
        values = {
            i: c.host_cache[start:stop]
            for i, c in enumerate(self._columns)
            if c.is_device and c.host_cache is not None
        }
        if fetch:
            parts = [
                self._columns[i].data[start:stop].contiguous().view(torch.uint8)
                for i in fetch
            ]
            host = TorchWrapper.materialize(torch.cat(parts))
            offset = 0
            for i, part in zip(fetch, parts):
                col = self._columns[i]
                raw = host[offset: offset + part.numel()]
                offset += part.numel()
                values[i] = col.host_values(raw.view(numpy_dtype(col.data.dtype)))
        return self._assemble_pandas(values, slice(start, stop), self.index[start:stop])

    def _assemble_pandas(self, device_values: Dict[int, np.ndarray], rows: slice, idx: Any) -> Any:
        """A pandas DataFrame of the host values of the device columns and
        the ``rows`` of the host columns, with row labels ``idx``."""
        import pandas

        data = {}
        for i, col in enumerate(self._columns):
            if col.is_device:
                data[i] = device_values[i]
            else:
                arr = col.data[rows]
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
        frame = TorchDataframe(
            [self._columns[i] for i in positions],
            [labels[i] for i in positions],
            self._index,
        )
        if self._blocks is not None:
            frame._blocks = [self._blocks[i] for i in positions]
        return frame

    def _same_layout(self, frame: "TorchDataframe") -> "TorchDataframe":
        """``frame`` (this frame's rows, selected) with this frame's blocks."""
        frame._blocks = self._blocks
        return frame

    # ------------------------------------------------------------------ #
    # Row selection and concatenation
    #
    # A column a selection produces carries no host cache: the JAX package
    # gathers the host copy beside the device one, host work that the query
    # would pay for every row.  ``to_pandas`` fetches such a column instead.
    # A concatenation keeps the parts' host copies, as the JAX package does.
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

        self.materialize_device()
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
        return self._same_layout(self.with_columns(new_columns, index=new_index, nrows=n_out))

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
        # a lazy mask and the lazy columns materialize in one fused run
        mask, *values = materialize_exprs([mask] + [self._columns[i].raw for i in device_idx])
        for i, value in zip(device_idx, values):
            if self._columns[i].raw is not value:
                self._columns[i]._adopt(value)
        datas, _, positions = compact_rows(values, mask, len(self))
        return self._with_gathered(device_idx, datas, positions)

    def take_rows_device(self, positions: torch.Tensor, index: Optional[LazyIndex] = None) -> "TorchDataframe":
        """Rows by a device positions tensor (a sort's permutation).
        ``index`` replaces the row labels; by default they are this frame's,
        taken lazily."""
        from modin_tpu_torch.ops.structural import gather_columns_device

        self.materialize_device()
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
        return self._same_layout(self.with_columns(new_columns, index=index, nrows=n_out))

    def concat_rows(self, others: List["TorchDataframe"]) -> "TorchDataframe":
        """Row-wise concat of frames whose columns line up one to one with
        equal dtypes; the row labels append lazily.  Device columns of one
        torch dtype concatenate on the device and keep the concatenated host
        copy where every part has one; the others concatenate with numpy in
        their exact dtype.  Under ``ViewsMode`` Auto each device column is
        linked to its first part (``views/registry.note_append``: artifacts
        of the part fold only the appended rows), and a host string column
        whose first part holds a dictionary encoding gets it extended by the
        tail's codes."""
        from modin_tpu_torch import views
        from modin_tpu_torch.ops.structural import concat_columns

        frames = [self, *others]
        for f in frames:
            f.materialize_device()
        lengths = [len(f) for f in frames]
        total = sum(lengths)
        device_cis = [
            ci for ci in range(self.num_cols)
            if all(f._columns[ci].is_device for f in frames)
            and len({f._columns[ci].dtype for f in frames}) == 1
        ]
        new_columns: List[Any] = [None] * self.num_cols
        if device_cis:
            datas, _ = concat_columns(
                [[f._columns[ci].data for ci in device_cis] for f in frames], lengths
            )
            for ci, d in zip(device_cis, datas):
                parts = [f._columns[ci] for f in frames]
                # one read each: the host ledger may drop a copy meanwhile
                caches = [c.host_cache for c in parts]
                cache = np.concatenate(caches) if all(c is not None for c in caches) else None
                new_col = DeviceColumn(d, parts[0].pandas_dtype, length=total, host_cache=cache)
                if views.VIEWS_ON:
                    from modin_tpu_torch.views import registry

                    registry.note_append(new_col, parts[0])
                new_columns[ci] = new_col
        for ci in range(self.num_cols):
            if new_columns[ci] is None:
                new_columns[ci] = _concat_values([f._columns[ci] for f in frames], lengths[0])
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
        """Materialize the deferred columns and block until device work for
        this frame completes."""
        self.materialize_device()
        TorchWrapper.wait()


def _concat_values(parts: List[Column], head: int) -> Column:
    """One column of ``concat_rows`` through numpy: device parts of unlike
    torch dtypes, or host parts, whose pandas dtype is kept exactly (a new
    inference would turn pandas 3's ``str`` into the ``string`` dtype).
    ``head`` is the first part's length."""
    import pandas

    from modin_tpu_torch import views

    values = np.concatenate([np.asarray(c.to_numpy()) for c in parts])
    if all(c.is_device for c in parts):
        return DeviceColumn.from_numpy(values, parts[0].device)
    dtypes = {c.pandas_dtype for c in parts}
    arr = pandas.array(values, dtype=dtypes.pop()) if len(dtypes) == 1 else pandas.array(values)
    if isinstance(arr, pandas.arrays.NumpyExtensionArray):
        # the raw ndarray, as column_of_series stores it: NumpyEADtype
        # ('object') fails == against np.dtype(object), so a chained concat
        # would fail its dtype check
        arr = np.asarray(arr)
    col = HostColumn(arr)
    if views.VIEWS_ON and parts[0]._dict_cache not in (None, False):
        # the first part paid its factorization: extend its code table by
        # the tail's instead of encoding every row again at the next use
        from modin_tpu_torch.views import registry
        from modin_tpu_torch.views.incremental import extend_dict_encoding

        ext = extend_dict_encoding(parts[0], values[head:])
        if ext is not None:
            col._dict_cache = ext
            registry.count("view.fold")
    return col


def _label_eq(a: Any, b: Any) -> bool:
    try:
        return bool(a == b)
    except (TypeError, ValueError):
        return False
