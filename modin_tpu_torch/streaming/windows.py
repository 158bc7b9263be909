"""Window planning and parsing for the streaming executor.

The port's counterpart of ``modin_tpu/streaming/windows.py``.  A
:class:`WindowSource` cuts one CSV-family source into record-aligned byte
ranges with the parallel reader's machinery (``core/io/chunker.py``):
``find_header_end`` finds the header, ``split_record_ranges`` cuts the body
at record boundaries near the window's byte target, and each window parses
as one of ``_read_parallel``'s body ranges does (``header=None`` and the
full column ``names`` learned once from the header, so a ``usecols``
projection, the planner's pushed pruning among them, applies per window).
A window goes to the device through ``from_pandas`` at its exact row count:
the port pads nothing (the reference pads each window to a power-of-two
bucket so that XLA reuses one program per bucket).

Window size: ``MODIN_TPU_TORCH_STREAM_WINDOW_BYTES`` where set, else
derived from the device budget so that ``1 + prefetch`` resident windows
and a 2x kernel working set fit under it: ``budget // (2 * 4 * (1 +
prefetch))`` (a numeric CSV value parses to at most 4 device bytes a
source byte).
"""

from __future__ import annotations

import io
from typing import Any, List, Optional, Tuple

from modin_tpu_torch.core.io.chunker import find_header_end, split_record_ranges
from modin_tpu_torch.logging.metrics import emit_counted, emit_metric

_count = emit_counted

#: the least derived window: below it a window's parse and launch overheads
#: outweigh what the budget saves (a tighter budget still streams, at this
#: size)
_MIN_WINDOW_BYTES = 1 << 16

#: device bytes a source byte of numeric CSV text can parse to: a value is
#: at most 8 bytes parsed and at least 2 bytes of text ("0," or "0\n");
#: string columns stay on the host and never count against the device
_PARSE_EXPANSION = 4

#: reader kwargs that never reach a body range's parse (as _read_parallel)
_BODY_DROP = ("iterator", "chunksize", "skiprows", "nrows")


def window_bytes_for(prefetch: int) -> int:
    """The source bytes of one window under the current settings: ``1 +
    prefetch`` windows resident at once, each at most ``_PARSE_EXPANSION``
    device bytes a source byte, with a 2x allowance for the consuming
    kernel's working set (masks, compacted copies)."""
    from modin_tpu_torch.config import DeviceMemoryBudget, StreamWindowBytes

    explicit = int(StreamWindowBytes.get())
    if explicit > 0:
        return explicit
    budget = DeviceMemoryBudget.get()
    if budget is None:
        return _MIN_WINDOW_BYTES
    windows_resident = 1 + max(int(prefetch), 0)
    return max(budget // (2 * _PARSE_EXPANSION * windows_resident), _MIN_WINDOW_BYTES)


def streamable_read_kwargs(dispatcher: type, kwargs: dict) -> Optional[dict]:
    """The normalized reader kwargs where this read can stream, else None:
    a plain local file whose kwargs the record-aligned chunker honors
    exactly (the parallel reader's ``_can_parallelize``)."""
    can = getattr(dispatcher, "_can_parallelize", None)
    if can is None or getattr(dispatcher, "read_fn", None) is None:
        return None
    kwargs = dispatcher.normalize_read_kwargs(dict(kwargs))
    path = kwargs.get("filepath_or_buffer")
    if not dispatcher.is_local_plain_file(path) or not can(kwargs):
        return None
    return kwargs


class WindowSource:
    """Record-aligned byte-range windows over one CSV-family source; the
    file stays mapped until :meth:`close`."""

    def __init__(self, dispatcher: type, read_kwargs: dict, window_bytes: int):
        self.dispatcher = dispatcher
        self.read_kwargs = dict(read_kwargs)
        self.path = dispatcher.get_path(read_kwargs["filepath_or_buffer"])
        # a memory map: planning a large source touches a few pages
        self.buf = dispatcher.read_file_bytes(self.path)
        quotechar = read_kwargs.get("quotechar") or '"'
        skiprows = int(read_kwargs.get("skiprows") or 0)
        header_end = find_header_end(self.buf, skiprows + 1, quotechar)
        self._header_bytes = bytes(self.buf[:header_end])
        self._head_kwargs = {
            k: v for k, v in read_kwargs.items() if k not in _BODY_DROP and k != "filepath_or_buffer"
        }
        self._skiprows = skiprows
        # the full column list (before usecols), learned once: a body range
        # parses positionally, and usecols filters each window as it filters
        # a whole-file parse
        name_kwargs = {k: v for k, v in self._head_kwargs.items() if k != "usecols"}
        full_columns = dispatcher.read_fn(
            io.BytesIO(self._header_bytes), skiprows=skiprows, nrows=0, **name_kwargs
        ).columns
        self.body_kwargs = dict(self._head_kwargs, header=None, names=full_columns)
        self.ranges: List[Tuple[int, int]] = split_record_ranges(
            self.buf, header_end, max(int(window_bytes), 1), quotechar
        )

    def __len__(self) -> int:
        return len(self.ranges)

    def close(self) -> None:
        buf, self.buf = self.buf, None
        if hasattr(buf, "close"):
            buf.close()

    def __enter__(self) -> "WindowSource":
        return self

    def __exit__(self, *exc_info: Any) -> bool:
        self.close()
        return False

    def parse_window(self, index: int) -> Any:
        """Window ``index`` as an eager query compiler on the port's device
        (its uploads through ``TorchWrapper.put``: the resilience policy,
        lineage and the ledger's admission).  The caller releases it."""
        start, end = self.ranges[index]
        df = self.dispatcher.read_fn(io.BytesIO(bytes(self.buf[start:end])), **self.body_kwargs)
        _count("stream.window.bytes", end - start)
        _count("stream.window.rows", len(df))
        return self.dispatcher.query_compiler_cls.from_pandas(df)


def release_qc(qc: Any) -> None:
    """Drop a consumed window's device tensors now.

    The ledger's entries are weak references, so a dead window would count
    against the budget until the collector ran; deregistering here makes
    consume-then-drop a real edge.  The window's host copies go too.  On
    the card a dropped tensor's memory returns to the caching allocator in
    the order of the stream that allocated it, which is the stream every
    window's kernels ran on."""
    from modin_tpu_torch.core.memory import device_ledger, ledger

    frame = getattr(qc, "_frame", None)
    if frame is None:
        return
    for col in frame._columns:
        if col.is_device:
            if col._data is not None and not col.is_lazy:
                col._drop_tensor()
            ledger.forget(col)
            col.host_cache = None
    emit_metric("memory.device.resident_bytes", device_ledger.total_bytes())
    emit_metric("memory.host.cache_bytes", ledger.total_bytes())


def frame_nbytes(frame: Any) -> int:
    """Logical bytes of a frame's columns (a tensor's bytes where concrete,
    else the host copy's or the dtype's), the residency router's estimate."""
    total = 0
    for col in frame._columns:
        if col.is_device:
            data = col._data
            if hasattr(data, "element_size"):
                total += int(data.numel() * data.element_size())
            elif col.host_cache is not None:
                total += int(col.host_cache.nbytes)
            else:
                total += int(col.length) * col.pandas_dtype.itemsize
        else:
            total += int(getattr(col.data, "nbytes", 0) or 0)
    return total


def frame_resident_bytes(frame: Any) -> int:
    """The share of :func:`frame_nbytes` concrete on the device now (spilled
    and deferred columns count nothing): taken off the ledger's total when
    the router computes the headroom, so a frame is not counted against
    itself."""
    total = 0
    for col in frame._columns:
        if col.is_device and hasattr(col._data, "element_size"):
            total += int(col._data.numel() * col._data.element_size())
    return total

