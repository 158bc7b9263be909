"""Parallel CSV reader and chunked writer.

The port's counterpart of ``modin_tpu/core/io/text/csv_dispatcher.py``:

- read: the native chunker (``core/io/chunker.py``) splits the body into
  record-aligned byte ranges, pandas' C parser reads them on a thread pool,
  and the concatenated frame goes to the device in ``from_pandas`` (numeric
  columns to the device, strings stay host columns);
- write: ``to_csv`` appends row windows of the frame to the file, each
  window's device columns fetched with one device-to-host copy.

Whatever the chunked read cannot honor exactly (compression, iterators,
python-engine options, multi-character separators, skipfooter, ...) takes
one pandas parse: the same result, serially.
"""

from __future__ import annotations

import io
import re
from typing import Any

import pandas

from modin_tpu_torch.core.io.chunker import find_header_end, split_record_ranges
from modin_tpu_torch.core.io.file_dispatcher import FileDispatcher


class CSVDispatcher(FileDispatcher):
    """``read_csv`` with record-aligned byte-range parallelism."""

    read_fn = staticmethod(pandas.read_csv)

    @classmethod
    def _can_parallelize(cls, kwargs: dict) -> bool:
        unsupported_nondefault = {
            "iterator": False,
            "chunksize": None,
            "compression": "infer",
            "skipfooter": 0,
            "nrows": None,
            "index_col": None,
            "header": "infer",
            "names": None,
            "engine": None,
            "dialect": None,
            "comment": None,
            "lineterminator": None,
            "quoting": 0,
            "memory_map": False,
            "on_bad_lines": "error",
            "escapechar": None,  # an escaped quote breaks the parity scan
            "skip_blank_lines": True,
        }
        no_default = pandas.api.extensions.no_default
        for key, default in unsupported_nondefault.items():
            value = kwargs.get(key, default)
            if value is no_default:
                continue  # pandas' sentinel for "the default"
            if key == "compression" and value == "infer":
                path = kwargs.get("filepath_or_buffer", "")
                if isinstance(path, str) and path.endswith((".gz", ".bz2", ".zip", ".xz", ".zst")):
                    return False
                continue
            if value != default and not (key == "engine" and value in (None, "c")):
                return False
        skiprows = kwargs.get("skiprows")
        if skiprows is not None and not isinstance(skiprows, int):
            return False
        sep = kwargs.get("sep", ",")
        if sep is no_default:
            sep = ","
        # sep=None is the python engine's sniffing: not chunkable
        return sep is not None and len(str(sep)) == 1

    @classmethod
    def _read(cls, filepath_or_buffer: Any = None, **kwargs: Any):
        return cls._read_gated(filepath_or_buffer, "filepath_or_buffer", kwargs)

    @classmethod
    def _read_fallback(cls, path: Any, kwargs: dict):
        df = cls.read_fn(path, **kwargs)
        if isinstance(df, pandas.DataFrame):
            return cls.query_compiler_cls.from_pandas(df)
        return df  # a TextFileReader (iterator/chunksize)

    @classmethod
    def _read_parallel(cls, path: str, kwargs: dict):
        quotechar = kwargs.get("quotechar") or '"'
        skiprows = int(kwargs.get("skiprows") or 0)
        buf = cls.read_file_bytes(path)
        try:
            size = len(buf)
            # 1. the end of the skipped rows and the one header row
            header_end = find_header_end(buf, skiprows + 1, quotechar)
            header_bytes = bytes(buf[:header_end])

            # 2. the header alone gives the FULL column list (without
            # usecols), so that every body chunk parses positionally right;
            # usecols filters in the body parse
            head_kwargs = {
                k: v for k, v in kwargs.items()
                if k not in ("iterator", "chunksize", "skiprows", "nrows")
            }
            name_kwargs = {k: v for k, v in head_kwargs.items() if k != "usecols"}
            full_columns = cls.read_fn(
                io.BytesIO(header_bytes), skiprows=skiprows, nrows=0, **name_kwargs
            ).columns

            # 3. the body in record-aligned ranges
            from modin_tpu_torch.config import CpuCount

            n_chunks = max(CpuCount.get() * 2, 8)
            target = max((size - header_end) // n_chunks, cls.MIN_RANGE_BYTES)
            ranges = split_record_ranges(buf, header_end, target, quotechar)
            if not ranges:
                empty = cls.read_fn(io.BytesIO(header_bytes), skiprows=skiprows, **head_kwargs)
                return cls.query_compiler_cls.from_pandas(empty)

            # 4. the ranges parsed on a thread pool
            body_kwargs = dict(head_kwargs, header=None, names=full_columns)

            def parse(rng):
                start, end = rng
                return cls.read_fn(io.BytesIO(bytes(buf[start:end])), **body_kwargs)

            frames = cls._parse_ranges_threaded(ranges, parse)
        finally:
            if hasattr(buf, "close"):
                buf.close()
        # 5. one frame, to the device
        apart = _columns_typed_apart(frames)
        if apart:
            # only pandas' own parse types such a column as pandas does:
            # _read_gated falls back to it
            raise ValueError(f"byte ranges typed {apart} apart")
        result = pandas.concat(frames, ignore_index=True)
        del frames
        return cls.query_compiler_cls.from_pandas(result)

    @classmethod
    def write(cls, qc: Any, path_or_buf: Any = None, **kwargs: Any):
        """Chunked ``to_csv``: row windows appended to the file, so that the
        host holds one window at a time instead of the whole frame."""
        if (
            not appendable_local_path(path_or_buf, kwargs.get("compression", "infer"))
            or kwargs.get("mode", "w") not in ("w", "wt")
            or not _append_safe_encoding(kwargs.get("encoding"))
            or qc._shape_hint == "column"  # Series.to_csv's header rules
        ):
            return serial_write(qc, "to_csv", path_or_buf, kwargs)
        kwargs.pop("mode", None)
        header = kwargs.pop("header", True)
        first = True
        for chunk in iter_write_chunks(qc):
            chunk.to_csv(
                path_or_buf,
                mode="w" if first else "a",
                header=header if first else False,
                **kwargs,
            )
            first = False
        return None


def _columns_typed_apart(frames: list) -> list:
    """Labels of the columns whose ranges parsed to types whose
    concatenation need not be what one parse of the whole file gives: any
    disagreement short of ints beside floats (which widen to float64 in
    both).  A range where a sparse text column is all missing parses as
    float64, and its concatenation with the ranges typed ``str`` would be
    ``object``; numbers in one range and text in another are ``str`` in a
    small file's parse, and in a large one pandas' own internal chunks decide
    which values stay numbers."""
    first = frames[0]
    labels = []
    for i, label in enumerate(first.columns):
        dtypes = {f.dtypes.iloc[i] for f in frames}
        if len(dtypes) > 1 and not all(getattr(d, "kind", "O") in "if" for d in dtypes):
            labels.append(label)
    return labels


_WRITE_CHUNK_ROWS = 4 << 20
# encodings that can be reopened and appended to mid-stream; the ones that
# write a byte-order mark (utf-8-sig, utf-16/32) would write one per chunk
_APPEND_SAFE_ENCODINGS = {"utf8", "ascii", "latin1", "latin", "cp1252", "iso88591"}
_URL_SCHEME_RE = re.compile(r"^[A-Za-z][A-Za-z0-9+.\-]*://")


def _append_safe_encoding(encoding: Any) -> bool:
    if encoding is None:
        return True
    return str(encoding).lower().replace("-", "").replace("_", "") in _APPEND_SAFE_ENCODINGS


def appendable_local_path(path: Any, compression: Any) -> bool:
    """Whether ``path`` takes per-chunk reopen-and-append writes: a local
    (non-URL) string path that pandas routes through no compression codec
    (each append would start a new archive member)."""
    if not isinstance(path, str) or _URL_SCHEME_RE.match(path):
        return False
    if compression not in (None, "infer"):
        return False
    if compression == "infer":
        from pandas.io.common import infer_compression

        # pandas' own inference: case-insensitive, .tar variants included
        if infer_compression(path, "infer") is not None:
            return False
    return True


def iter_write_chunks(qc: Any):
    """Row windows of ``qc`` as pandas frames; each window's device columns
    come to the host with one device-to-host copy (columns that still hold
    their host copy need none)."""
    frame = qc._modin_frame
    n_rows = len(frame)
    for start in range(0, max(n_rows, 1), _WRITE_CHUNK_ROWS):
        yield frame.window_to_pandas(start, min(start + _WRITE_CHUNK_ROWS, n_rows))


def serial_write(qc: Any, method: str, path: Any, kwargs: dict):
    """The one-gather fallback of every chunked writer, counted."""
    from modin_tpu_torch.error_message import ErrorMessage
    from modin_tpu_torch.utils import qc_to_pandas_for_write

    ErrorMessage.default_to_pandas(f"`{method}`")
    return getattr(qc_to_pandas_for_write(qc), method)(path, **kwargs)


class TableDispatcher(CSVDispatcher):
    """``read_table``: CSV with a tab separator by default."""

    @classmethod
    def normalize_read_kwargs(cls, kwargs: dict) -> dict:
        if kwargs.get("sep") in (None, pandas.api.extensions.no_default):
            kwargs = {**kwargs, "sep": "\t"}
        return kwargs

    @classmethod
    def _read(cls, filepath_or_buffer: Any = None, **kwargs: Any):
        return super()._read(filepath_or_buffer, **cls.normalize_read_kwargs(kwargs))
