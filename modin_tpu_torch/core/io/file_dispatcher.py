"""``FileDispatcher`` — path checks and the read template of every format.

The port's counterpart of ``modin_tpu/core/io/file_dispatcher.py``: ``read``
calls the format's ``_read``; the text formats share ``_read_gated``, which
takes the parallel path (record-aligned byte ranges parsed on a thread pool)
for a plain local file it can parse in parallel, and the serial pandas parse
otherwise.  ``PARALLEL_READS`` counts the reads that took the parallel path,
so a fall-back to the serial parse shows; ``PARSED_COLUMNS`` adds up the
columns that the text reads parsed (a projection pushed into ``usecols``
shows as fewer).
"""

from __future__ import annotations

import os
from typing import Any

NOT_IMPLEMENTED_MESSAGE = "Implement in children classes!"

# reads that the parallel path answered (incremented only in _read_gated)
PARALLEL_READS = 0
# columns that the text reads parsed, both paths (added in _read_gated)
PARSED_COLUMNS = 0


class FileDispatcher:
    query_compiler_cls = None

    @classmethod
    def read(cls, *args: Any, **kwargs: Any):
        """Read a file into a query compiler of ``query_compiler_cls``."""
        return cls._read(*args, **kwargs)

    @classmethod
    def _read(cls, *args: Any, **kwargs: Any):
        raise NotImplementedError(NOT_IMPLEMENTED_MESSAGE)

    # ---- the parallel-read template of the text dispatchers ----------- #

    MIN_PARALLEL_BYTES = 8 << 20  # below this one parse is faster
    MIN_RANGE_BYTES = 1 << 20  # the least bytes of one parallel range

    @classmethod
    def _read_gated(cls, raw_path: Any, path_key: str, kwargs: dict):
        """The parallel path where it applies, else the serial fallback; an
        error on the parallel path degrades to the fallback, which gives
        pandas' own result or error."""
        global PARALLEL_READS, PARSED_COLUMNS
        path = cls.get_path(raw_path) if isinstance(raw_path, str) else raw_path
        if (
            not cls.is_local_plain_file(path)
            or not cls._can_parallelize({**kwargs, path_key: path})
            or cls.file_size(path) < cls.MIN_PARALLEL_BYTES
        ):
            result = cls._read_fallback(path, kwargs)
        else:
            try:
                result = cls._read_parallel(path, kwargs)
                PARALLEL_READS += 1
            except Exception:  # any failure of the chunked parse: pandas decides
                result = cls._read_fallback(path, kwargs)
        frame = getattr(result, "_frame", None)
        if frame is not None:
            PARSED_COLUMNS += frame.num_cols
        return result

    @classmethod
    def _parse_ranges_threaded(cls, ranges: list, parse) -> list:
        """``parse`` of each range on a thread pool (pandas' C parser and
        pyarrow's decoder release the interpreter lock)."""
        from concurrent.futures import ThreadPoolExecutor

        from modin_tpu_torch.config import CpuCount

        if len(ranges) == 1:
            return [parse(ranges[0])]
        with ThreadPoolExecutor(max_workers=min(CpuCount.get(), len(ranges))) as pool:
            return list(pool.map(parse, ranges))

    @classmethod
    def normalize_read_kwargs(cls, kwargs: dict) -> dict:
        """The reader kwargs in canonical form (a format's default
        separator, ...), so that the eager read and the planner's deferred
        Scan read with the same kwargs; the base changes nothing."""
        return kwargs

    @classmethod
    def get_path(cls, file_path: str) -> str:
        if isinstance(file_path, str) and file_path.startswith("~"):
            return os.path.expanduser(file_path)
        return file_path

    @classmethod
    def is_local_plain_file(cls, path: Any) -> bool:
        """Whether ``path`` names a plain local file that can be mapped."""
        if not isinstance(path, (str, os.PathLike)):
            return False
        p = os.fspath(path)
        if "://" in p and not p.startswith("file://"):
            return False
        p = os.path.expanduser(p.removeprefix("file://"))
        return os.path.isfile(p)

    @classmethod
    def file_size(cls, path: str) -> int:
        return os.path.getsize(os.path.expanduser(os.fspath(path).removeprefix("file://")))

    @classmethod
    def read_file_bytes(cls, path: str):
        """The file's bytes as a read-only memory map (bytes for an empty
        file or where mapping is unsupported)."""
        import mmap

        p = os.path.expanduser(os.fspath(path).removeprefix("file://"))
        with open(p, "rb") as f:
            try:
                return mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            except (ValueError, OSError):
                return f.read()
