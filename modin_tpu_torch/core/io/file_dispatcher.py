"""``FileDispatcher`` — path checks and the read template of every format.

The port's counterpart of ``modin_tpu/core/io/file_dispatcher.py``: ``read``
calls the format's ``_read``; the text formats share ``_read_gated``, which
takes the parallel path (record-aligned byte ranges parsed on a thread pool)
for a plain local file it can parse in parallel, and the serial pandas parse
otherwise.  ``PARALLEL_READS`` counts the reads that took the parallel path,
so a fall-back to the serial parse shows; ``PARSED_COLUMNS`` adds up the
columns that the text reads parsed (a projection pushed into ``usecols``
shows as fewer).

Every device column a read makes gets an **io lineage record**
(``core/execution/recovery.py``): after a device loss, even with its host
copy dropped under the ``Memory`` budget, the column can be made again by
running the same read once more (:class:`_IoReplay`).
"""

from __future__ import annotations

import functools
import os
from typing import Any, Optional

from modin_tpu_torch.logging import ClassLogger
from modin_tpu_torch.logging.metrics import emit_metric
from modin_tpu_torch.observability import meters as _meters
from modin_tpu_torch.observability import spans as _spans
from modin_tpu_torch.utils.file_leaks import track_file_leaks

NOT_IMPLEMENTED_MESSAGE = "Implement in children classes!"

# reads that the parallel path answered (incremented only in _read_gated)
PARALLEL_READS = 0
# columns that the text reads parsed, both paths (added in _read_gated)
PARSED_COLUMNS = 0


class _IoReplay:
    """Run a dispatcher's read again and serve each column's exact host
    values: the io lineage record.  It holds the dispatcher and the call's
    arguments, no data; the first column a recovery pass asks for re-reads
    the file once for the pass (per device epoch), and the pass's end drops
    the memo (``drop_cache``, through ``recovery.note_io_replayer``), so a
    pass never pins a host copy of the file past its own end."""

    def __init__(self, dispatcher: type, args: tuple, kwargs: dict):
        self._dispatcher = dispatcher
        self._args = args
        self._kwargs = kwargs
        self._cache: Optional[tuple] = None  # (epoch, [values by position])

    def drop_cache(self) -> None:
        self._cache = None

    def values_for(self, pos: int) -> Any:
        from modin_tpu_torch.core.execution import recovery

        epoch = recovery.current_epoch()
        cache = self._cache
        if cache is None or cache[0] != epoch:
            columns = self._dispatcher._read(*self._args, **self._kwargs)._modin_frame._columns
            cache = self._cache = (epoch, [c.to_numpy() if c.is_device else None for c in columns])
            recovery.note_io_replayer(self)
        values = cache[1][pos] if pos < len(cache[1]) else None
        if values is None:
            raise RuntimeError(f"column {pos} is not in the {self._dispatcher.__name__} re-read")
        return values


class FileDispatcher(ClassLogger, modin_layer="CORE-IO"):
    query_compiler_cls = None

    @classmethod
    def read(cls, *args: Any, **kwargs: Any):
        """Read a file into a query compiler of ``query_compiler_cls``; its
        device columns get io lineage.  An ``io.read`` span, and the
        source's bytes billed to the meters while they account.  Under the
        ``TrackFileLeaks`` setting a read that leaves a file descriptor open
        warns (``ResourceWarning``)."""
        with _spans.span("io.read", "CORE-IO", dispatcher=cls.__name__):
            with track_file_leaks():
                result = cls._read(*args, **kwargs)
        if _meters.ACCOUNTING_ON:
            cls._note_read_bytes(args, kwargs)
        cls._attach_io_lineage(result, args, kwargs)
        return result

    @classmethod
    def _note_read_bytes(cls, args: tuple, kwargs: dict) -> None:
        """Bill this read's source file size (best effort)."""
        try:
            path = kwargs.get("filepath_or_buffer") or kwargs.get("path") or (args[0] if args else None)
            if isinstance(path, str):
                path = cls.get_path(path)
            if cls.is_local_plain_file(path):
                emit_metric("io.read.bytes", cls.file_size(path))
        except Exception:
            pass  # an exotic path goes unbilled

    @classmethod
    def _attach_io_lineage(cls, result: Any, args: tuple, kwargs: dict) -> None:
        from modin_tpu_torch.core.execution import recovery

        frame = getattr(result, "_frame", None)
        if not recovery.RECOVERY_ON or frame is None:
            return
        replayer = _IoReplay(cls, args, kwargs)
        for pos, col in enumerate(frame._columns):
            if col.is_device:
                recovery.attach_io_lineage(
                    col, replay=functools.partial(replayer.values_for, pos), detail=cls.__name__
                )

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
        pandas' own result or error (a device failure raises)."""
        global PARALLEL_READS, PARSED_COLUMNS
        path = cls.get_path(raw_path) if isinstance(raw_path, str) else raw_path
        if (
            not cls.is_local_plain_file(path)
            or not cls._can_parallelize({**kwargs, path_key: path})
            or cls.file_size(path) < cls.MIN_PARALLEL_BYTES
        ):
            result = cls._read_fallback(path, kwargs)
        else:
            from modin_tpu_torch.core.execution.resilience import classify_device_error

            try:
                result = cls._read_parallel(path, kwargs)
                PARALLEL_READS += 1
            except Exception as err:  # any failure of the chunked parse: pandas decides
                if classify_device_error(err) is not None:
                    raise  # the device's failure, not the parse's: the caller sees it
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
        # the workers' spans and metrics bill the read that spawned them
        stack = _spans.snapshot_stack() if _spans.TRACE_ON else None
        scopes = _meters.snapshot_scopes() if _meters.ACCOUNTING_ON else None

        def seed() -> None:
            _spans.seed_thread(stack)
            _meters.seed_thread_scopes(scopes)

        with ThreadPoolExecutor(max_workers=min(CpuCount.get(), len(ranges)), initializer=seed) as pool:
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
