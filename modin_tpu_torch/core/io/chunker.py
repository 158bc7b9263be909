"""Record-aligned byte ranges of a CSV buffer: the native chunker (ctypes).

The port's counterpart of ``modin_tpu/core/io/chunker.py``.
``native_src/chunker.cpp`` (host C++, copied from the JAX package as it is)
is built by ``g++`` at first use into ``modin_tpu_torch/_build/`` under a
file name that carries a hash of the source, as the CUDA kernels are
(``ops/cuda/build.py``).  Without a compiler the Python splitter
(:func:`_split_record_ranges_py`, the plain version, same semantics) runs
instead.  ``NATIVE_SPLITS`` counts the splits the native library made.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

from modin_tpu_torch.ops.cuda.build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native_src", "chunker.cpp")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

# splits made by the native library (the Python splitter does not count)
NATIVE_SPLITS = 0

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> str:
    """Where the build of ``chunker.cpp`` goes, keyed by source and flags."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"libchunker_{digest[:16]}.so")


def _build_library() -> Optional[ctypes.CDLL]:
    global _build_failed
    so_path = library_path()
    if not os.path.exists(so_path):
        tmp = f"{so_path}.{os.getpid()}.tmp"
        try:
            os.makedirs(BUILD_DIR, exist_ok=True)
            subprocess.run(
                ["g++", *GXX_FLAGS, _SRC, "-o", tmp],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, so_path)
        except (OSError, subprocess.SubprocessError):
            _build_failed = True
            return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        _build_failed = True
        return None
    lib.next_record_boundary.restype = ctypes.c_int64
    lib.next_record_boundary.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_char, ctypes.c_int32,
    ]
    lib.split_record_ranges.restype = ctypes.c_int64
    lib.split_record_ranges.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_char, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
    ]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is None and not _build_failed:
        with _lock:
            if _lib is None and not _build_failed:
                _lib = _build_library()
    return _lib


def _buf_address(buf) -> tuple:
    """(pointer, keepalive) of bytes or a read-only mmap, without a copy."""
    arr = np.frombuffer(buf, dtype=np.uint8)
    return arr.ctypes.data, arr


def split_record_ranges(
    buf: bytes,
    header_end: int,
    target_chunk_bytes: int,
    quotechar: str = '"',
    max_chunks: int = 4096,
) -> List[Tuple[int, int]]:
    """Split ``buf[header_end:]`` into record-aligned (start, end) byte ranges."""
    global NATIVE_SPLITS
    size = len(buf)
    if header_end >= size:
        return []
    # enough chunk slots for the whole body: a file larger than
    # max_chunks * target must not lose its tail
    target = max(target_chunk_bytes, 1)
    needed = (size - header_end) // target + 2
    max_chunks = max(max_chunks, min(int(needed), 4_000_000))
    lib = _get_lib()
    if lib is None:
        return _split_record_ranges_py(buf, header_end, target, quotechar, max_chunks)
    out = (ctypes.c_int64 * (2 * max_chunks))()
    ptr, keepalive = _buf_address(buf)
    n = lib.split_record_ranges(
        ptr, header_end, size, target, quotechar.encode()[0:1], max_chunks, out,
    )
    del keepalive
    NATIVE_SPLITS += 1
    return [(out[2 * i], out[2 * i + 1]) for i in range(n)]


def _split_record_ranges_py(
    buf: bytes, header_end: int, target: int, quotechar: str, max_chunks: int
) -> List[Tuple[int, int]]:
    """The plain version of the native splitter, with the same semantics."""
    q = quotechar.encode()[0]
    size = len(buf)
    ranges = []
    pos = header_end
    in_quotes = False
    scan_from = header_end
    arr = np.frombuffer(buf, dtype=np.uint8)
    while pos < size and len(ranges) < max_chunks:
        want = pos + max(target, 1)
        if want >= size:
            ranges.append((pos, size))
            break
        in_quotes = bool(
            (int(np.count_nonzero(arr[scan_from:want] == q)) + in_quotes) % 2
        )
        boundary = want
        iq = in_quotes
        while boundary < size:
            c = buf[boundary]
            if c == q:
                iq = not iq
            elif c == 0x0A and not iq:
                boundary += 1
                break
            boundary += 1
        in_quotes = bool(
            (int(np.count_nonzero(arr[want:boundary] == q)) + in_quotes) % 2
        )
        scan_from = boundary
        ranges.append((pos, boundary))
        pos = boundary
    return ranges


def find_header_end(buf: bytes, skip_rows: int, quotechar: str = '"') -> int:
    """Byte offset just past ``skip_rows`` records from the start of ``buf``."""
    lib = _get_lib()
    pos = 0
    size = len(buf)
    if lib is not None:
        ptr, keepalive = _buf_address(buf)
        for _ in range(skip_rows):
            pos = lib.next_record_boundary(ptr, pos, size, quotechar.encode()[0:1], 0)
            if pos >= size:
                break
        del keepalive
        return pos
    q = quotechar.encode()[0]
    for _ in range(skip_rows):
        iq = False
        while pos < size:
            c = buf[pos]
            pos += 1
            if c == q:
                iq = not iq
            elif c == 0x0A and not iq:
                break
        if pos >= size:
            break
    return pos
