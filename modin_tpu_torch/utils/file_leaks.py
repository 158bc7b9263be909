"""File-descriptor leak tracking for the IO layer.

The port's counterpart of ``modin_tpu/utils/file_leaks.py``: under the
``TrackFileLeaks`` setting every ``FileDispatcher.read`` lists the
process's open regular-file descriptors before and after, and warns with a
``ResourceWarning`` about any it left open.  It reads ``/proc/self/fd``;
where there is no procfs the tracker does nothing.
"""

from __future__ import annotations

import contextlib
import os
import warnings
from typing import Dict, Iterator

_FD_DIR = "/proc/self/fd"


def open_file_fds() -> Dict[int, str]:
    """The open descriptors that resolve to regular files (pipes, sockets
    and devices left out)."""
    out: Dict[int, str] = {}
    try:
        fds = os.listdir(_FD_DIR)
    except OSError:  # no procfs
        return out
    for name in fds:
        try:
            target = os.readlink(os.path.join(_FD_DIR, name))
        except OSError:
            continue  # closed while listing (the listing's own handle)
        if target.startswith("/") and not target.startswith(("/dev", "/proc", "/sys")):
            with contextlib.suppress(ValueError):
                out[int(name)] = target
    return out


@contextlib.contextmanager
def track_file_leaks() -> Iterator[None]:
    """Warn (``ResourceWarning``) when the block leaves a regular-file
    descriptor open.  With the ``TrackFileLeaks`` setting off it reads the
    setting and lists nothing."""
    from modin_tpu_torch.config import TrackFileLeaks

    if not TrackFileLeaks.get():
        yield
        return
    before = open_file_fds()
    yield
    leaked = {fd: path for fd, path in open_file_fds().items() if before.get(fd) != path}
    if leaked:
        warnings.warn(
            "file descriptors leaked by IO operation: "
            + ", ".join(f"{fd}->{path}" for fd, path in sorted(leaked.items())),
            ResourceWarning,
            stacklevel=3,
        )
