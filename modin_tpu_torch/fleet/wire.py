"""The fleet's wire protocol: length-prefixed pickle frames over local sockets.

The port's counterpart of ``modin_tpu/fleet/wire.py``, byte for byte the
same frames.  A frame is a 4-byte big-endian length and a pickled payload.
Both ends of every fleet socket (the coordinator's control listener, a
replica's RPC listener, the heartbeat stream) speak exactly this; there is
no partial-frame state beyond "read until the frame is whole".

Two properties serve the failure detection:

- **Bounded frames.**  A frame longer than ``MAX_FRAME_BYTES`` is a
  protocol error, not an allocation: a corrupted length cannot make a
  reader allocate gigabytes.
- **Interruptible reads.**  ``recv_msg`` takes a ``poll`` callback, called
  on every socket-timeout tick while a frame is incomplete; the
  coordinator's dispatch uses it to abort a join the moment the monitor
  declares the replica lost (a SIGSTOPped replica: the socket stays
  connected and no byte ever arrives).
"""

from __future__ import annotations

import pickle
import socket
import struct
from typing import Any, Callable, Optional

#: Hard cap on one frame's payload (a full exported dataset result fits
#: comfortably; a garbage length prefix does not).
MAX_FRAME_BYTES = 256 * 1024 * 1024

_LEN = struct.Struct(">I")


class WireError(ConnectionError):
    """The peer vanished or spoke garbage mid-frame (dead-socket signal)."""


def send_msg(sock: socket.socket, obj: Any) -> None:
    """Pickle ``obj`` and send it as one frame (raises WireError on a dead
    peer)."""
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    if len(payload) > MAX_FRAME_BYTES:
        raise WireError(f"frame of {len(payload)} bytes exceeds the cap")
    try:
        sock.sendall(_LEN.pack(len(payload)) + payload)
    except (OSError, ValueError) as err:
        raise WireError(f"send failed: {err}") from err


def _recv_exact(
    sock: socket.socket, n: int, poll: Optional[Callable[[], None]]
) -> bytes:
    """Read exactly ``n`` bytes, calling ``poll()`` on every timeout tick.

    ``poll`` aborts the read by raising; returning lets the read continue
    waiting.  A peer that closes (or resets) mid-frame raises WireError.
    """
    chunks = []
    remaining = n
    while remaining > 0:
        try:
            chunk = sock.recv(min(remaining, 1 << 20))
        except socket.timeout:
            if poll is not None:
                poll()
            continue
        except OSError as err:
            raise WireError(f"recv failed: {err}") from err
        if not chunk:
            raise WireError("peer closed mid-frame")
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)


def recv_msg(
    sock: socket.socket, poll: Optional[Callable[[], None]] = None
) -> Any:
    """Receive one frame and unpickle it.

    The caller controls responsiveness via the socket's timeout: each
    timeout tick invokes ``poll()`` (see module docstring) and the read
    resumes, so a frame split across ticks is never lost.
    """
    header = _recv_exact(sock, _LEN.size, poll)
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME_BYTES:
        raise WireError(f"peer announced a {length}-byte frame (cap exceeded)")
    payload = _recv_exact(sock, length, poll)
    try:
        return pickle.loads(payload)
    except Exception as err:
        raise WireError(f"frame did not unpickle: {err}") from err


def connect(
    host: str, port: int, timeout: Optional[float] = None
) -> socket.socket:
    """A connected TCP socket with TCP_NODELAY (frames are small and the
    RPC is latency-sensitive)."""
    sock = socket.create_connection((host, port), timeout=timeout)
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass
    return sock
