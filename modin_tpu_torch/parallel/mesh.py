"""Device placement and the row-shard mesh.

The port's counterpart of ``modin_tpu/parallel/mesh.py``.  The JAX package
shards each column over a ``jax.sharding.Mesh`` "rows" axis and pads it to a
multiple of the shard count; one Python process drives that mesh, and its
shuffle is one ``shard_map`` program with an ``all_to_all`` inside.  The
port keeps the single controller and drops the padding:

- a column is one unpadded tensor on the primary device
  (:func:`get_device`), so :func:`pad_len` is ``n``; the group code
  ``== num_groups`` stays the overflow bucket that drops NaN keys
  (``ops/groupby.py``);
- the mesh is an ordered list of ``S`` row-shard devices
  (:func:`shard_devices`): shard s runs on device ``s % DeviceCount`` of the
  primary device's kind, the primary device first, so more shards than
  devices wrap onto them (four shards on one card, eight on the CPU);
- the range shuffle (``parallel/shuffle.py``) sees a column as ``S`` row
  blocks of ``ceil(n / S)`` rows (:func:`row_blocks`, the last one ragged),
  runs each shard's step on its device and exchanges the blocks by copies
  between the devices.

``MeshShape`` defaults to ``(DeviceCount, 1)``: one card is one shard, and
every sharded path declines (``single_shard``) as the JAX package's do on
one chip.  :func:`mesh_shape_key` (``"<kind>:<S>x<C>"``) names the mesh;
the artifacts of ``views/`` (the sorted representations among them) and the
kernel router's calibration table are keyed by it, so a reshape drops what
was built under another shape.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from modin_tpu_torch.concurrency import named_lock
from modin_tpu_torch.config import Device, DeviceCount, MeshShape


class Mesh:
    """``S`` row-shard devices (the primary first) and the shape's key."""

    __slots__ = ("shape", "devices", "kind", "key")

    def __init__(self, devices: Sequence[torch.device], cols: int = 1):
        if not devices:
            raise ValueError("a mesh needs at least one row shard")
        self.devices: Tuple[torch.device, ...] = tuple(devices)
        self.shape: Tuple[int, int] = (len(self.devices), int(cols))
        self.kind = self.devices[0].type
        self.key = f"{self.kind}:{self.shape[0]}x{self.shape[1]}"

    def __repr__(self) -> str:
        return f"Mesh({self.key}, devices={[str(d) for d in self.devices]})"


_lock = named_lock("parallel.mesh")
# the live mesh: built on first use, dropped by every change of the
# settings it depends on (the subscriptions at the bottom) and by
# ``reset_mesh``
_mesh: Optional[Mesh] = None


def get_device() -> torch.device:
    """The device new columns go to; raises for ``"cuda"`` without a card."""
    name = Device.get()
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "modin_tpu_torch runs on 'cuda' by default, but "
                "torch.cuda.is_available() is False; call "
                "modin_tpu_torch.set_device('cpu') or set "
                "MODIN_TPU_TORCH_DEVICE=cpu to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _mesh_devices(rows: int) -> List[torch.device]:
    """The row shards' devices: the primary first, then the others of its
    kind in index order, shard s on the ``s % count``-th."""
    primary = get_device()
    if primary.type != "cuda":
        return [primary] * rows
    count = min(int(DeviceCount.get()), torch.cuda.device_count())
    others = [torch.device("cuda", i) for i in range(torch.cuda.device_count()) if i != primary.index]
    ring = [primary] + others[: max(count - 1, 0)]
    return [ring[s % len(ring)] for s in range(rows)]


def get_mesh() -> Mesh:
    """The live mesh, built from ``MeshShape`` on first use."""
    global _mesh
    mesh = _mesh
    if mesh is not None:
        return mesh
    with _lock:
        if _mesh is None:
            rows, cols = MeshShape.get()
            _mesh = Mesh(_mesh_devices(int(rows)), int(cols))
        return _mesh


def reset_mesh() -> None:
    """Drop the live mesh: the next use builds it from the settings."""
    global _mesh
    with _lock:
        _mesh = None


def num_row_shards() -> int:
    """The mesh's row shards (read from the settings until the mesh is
    built, so asking never needs a device)."""
    mesh = _mesh
    return mesh.shape[0] if mesh is not None else int(MeshShape.get()[0])


def shard_devices() -> Tuple[torch.device, ...]:
    """The device of each row shard, in shard order (the primary first)."""
    return get_mesh().devices


def mesh_shape_key() -> str:
    """The mesh's identity, e.g. ``"cuda:4x1"``: the device kind and the
    shape.  A derived artifact built under one mesh is not an answer under
    another, and a calibration measured on one does not seed another.
    Read from the settings until the mesh is built, as :func:`num_row_shards`."""
    mesh = _mesh
    if mesh is not None:
        return mesh.key
    rows, cols = MeshShape.get()
    return f"{Device.get()}:{int(rows)}x{int(cols)}"


def pad_len(n: int) -> int:
    """Physical length of a column of ``n`` rows: columns are not padded."""
    return int(n)


def row_blocks(n: int, shards: int) -> List[Tuple[int, int]]:
    """``[start, stop)`` of each shard's rows: ``ceil(n / shards)`` a block
    (the JAX package's shard length), the last one ragged and any beyond
    the rows empty."""
    n, shards = int(n), max(int(shards), 1)
    length = -(-n // shards)
    return [(min(s * length, n), min((s + 1) * length, n)) for s in range(shards)]


def _on_mesh_setting(_param) -> None:
    """A mesh setting changed: the next use rebuilds the mesh."""
    global _mesh
    _mesh = None


for _param in (MeshShape, DeviceCount, Device):
    _param.subscribe(_on_mesh_setting)
