"""Device placement: one device, one shard.

The port's counterpart of ``modin_tpu/parallel/mesh.py``.  The JAX package
shards each column over a mesh's "rows" axis and pads it to a multiple of
the shard count; here a column is one tensor on one device, so there is one
row shard and no row padding.  The overflow bucket stays: group code
``== num_groups`` is how NaN keys are dropped (``ops/groupby.py``).
"""

from __future__ import annotations

import torch

from modin_tpu_torch.config import Device


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


def num_row_shards() -> int:
    return 1


def pad_len(n: int) -> int:
    """Physical length of a column of ``n`` rows (no padding on one shard)."""
    return int(n)
