"""Structural device ops: float total order, gather, compaction and concat.

The port's counterpart of ``modin_tpu/ops/structural.py``.  The JAX package
pads every column to a multiple of the mesh's row-shard count and passes the
logical lengths to each kernel so that no pad row is read; the port has one
device and one shard (``parallel/mesh.py``: ``pad_len(n) == n``), so a column
is exactly its rows and none of these ops masks anything.

Each op is a composition of torch library operations (``index_select``,
``nonzero``, ``cat``), as the JAX package leaves the same work to XLA
(``jnp.take``, ``jnp.argsort``, ``jnp.concatenate``); no Pallas kernel sits
under them.  The gathers and concatenations run through
``TorchWrapper.deploy``, as the JAX package's do: they get the resilience
policy, and their outputs op-replay lineage.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from modin_tpu_torch.parallel.engine import TorchWrapper

# bits ^ INT64_MAX flips every bit of a negative float's pattern but the
# sign: the same as the JAX package's (~bits) ^ int64 min
_INT64_MAX = (1 << 63) - 1


def float_total_order(x: torch.Tensor) -> torch.Tensor:
    """Monotone float -> int64 mapping with a strict IEEE total order.

    -0.0 == 0.0, every NaN maps to one key ABOVE +inf (so NaN sorts strictly
    after inf instead of tying with it), and ordering elsewhere matches <.
    Shared by the sort and join ops.  float16/float32 widen to float64
    first (exact), since ``Tensor.view(torch.int64)`` needs 8-byte floats.
    """
    x = x.to(torch.float64)
    x = torch.where(x == 0, 0.0, x)
    # one NaN bit pattern (the positive quiet NaN) for every NaN
    x = torch.where(torch.isnan(x), float("nan"), x)
    bits = x.contiguous().view(torch.int64)
    return torch.where(bits >= 0, bits, bits ^ _INT64_MAX)


def int64_key(key: torch.Tensor) -> torch.Tensor:
    """An int64 key with the same equalities and order: total-order bits
    for floats, a widening cast for ints and bools.  Shared by the sort and
    join ops."""
    if key.dtype.is_floating_point:
        return float_total_order(key)
    return key.to(torch.int64)


def compact_rows(
    cols: Sequence[torch.Tensor], mask: torch.Tensor, n: int
) -> Tuple[List[torch.Tensor], int, torch.Tensor]:
    """Boolean filter on the device: kept rows in their original order.

    Returns (gathered columns, kept count, kept positions).  ``nonzero``
    gives the kept positions directly (the JAX package takes a stable argsort
    of ``~keep`` over its padded rows, whose first ``count`` entries are the
    same positions); its one host sync is the count, which the output shape
    needs anyway.
    """
    if mask.shape[0] != n:
        raise ValueError(f"mask of {mask.shape[0]} rows for {n} rows")
    positions = torch.nonzero(mask).flatten()
    return gather_columns_device(cols, positions), int(positions.shape[0]), positions


def gather_columns(cols: Sequence[torch.Tensor], positions: np.ndarray) -> Tuple[List[torch.Tensor], int]:
    """Gather host positions from device columns: (columns, length)."""
    if not cols:
        return [], len(positions)
    device_positions = TorchWrapper.put(
        np.asarray(positions, dtype=np.int64), cols[0].device
    )
    return gather_columns_device(cols, device_positions), len(positions)


def _gather(cols: Tuple[torch.Tensor, ...], positions: torch.Tensor) -> List[torch.Tensor]:
    return [torch.index_select(c, 0, positions) for c in cols]


def gather_columns_device(cols: Sequence[torch.Tensor], positions: torch.Tensor) -> List[torch.Tensor]:
    """Gather with a positions tensor already on the columns' device."""
    if not cols:
        return []
    return TorchWrapper.deploy(_gather, (tuple(cols), positions))


def _concat(parts: Tuple[Tuple[torch.Tensor, ...], ...]) -> List[torch.Tensor]:
    return [torch.cat([p[ci] for p in parts]) for ci in range(len(parts[0]))]


def concat_columns(parts: Sequence[Sequence[torch.Tensor]], lengths: Sequence[int]) -> Tuple[List[torch.Tensor], int]:
    """Row-concat column sets: ``parts[i]`` holds the columns of part i.

    One ``torch.cat`` per column.  The JAX package's ``_jit_tail_append``
    works around XLA's re-layout of padded shards when a small tail joins a
    large prefix; an unpadded tensor has no such layout, so it has no
    counterpart here.
    """
    n_out = int(sum(lengths))
    if not parts[0]:
        return [], n_out
    return TorchWrapper.deploy(_concat, (tuple(tuple(p) for p in parts),)), n_out
