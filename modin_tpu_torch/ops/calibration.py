"""The versioned store of measured-coefficient tables.

The port's counterpart of ``modin_tpu/ops/calibration.py``: the n·log n and
linear scalings every sort-shaped cost extrapolation shares, and the naming,
validation and atomic persistence of a table under ``CacheDir``.  Callers
keep their tables' contents; a table names the platform (``"cuda"`` or
``"cpu"``), the device (the card's name) and the torch version it was
measured under, and :func:`load_table` refuses one whose keys differ, so a
table from another card, another torch or the CPU never seeds this
process's cost model.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, Optional

from modin_tpu_torch.utils import atomic_io


def nlogn_scale(n: int, cal_rows: int) -> float:
    """The n·log n scale from a calibration row count to ``n`` (both floored
    at 2, so a tiny frame never divides by zero or goes negative)."""
    cal_rows = max(int(cal_rows), 2)
    n = max(int(n), 2)
    return (n * math.log2(n)) / (cal_rows * math.log2(cal_rows))


def linear_scale(n: int, cal_rows: int) -> float:
    """The linear per-row scale from a calibration row count to ``n``."""
    return max(int(n), 0) / max(int(cal_rows), 2)


def table_path(kind: str, platform: str, device_key: Optional[str] = None,
               version: Optional[int] = None) -> Optional[str]:
    """The ``CacheDir`` path of one table, or None (no ``CacheDir``)."""
    from modin_tpu_torch.config import CacheDir

    cache_dir = CacheDir.get()
    if not cache_dir:
        return None
    name = f"{kind}_{platform}"
    if device_key is not None:
        name += "_" + "".join(c if c.isalnum() or c in "._-" else "_" for c in device_key)
    if version is not None:
        name += f"_v{version}"
    return os.path.join(str(cache_dir), f"{name}.json")


def load_table(path: Optional[str], version: Optional[int] = None, platform: Optional[str] = None,
               device_key: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """The cached table when it exists AND matches every given key, else
    None."""
    if path is None:
        return None
    try:
        with open(path) as f:
            table = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(table, dict):
        return None
    for key, want in (("version", version), ("platform", platform), ("device", device_key)):
        if want is not None and table.get(key) != want:
            return None
    return table


def store_table(path: Optional[str], table: Dict[str, Any]) -> None:
    """Write one table atomically (``utils/atomic_io.py``: a temporary file
    renamed over the old one); an unwritable ``CacheDir`` keeps no table,
    and the next process measures again."""
    if path is None:
        return
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        atomic_io.atomic_write_json(path, table, sort_keys=True)
    except OSError:
        pass
