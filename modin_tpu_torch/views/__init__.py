"""The derived-artifact cache of the torch port.

The port's counterpart of ``modin_tpu/views/``:

- ``registry.py``: artifacts derived from a column's tensor (whole
  reduction results, nunique/mode/median answers, small groupby tables,
  and through ``ops/sorted_cache.py`` the sorted representations), keyed
  by (column token, kind, parameters) and shared by every query on the
  same tensors; a row ``concat`` links each appended column to its
  parent's token and length;
- ``incremental.py``: the append-only fold rules (scalar combines,
  groupby partial tables, dictionary code-table extension);
- ``reduce_cache.py``/``groupby_cache.py``: the query compiler's hooks,
  which answer a hit with no device work and fold an appended column by
  reducing only its tail rows.

``MODIN_TPU_TORCH_VIEWS=Off`` leaves the port as it was without them:
every hook reads :data:`VIEWS_ON` first, and under Off no token is
allocated.
"""

from __future__ import annotations

from typing import Any

#: True while ``ViewsMode`` is Auto; every hook reads it before any work
VIEWS_ON: bool = True


def _on_views_mode(param: Any) -> None:
    global VIEWS_ON
    VIEWS_ON = str(param.get()).lower() != "off"


from modin_tpu_torch.config import ViewsMode as _ViewsMode  # noqa: E402

_ViewsMode.subscribe(_on_views_mode)
