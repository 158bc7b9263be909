"""Out-of-core streaming execution of the torch port.

The port's counterpart of ``modin_tpu/streaming/``.  A frame or a source
file larger than the device ledger's headroom under
``MODIN_TPU_TORCH_DEVICE_MEMORY_BUDGET`` runs in resident **windows**:
read, upload, consume, drop.  The next window's byte-range parse and
upload overlap the current window's kernels (``StreamPrefetch``), and the
window size is derived from the budget, so that ``1 + prefetch`` windows
and a 2x kernel working set stay under it.  Three legs:

- **windowed scan -> reduce/groupby** (:mod:`.executor`): the planner
  lowers a ``scan -> filter/map/project -> reduce|groupby_agg`` chain over
  one CSV-family source into a window loop when ``decide_residency``
  judges the source out-of-core.  The record-aligned byte ranges of the
  parallel reader are the window boundaries; each window runs the chain
  through the eager seams (a filtered reduction as one masked launch of
  ``fused.cu``, a groupby through ``bincount.cu``/``groupagg.cu``), and
  only its partial result survives the window's release.  Reductions
  recombine algebraically, groupbys through a host table of partial
  states bounded by ``StreamMaxGroups``;
- **external sort and the spill-aware merge-join** (:mod:`.external`): a
  per-window device sort writes sorted runs to the host, a stable k-way
  merge folds them, and the output columns start spilled (their exact host
  copies are the only copies until a consumer reads them);
- **the seams**: window uploads go through ``TorchWrapper.put`` (the
  resilience policy, lineage and the device ledger's admission); a device
  failure the seam could not absorb replays one window from its byte range
  (``stream.window.replay``); ``stream.*`` spans and metrics feed
  ``QueryStats``.

Where the port departs from the reference: a window uploads at its exact
row count.  The reference pads each window to a power-of-two bucket
(``pow2_bucket``/``bucketed_column``, ``plan/fuse.stream_bucket``) so that
XLA reuses one compiled program per bucket; the port's columns are
unpadded (``parallel/mesh.pad_len``) and ``fused.cu`` interprets a program
built once per chain, whatever the rows.
"""

from __future__ import annotations

from typing import Any, Optional

#: reductions with an exact algebraic combine of partials (a window's, or an
#: appended tail's in ``views/incremental.py``); every other one (median,
#: var, nunique, ...) stays resident
REDUCE_COMBINABLE = frozenset({"sum", "prod", "min", "max", "count", "mean"})

#: groupby aggregations with an exact partial-table combine
GROUPBY_COMBINABLE = frozenset({"sum", "min", "max", "count", "mean"})

#: the hooks' fast path: every streaming hook on a hot path (sort, merge,
#: plan lowering) reads this one attribute first.  True only where streaming
#: can apply: ``StreamMode`` Windowed, or Auto under a device budget.  The
#: default (Auto, no budget) costs the resident paths one attribute read.
STREAM_ON: bool = False

_BUDGET: Optional[int] = None
_MODE: str = "Auto"


def _refresh() -> None:
    global STREAM_ON
    STREAM_ON = _MODE == "Windowed" or (_MODE == "Auto" and _BUDGET is not None)


def _on_stream_mode(param: Any) -> None:
    global _MODE
    _MODE = param.get()
    _refresh()


def _on_budget(param: Any) -> None:
    global _BUDGET
    _BUDGET = param.get()
    _refresh()


def window_body(fn):
    """Mark ``fn`` as a window-loop body: it runs once per resident window
    and touches only the window handed to it (reading a whole captured
    frame from inside the loop would defeat the budget).  A marker, no
    wrapper."""
    fn.__stream_window_body__ = True
    return fn


class StreamDegrade(Exception):
    """The streaming executor cannot finish within its bounds (the groupby's
    partial table passed ``StreamMaxGroups``); the caller runs the resident
    path."""


def __getattr__(name: str) -> Any:
    # the executor and the external kernels load on first use: the query
    # compiler and the lowering import this package for STREAM_ON alone
    if name in ("maybe_stream_reduce", "maybe_stream_groupby", "window_loop"):
        from modin_tpu_torch.streaming import executor

        return getattr(executor, name)
    if name in ("external_sort_qc", "external_merge_qc"):
        from modin_tpu_torch.streaming import external

        return getattr(external, name)
    if name in ("WindowSource", "streamable_read_kwargs", "window_bytes_for"):
        from modin_tpu_torch.streaming import windows

        return getattr(windows, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


from modin_tpu_torch.config import DeviceMemoryBudget as _DeviceMemoryBudget  # noqa: E402
from modin_tpu_torch.config import StreamMode as _StreamMode  # noqa: E402

_StreamMode.subscribe(_on_stream_mode)
_DeviceMemoryBudget.subscribe(_on_budget)
