"""Where ``groupagg`` pays: the groupby half of the route gate.

The planner's masked fused leg (``plan/fuse.py``) and the eager groupby's
``groupagg`` route (``ops/groupby.py::takes_groupagg``) first ask the
kernel router's fused/staged gate (``ops/router.decide_compile``:
``MODIN_TPU_TORCH_FUSE`` pins a side, ``MODIN_TPU_TORCH_FUSE_MIN_ROWS`` keeps
small inputs staged), then :func:`decide_groupby` for a groupby's table.
It imports no pandas, so the ops layer can ask it.
"""

from __future__ import annotations


def staged_sorts(agg: str, any_float: bool) -> bool:
    """Whether the staged groupby computes ``agg`` by sorting the codes and
    reducing each group's segment in order (a mean, and a float sum or
    product), rather than by one atomic ``index_add_``/``scatter_reduce_``
    a column (int sums and products, min, max, counts)."""
    return agg == "mean" or (agg in ("sum", "prod") and any_float)


#: the widest table on which ``groupagg`` beats the staged path's atomic
#: aggregations: on an H100 at 1e8 rows of uniform int64 codes
#: (``chip_smoke.py``'s kernel check, its ``eager_*`` cases) a 1-D
#: ``index_add_`` took 16.6 ms into 101 slots and 5.4 into 1001 against the
#: kernel's 1.8 and 3.0, but 2.9 into 4001 and 2.0 into 10 001 against 3.8
#: and 4.5 (``scatter_reduce_``'s min: 31.2, 10.4, 4.4, 3.9 against 1.8,
#: 3.1, 3.8, 4.7)
ATOMIC_MAX_SLOTS = 1025


def decide_groupby(n: int, slots: int, agg: str, n_cols: int, any_float: bool) -> bool:
    """Whether a groupby of ``n`` rows takes ``groupagg`` for ``agg`` over
    ``slots`` table slots and ``n_cols`` value columns (``any_float``: one
    of them is a float column), the gate of the fused groupby's launch and
    of the eager ``groupby_reduce``'s alike: always under ``FuseMode=Fused``;
    under Auto where one block's shared memory holds the whole table
    (``launch_geometry``'s ``ranges`` is 1; slot ranges re-read the rows)
    and, where the staged path folds by atomics (:func:`staged_sorts` false),
    only up to ``ATOMIC_MAX_SLOTS`` slots, where those atomics contend.  A
    staged sorted aggregation pays its sort at every width: at 1e8 rows a
    float64 sum took 15.7 ms staged against 2.0 on ``groupagg`` at 100
    groups and 16.2 against 5.1 at 10 000 (H100, ``chip_smoke.py``'s kernel
    check); phase 13's route sweep holds both rules at 5e6 rows."""
    from modin_tpu_torch.config import FuseMode
    from modin_tpu_torch.ops.cuda.groupagg_kernels import MAX_COLS, launch_geometry

    if FuseMode.get() == "Fused":
        return True
    if launch_geometry(n, slots, min(n_cols, MAX_COLS)).ranges > 1:
        return False
    return staged_sorts(agg, any_float) or slots <= ATOMIC_MAX_SLOTS
