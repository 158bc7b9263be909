"""The whole-query deferred planner of the port (the reference's graftplan).

The port's counterpart of ``modin_tpu/plan``.  Above the elementwise fusion
of ``ops/lazy.py`` (which batches chained elementwise ops into one launch of
the fused kernel), the planner batches chained query operators (scan,
project, filter, map, reduce, groupby_agg, sort) into a logical plan,
rewrites it (dead-column pruning, projection pushdown into the CSV reader's
``usecols``, filter pushdown, common-subexpression elimination, map->reduce
fusion) and only then lowers it through the eager seams, a reduction or
groupby tail as masked fused launches with no compaction.  The acceptance
shape ``read_csv(p).query("a > 0")[["b", "c"]].agg("sum")`` parses only
``a``, ``b`` and ``c`` and runs its device leg as one launch.

- :mod:`~modin_tpu_torch.plan.ir`       -- immutable plan nodes, DAG utilities
- :mod:`~modin_tpu_torch.plan.rules`    -- the rewrite rules, to a fixpoint
- :mod:`~modin_tpu_torch.plan.lowering` -- plan -> eager ``TorchQueryCompiler``
- :mod:`~modin_tpu_torch.plan.fuse`     -- the masked whole-plan fused leg
- :mod:`~modin_tpu_torch.plan.runtime`  -- the compiler's deferral guards' glue
- :mod:`~modin_tpu_torch.plan.explain`  -- EXPLAIN and EXPLAIN ANALYZE

The mode knob is ``MODIN_TPU_TORCH_PLAN`` (Auto | Off | Force); the fused
leg's are ``MODIN_TPU_TORCH_FUSE`` (Auto | Staged | Fused) and
``MODIN_TPU_TORCH_FUSE_MIN_ROWS``.
"""

from modin_tpu_torch.plan.ir import (  # noqa: F401
    Filter,
    GroupbyAgg,
    Map,
    PlanNode,
    Project,
    Reduce,
    Scan,
    Sort,
    Source,
)
from modin_tpu_torch.plan.rules import RULES, optimize  # noqa: F401
from modin_tpu_torch.plan.runtime import defer_frame, plan_mode  # noqa: F401
from modin_tpu_torch.plan.explain import explain_qc, render  # noqa: F401
