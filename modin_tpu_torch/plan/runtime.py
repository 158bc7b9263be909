"""Planner runtime: the glue between the query compiler and the plan IR.

The port's counterpart of ``modin_tpu/plan/runtime.py``.  The compiler's
plan-capable methods carry a one-line guard ("if a plan is pending, try to
defer") and everything behind it lives here: the mode gate
(``MODIN_TPU_TORCH_PLAN``), the header sniff that makes a read deferrable,
the node builders of each operator family, the materialization
(``optimize`` + ``lower``) and the safety predicates (row-lineage alignment,
pushdown eligibility) that decide when deferring is exactly equivalent to
eager execution.  Anything the planner cannot prove equivalent returns
``None``: the caller's next line touches ``_modin_frame`` and the pending
plan materializes through the property.

Modes:

- ``Off``   -- nothing defers; the eager port exactly.
- ``Auto``  -- supported reads defer; chained plan-capable calls extend the
  plan; any other operation materializes it through the existing seams.
- ``Force`` -- Auto, plus plan-capable calls on eager compilers start a
  plan at a :class:`~modin_tpu_torch.plan.ir.Source` leaf, so the rewrite
  rules keep applying after a materialization point.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import pandas

from modin_tpu_torch.logging.metrics import emit_metric
from modin_tpu_torch.observability import compile_ledger as _compile_ledger
from modin_tpu_torch.observability import meters as _meters
from modin_tpu_torch.observability import spans as _spans
from modin_tpu_torch.plan import lowering
from modin_tpu_torch.plan.ir import (
    MAX_PLAN_DEPTH,
    Filter,
    GroupbyAgg,
    Map,
    PlanNode,
    Project,
    Reduce,
    Ref,
    Scan,
    Sort,
    Source,
    count_nodes,
)
from modin_tpu_torch.plan.rules import optimize
from modin_tpu_torch.utils import MODIN_UNNAMED_SERIES_LABEL


def plan_mode() -> str:
    from modin_tpu_torch.config import PlanMode

    return PlanMode.get()


def force_on() -> bool:
    """Whether plan-capable calls on eager compilers start plans (Force)."""
    return plan_mode() == "Force"


# ---------------------------------------------------------------------- #
# Scan deferral
# ---------------------------------------------------------------------- #

#: read_csv kwargs left out of the header sniff (they conflict with
#: ``nrows=0`` or only affect the body)
_SNIFF_DROP = ("filepath_or_buffer", "iterator", "chunksize", "nrows", "skipfooter")


def _requests_extension_dtype(dtype: Any) -> bool:
    """Whether a ``dtype=`` read kwarg asks for a pandas extension dtype
    (NA-backed results break the IR's "comparisons are plain bool" claim)."""
    no_default = pandas.api.extensions.no_default
    if dtype is None or dtype is no_default:
        return False
    values = dtype.values() if isinstance(dtype, dict) else [dtype]
    for value in values:
        try:
            if isinstance(pandas.api.types.pandas_dtype(value), pandas.api.extensions.ExtensionDtype):
                return True
        except TypeError:
            return True  # unparseable: stay eager
    return False


def defer_read(dispatcher: type, kwargs: dict) -> Optional[Any]:
    """Defer a text-family read into a Scan-rooted plan, or None for eager.

    The sniff parses only the header (``nrows=0``) to learn the post-
    ``usecols`` column labels.  Any sniff failure declines the deferral, so
    the eager read raises at the call site as it always did.
    """
    if plan_mode() == "Off":
        return None
    kwargs = dispatcher.normalize_read_kwargs(dict(kwargs))
    if kwargs.get("iterator") or kwargs.get("chunksize") is not None:
        return None  # parser iterators, not frames
    path = kwargs.get("filepath_or_buffer")
    if not dispatcher.is_local_plain_file(path):
        return None
    dtype_backend = kwargs.get("dtype_backend")
    if dtype_backend is not None and dtype_backend is not pandas.api.extensions.no_default:
        return None
    if _requests_extension_dtype(kwargs.get("dtype")):
        return None
    sniff_kwargs = {k: v for k, v in kwargs.items() if k not in _SNIFF_DROP}
    try:
        header = dispatcher.read_fn(path, nrows=0, **sniff_kwargs)
        columns = pandas.Index(header.columns)
    except Exception:  # any sniff failure: not deferrable, the eager read raises
        return None
    scan = Scan(dispatcher, dict(kwargs), columns, colarg="usecols")
    emit_metric("plan.defer.scan", 1)
    return dispatcher.query_compiler_cls.from_plan(scan)


#: read_csv kwargs that make a reader-level projection unsafe, with the
#: values meaning "off" (``index_col`` has none: pandas resolves a
#: positional index_col within the usecols subset)
_PUSHDOWN_BLOCKERS = (
    ("index_col", (None,)),
    ("converters", (None,)),
    ("skipfooter", (None, 0)),
    ("parse_dates", (None, False)),
)


def scan_supports_pushdown(scan: Scan) -> bool:
    """Whether narrowing this scan's reader projection is exactly safe."""
    if scan.colarg != "usecols":
        return False
    kwargs = scan.read_kwargs
    no_default = pandas.api.extensions.no_default
    for key, disabled in _PUSHDOWN_BLOCKERS:
        value = kwargs.get(key)
        if value is no_default or any(value is d for d in disabled):
            continue
        return False
    usecols = kwargs.get("usecols")
    if usecols is not None and usecols is not no_default and callable(usecols):
        return False
    dtype = kwargs.get("dtype")
    if isinstance(dtype, dict) and any(k not in set(scan.all_columns) for k in dtype):
        return False  # a positional dtype key: the label filter would change the parse
    names = kwargs.get("names")
    if names is not None and names is not no_default:
        return False
    # the pushed projection is label-based: plain unique string labels only
    return scan.all_columns.is_unique and all(isinstance(c, str) for c in scan.all_columns)


# ---------------------------------------------------------------------- #
# Node builders (the deferral guards call these)
# ---------------------------------------------------------------------- #


def _plan_of(qc: Any) -> Optional[PlanNode]:
    """The operand's plan: an eager compiler wrapped in a Source under Force
    (never while lowering, which replays nodes through the same guarded
    methods); None at the depth cap (the caller then materializes)."""
    plan = qc._plan
    if plan is not None and plan.depth >= MAX_PLAN_DEPTH:
        return None
    if plan is None and force_on() and not lowering.in_lowering():
        plan = _source_of(qc)
    return plan


def _source_of(qc: Any) -> Source:
    """One memoized Source leaf per eager compiler: row keys are identity
    based, so a frame and its mask must share one leaf."""
    source = getattr(qc, "_plan_source", None)
    if source is None or source.qc._frame is not qc._frame:
        source = Source(qc.eager_snapshot())
        qc._plan_source = source
    return source


def _stamp_hint(qc: Any, plan: PlanNode) -> None:
    """Late-bind the API layer's shape hint (set after the deferring call
    returns) into the operand's node, for the series/frame label rules."""
    if isinstance(plan, (Project, Map)) and plan.out_hint is None and qc._shape_hint is not None:
        plan.out_hint = qc._shape_hint


def defer_project(qc: Any, key: Any, numeric: bool) -> Optional[Any]:
    plan = _plan_of(qc)
    if plan is None:
        return None
    keys = list(key)
    if numeric:
        try:
            keys = [int(k) for k in keys]
        except (TypeError, ValueError):
            return None
        width = len(plan.columns)
        if any(k < -width or k >= width for k in keys):
            return None  # out of range: eager raises at the call site
    else:
        columns = plan.columns
        if not columns.is_unique or any(k not in columns for k in keys):
            return None
    _stamp_hint(qc, plan)
    return type(qc).from_plan(Project(plan, tuple(keys), numeric))


def defer_filter(qc: Any, mask_qc: Any) -> Optional[Any]:
    """Defer ``df[bool_series]`` when the mask is a provably aligned,
    provably bool subplan of the same row lineage."""
    plan = _plan_of(qc)
    if plan is None or mask_qc._plan is None:
        return None
    mask_plan = mask_qc._plan
    if mask_plan.depth >= MAX_PLAN_DEPTH:
        return None
    mask_dtypes = mask_plan.known_dtypes()
    if (
        mask_dtypes is None
        or len(mask_dtypes) != 1
        or mask_dtypes.iloc[0] != bool
        or plan.row_key() != mask_plan.row_key()
    ):
        return None
    _stamp_hint(qc, plan)
    _stamp_hint(mask_qc, mask_plan)
    return type(qc).from_plan(Filter(plan, mask_plan))


_SCALAR_OPERANDS = (int, float, bool, str, type(None))


def _known_bool(plan: PlanNode) -> bool:
    dtypes = plan.known_dtypes()
    return dtypes is not None and all(dt == bool for dt in dtypes)


def _known_plain(plan: PlanNode) -> bool:
    """No KNOWN extension dtype in the node's output (scans are gated to
    plain numpy dtypes at defer time)."""
    dtypes = plan.known_dtypes()
    return dtypes is None or not any(isinstance(dt, pandas.api.extensions.ExtensionDtype) for dt in dtypes)


def defer_binary(qc: Any, op: str, other: Any, kwargs: dict) -> Optional[Any]:
    import numpy as np

    plan = _plan_of(qc)
    if plan is None:
        return None
    cls = type(qc)
    # comparisons of plain-dtype operands give plain bool; string
    # comparisons and logical ops on non-bool ints claim nothing
    bool_out = (op in cls._CMP_OPS and not isinstance(other, str) and _known_plain(plan)) or (
        op in cls._LOGICAL_OPS and _known_bool(plan)
    )
    hint = qc._shape_hint
    if isinstance(other, _SCALAR_OPERANDS + (np.generic,)) and not isinstance(other, bytes):
        _stamp_hint(qc, plan)
        node = Map((plan,), op, (other,), kwargs, out_columns=plan.columns, bool_out=bool_out, out_hint=hint)
        return cls.from_plan(node, hint)
    if isinstance(other, cls) and other._plan is not None:
        other_plan = other._plan
        if other_plan.depth >= MAX_PLAN_DEPTH or plan.row_key() != other_plan.row_key():
            return None
        if op in cls._LOGICAL_OPS:
            bool_out = bool_out and _known_bool(other_plan)
        elif op in cls._CMP_OPS:
            bool_out = bool_out and _known_plain(other_plan)
        other_hint = other._shape_hint
        if hint == "column" and other_hint == "column":
            a, b = plan.columns[0], other_plan.columns[0]
            out_columns = pandas.Index([a if a == b else MODIN_UNNAMED_SERIES_LABEL])
        elif hint is None and other_hint is None:
            if not plan.columns.equals(other_plan.columns):
                return None
            out_columns = plan.columns
        else:
            return None
        _stamp_hint(qc, plan)
        _stamp_hint(other, other_plan)
        node = Map((plan, other_plan), op, (Ref(1),), kwargs, out_columns=out_columns, bool_out=bool_out,
                   out_hint=hint)
        return cls.from_plan(node, hint)
    return None


def defer_unary(qc: Any, method: str, args: Tuple = (), kwargs: Optional[dict] = None,
                bool_out: bool = False) -> Optional[Any]:
    plan = _plan_of(qc)
    if plan is None:
        return None
    if not all(isinstance(a, _SCALAR_OPERANDS) for a in args):
        return None
    _stamp_hint(qc, plan)
    hint = qc._shape_hint
    node = Map((plan,), method, tuple(args), dict(kwargs or {}), out_columns=plan.columns,
               bool_out=bool_out, out_hint=hint)
    return type(qc).from_plan(node, hint)


def defer_sort(qc: Any, columns: Any, ascending: Any, kwargs: dict) -> Optional[Any]:
    plan = _plan_of(qc)
    if plan is None:
        return None
    col_list = [columns] if not isinstance(columns, (list, tuple)) else list(columns)
    plan_columns = plan.columns
    if not plan_columns.is_unique or any(c not in plan_columns for c in col_list):
        return None
    _stamp_hint(qc, plan)
    return type(qc).from_plan(Sort(plan, columns, ascending, kwargs), qc._shape_hint)


# ---------------------------------------------------------------------- #
# Materialization points
# ---------------------------------------------------------------------- #


def _optimize_and_lower(qc: Any, root: PlanNode, instrument: Optional[dict] = None) -> Tuple[Any, dict]:
    """One optimize + lower pass; records EXPLAIN's history (and, under
    ``OptMode=Auto``, the optimizer's strategies and re-plans) on ``qc``."""
    from modin_tpu_torch.plan import optimizer

    with _spans.span("plan.optimize", "QUERY-COMPILER", nodes=count_nodes(root)) as sp:
        optimized, applied = optimize(root)
        passes = (applied[-1][1] + 1) if applied else 1
        if sp is not None:
            sp.attrs["passes"] = passes
    emit_metric("plan.optimize.passes", passes)
    for name, _pass_index in applied:
        emit_metric(f"plan.rule.{name}", 1)
    strategies = optimizer.choose(optimized) if optimizer.OPT_ON else None
    result, memo = lowering.lower_traced(optimized, instrument=instrument, strategies=strategies)
    qc._plan_explain = (root, optimized, applied)
    qc._plan_strategies = strategies
    return result, memo


def explain_analyze(qc: Any) -> Optional[Tuple[dict, Any]]:
    """EXPLAIN ANALYZE: run ``qc``'s plan with per-node measurement.

    Returns ``(instrument, (root, optimized, applied))`` or None when there
    is nothing to analyze.  A pending plan executes and its frame is
    adopted, as :func:`force` does; an already-materialized compiler with a
    plan history re-executes the recorded plan and discards the result.
    """
    plan = getattr(qc, "_plan", None)
    pending = plan is not None
    if pending:
        root = plan
    else:
        history = getattr(qc, "_plan_explain", None)
        if history is None:
            return None
        root = history[0]
    instrument: dict = {}
    # a meter scope: accounting (and, under Auto, cost capture) is on for
    # the run, so each node bills the bytes and operations of its launches
    with _meters.query_stats("explain.analyze"):
        result, _memo = _optimize_and_lower(qc, root, instrument=instrument)
    # the nodes' launch events (while tracing is on), with one synchronize
    _compile_ledger.resolve_events()
    if pending:
        qc._frame = result._modin_frame
        qc._plan = None
    return instrument, qc._plan_explain


def force(qc: Any):
    """Materialize a pending plan; returns the concrete frame."""
    plan = qc._plan
    if plan is None:
        if qc._frame is None:
            raise RuntimeError("deferred query compiler used after its plan was dropped")
        return qc._frame
    result, _memo = _optimize_and_lower(qc, plan)
    qc._frame = result._modin_frame
    qc._plan = None
    return qc._frame


def _adopt_lowered_input(qc: Any, memo: dict) -> None:
    """Adopt the materialization's lowered input back into ``qc``, so a
    later op on it reuses the scan instead of reading again."""
    lowered_input = memo.get(id(qc._plan_explain[1].children[0]))
    if lowered_input is not None and qc._plan is not None:
        qc._frame = lowered_input._modin_frame
        qc._plan = None


def run_reduce(qc: Any, op: str, call_kwargs: dict) -> Optional[Any]:
    """A reduction is a materialization point: append the Reduce node and
    run the whole optimized plan."""
    plan = _plan_of(qc)
    if plan is None:
        return None
    _stamp_hint(qc, plan)
    result, memo = _optimize_and_lower(qc, Reduce(plan, op, call_kwargs))
    _adopt_lowered_input(qc, memo)
    return result


def run_groupby_agg(qc: Any, by: Any, agg_func: Any, call_kwargs: dict) -> Optional[Any]:
    """A groupby aggregation materializes like a reduction (its index is
    group-dependent, which the IR does not model)."""
    plan = _plan_of(qc)
    if plan is None:
        return None
    cls = type(qc)
    children: Tuple[PlanNode, ...] = (plan,)
    by_payload = by
    if isinstance(by, cls):
        if by._plan is None or by._plan.row_key() != plan.row_key():
            return None
        _stamp_hint(by, by._plan)
        children = (plan, by._plan)
        by_payload = Ref(1)
    elif not (isinstance(by, (str, list, tuple)) and (isinstance(by, str) or all(isinstance(b, str) for b in by))):
        return None
    _stamp_hint(qc, plan)
    result, memo = _optimize_and_lower(qc, GroupbyAgg(children, by_payload, agg_func, call_kwargs))
    _adopt_lowered_input(qc, memo)
    return result


# ---------------------------------------------------------------------- #
# Metadata and the public opt-in
# ---------------------------------------------------------------------- #


def plan_columns(qc: Any) -> pandas.Index:
    return qc._plan.columns


def plan_dtypes(qc: Any) -> Optional[pandas.Series]:
    return qc._plan.known_dtypes()


def defer_frame(obj: Any) -> Any:
    """Root a plan at an existing port DataFrame, Series or compiler: the
    same type over a Source-rooted deferred compiler, so chained
    plan-capable calls extend the plan under ``Auto`` too."""
    qc = getattr(obj, "_query_compiler", obj)
    planned = type(qc).from_plan(Source(qc.eager_snapshot()), qc._shape_hint)
    if hasattr(obj, "_query_compiler"):
        return type(obj)(query_compiler=planned)
    return planned
