"""The plan optimizer: one cost-based strategy pass over the planner's IR.

The port's counterpart of ``modin_tpu/plan/optimizer.py`` (graftopt), for
the legs the port has:

- :func:`choose` runs once per plan materialization and annotates every
  node with a :class:`NodeStrategy`: estimated rows, bytes and seconds
  (:func:`_estimate_nodes`, from the kernel router's calibration through
  :func:`~modin_tpu_torch.ops.router.calibration_peek`: planning never
  triggers a measurement) and its strategy legs: kernel (a sort-shaped
  reduction's device or host side under the router's model, or "view"
  where a cached artifact answers it), compile
  (fused or staged), layout (local, or sharded over a mesh of two or more
  row shards) and residency (resident, or windowed
  where its input passes the device ledger's headroom under
  ``DeviceMemoryBudget``).  EXPLAIN renders them.
- Mid-query re-estimation: lowering times each node and feeds its wall
  to :func:`observe` between :func:`begin` and :func:`end`; a node whose
  wall passes its estimate by ``MODIN_TPU_TORCH_OPT_REPLAN_FACTOR`` (above
  :data:`REPLAN_NOISE_FLOOR_S`) re-chooses the rest of the plan with the
  ratio, clamped at :data:`MAX_CORRECTION`, as a correction of its
  estimates (``wall_divergence``), at most once per node; EXPLAIN shows it.
  Under Off no :class:`PlanStrategies` is ever built
  (:func:`opt_alloc_count`).

Where the port departs from the reference, and why:

- only the residency leg answers a live router verdict: the reference's
  routers offer each verdict to a consult hook that answers from a firm
  plan leg or the wall correction.  The port installs the hook
  (``router._opt_consult``, :func:`_consult`) for ``decide_residency``
  alone: a plan whose residency was planned resident but meets a
  windowed live verdict re-plans (``ledger_pressure``) and follows it, and
  a planned verdict that disagrees with the live one answers for it.  The
  kernel and compile legs have nothing firmer than the live verdict
  behind them: the correction comes from whole-node walls against
  :data:`DEFAULT_PRIORS` (not measurements of any card), so a slow parse
  or a first kernel build would send a sort-shaped reduction on
  card-resident columns to pandas.  So the kernel leg is the router's
  uncorrected prediction, and the compile leg is firm only under the
  joint constraints: a windowed tail runs the staged body per window
  (``streaming/executor.py``; a filtered reduction's window still takes
  one masked launch through ``fuse.window_reduce_plan``) and never
  donates, since the window loop owns its inputs (:func:`donate_ok`);
- priors: the reference seeds its per-row coefficients from its
  ``PERF_HISTORY.json``, TPU and CPU walls that must not seed the port;
  :func:`priors_from_history` takes only runs recorded on ``cuda``, and no
  such ledger exists yet (observability), so the model runs on the
  calibration and :data:`DEFAULT_PRIORS`;
- the compile-storm trigger: it reads a launch ledger the port does not
  keep (observability);
- the layout leg is ``decide_layout``'s arms over the resolved table
  (``router.planned_layout``: a single shard, the forced modes and the row
  floor answer first, a table without the sharded entries "local"); the
  live verdict is the router's: both sides of the layout model scale by
  the same correction, so a re-plan never flips it, and the live verdict
  sees the payload widths the plan does not;
- the cost-gated rule order of ``plan/rules.optimize`` with its objective
  ``plan_cost``.

The kernel leg is "view" where a live artifact of ``views/`` already
answers a sort-shaped reduction over an in-memory source
(:func:`_view_hit`, a probe that counts nothing).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from modin_tpu_torch.logging.metrics import emit_metric
from modin_tpu_torch.observability import spans as _spans
from modin_tpu_torch.ops import calibration as calstore
from modin_tpu_torch.ops import router
from modin_tpu_torch.plan.ir import Filter, GroupbyAgg, Map, PlanNode, Project, Reduce, Scan, Sort, Source, walk

#: the sort-shaped families the kernel router arbitrates
SORT_SHAPED = frozenset({"median", "quantile", "nunique", "mode"})

#: measured walls at or below this never trigger a ``wall_divergence``
#: re-plan: at a few milliseconds the divergence is noise
REPLAN_NOISE_FLOOR_S = 0.005

#: the clamp on a correction ratio: one wild measurement must not push
#: every later crossover to infinity, yet a table off by orders of
#: magnitude must still be able to flip them
MAX_CORRECTION = 1e6

#: coefficients for node families no calibration covers: the reference's
#: fallback figures, kept so the two plan-time models agree; they are not
#: measurements of any card
DEFAULT_PRIORS: Dict[str, float] = {
    "parse_bytes_per_s": 120e6,
    "mem_bytes_per_s": 2e9,
    "bytes_per_row": 64.0,
}

#: whether the optimizer runs (``OptMode`` Auto), kept current by the
#: subscription at the bottom of the module
OPT_ON: bool = True
#: re-plans so far, ``{trigger: count}``
REPLANS: Dict[str, int] = {}

_alloc_count = 0
_tls = threading.local()
_priors_lock = threading.Lock()
#: None = not resolved; False = no ledger; a dict = the priors
_priors: Any = None


def opt_alloc_count() -> int:
    """:class:`PlanStrategies` built so far (none while ``OptMode`` is Off)."""
    return _alloc_count


class NodeStrategy:
    """One plan node's strategy legs and cost estimate.  ``legs`` maps a leg
    (kernel, layout, compile, residency) to its planned choice and
    ``leg_ops`` to the router op it stands for."""

    __slots__ = ("node", "legs", "leg_ops", "firm", "donate", "est_rows", "est_bytes", "est_s", "measured_s",
                 "measured_bytes")

    def __init__(self, node: PlanNode):
        self.node = node
        self.legs: Dict[str, str] = {}
        self.leg_ops: Dict[str, str] = {}
        #: legs the joint constraints fixed (EXPLAIN marks them ``!``)
        self.firm: Set[str] = set()
        #: whether the node's fused leg may donate its inputs
        self.donate: bool = True
        self.est_rows: Optional[int] = None
        self.est_bytes: Optional[int] = None
        self.est_s: float = 0.0
        self.measured_s: Optional[float] = None
        #: a streamed source's size, as the window loop sniffed it
        self.measured_bytes: Optional[int] = None


class PlanStrategies:
    """The strategy annotation of one plan materialization."""

    __slots__ = ("by_node", "replans", "fired", "correction", "root", "done", "priors")

    def __init__(self) -> None:
        global _alloc_count
        _alloc_count += 1
        self.by_node: Dict[int, NodeStrategy] = {}
        self.replans: List[dict] = []
        self.fired: Set[Tuple[Any, str]] = set()
        self.correction: float = 1.0
        self.root: Optional[PlanNode] = None
        self.done: Optional[dict] = None
        self.priors: Dict[str, Any] = dict(DEFAULT_PRIORS)


def _on_opt_mode(param: Any) -> None:
    global OPT_ON
    OPT_ON = param.get().lower() != "off"
    # the router's consult hook comes and goes with the mode: Off pays one
    # `is not None` read a residency verdict
    router._opt_consult = _consult if OPT_ON else None


def set_priors(priors: Optional[Dict[str, Any]]) -> None:
    """Force the priors (tests) or reset them to lazy resolution (None)."""
    global _priors
    with _priors_lock:
        _priors = priors


def default_history_path() -> Optional[str]:
    """The port's ledger of card runs: none is kept yet (observability)."""
    return None


def priors_from_history(path: Optional[str] = None) -> Optional[dict]:
    """Per-row coefficients from a run ledger (the reference's
    ``PERF_HISTORY.json`` format), counting only runs recorded on
    ``"substrate": "cuda"``: a later run supersedes an earlier one.  None
    when no such run is readable."""
    path = path or default_history_path()
    if path is None:
        return None
    try:
        with open(path) as f:
            ledger = json.load(f)
    except (OSError, ValueError):
        return None
    runs = ledger.get("runs") if isinstance(ledger, dict) else None
    s_per_row: Dict[str, float] = {}
    for run in runs if isinstance(runs, list) else ():
        if not isinstance(run, dict) or run.get("substrate") != "cuda":
            continue
        rows = (run.get("scale") or {}).get("rows", run.get("rows"))
        for op, entry in (run.get("ops") or {}).items():
            wall = (entry or {}).get("port_s")
            if isinstance(wall, (int, float)) and wall > 0 and isinstance(rows, (int, float)) and rows > 0:
                s_per_row[op] = float(wall) / float(rows)
    if not s_per_row:
        return None
    priors: Dict[str, Any] = dict(DEFAULT_PRIORS, s_per_row=s_per_row, source=path)
    for key, candidates in (
        ("reduce_s_per_row", ("sum", "mean")),
        ("sortred_s_per_row", ("median", "nunique", "mode")),
        ("groupby_s_per_row", ("gb_sum", "gb_mean")),
        ("sort_s_per_row", ("sort_values",)),
    ):
        for op in candidates:
            if op in s_per_row:
                priors[key] = s_per_row[op]
                break
    return priors


def _resolve_priors() -> Dict[str, Any]:
    global _priors
    with _priors_lock:
        if _priors is None:
            _priors = priors_from_history() or False
        return _priors if _priors is not False else dict(DEFAULT_PRIORS)


# ---------------------------------------------------------------------- #
# the plan-time cost model
# ---------------------------------------------------------------------- #


def _scan_bytes(node: Scan) -> Optional[int]:
    """The source file's size, or None where it cannot be read."""
    path = node.read_kwargs.get("filepath_or_buffer")
    if path is None:
        return None
    try:
        return int(node.dispatcher.file_size(path))
    except (OSError, TypeError, ValueError, AttributeError):
        return None


def _source_shape(node: Source) -> Tuple[Optional[int], Optional[int]]:
    """(rows, bytes) of a materialized Source frame, forcing nothing."""
    frame = getattr(node.qc, "_frame", None)
    if frame is None:
        return None, None
    nbytes = 0
    for col in frame._columns:
        if col.is_device:
            nbytes += col.length * col.pandas_dtype.itemsize
        else:
            nbytes += int(getattr(col.data, "nbytes", 0) or 0)
    return len(frame), nbytes


def estimate_selectivity(mask: PlanNode) -> float:
    """The estimated fraction of rows a filter mask passes, from its
    operator: equality passes few, an order comparison half; conjunctions
    multiply, disjunctions saturate."""
    if isinstance(mask, Map):
        method = str(mask.method).lower().strip("_")
        if method == "eq":
            return 0.1
        if method == "ne":
            return 0.9
        if method in ("gt", "lt", "ge", "le"):
            return 0.5
        if method in ("isin", "isna", "isnull"):
            return 0.2
        if method in ("notna", "notnull"):
            return 0.8
        if method in ("and", "mul"):
            out = 1.0
            for c in mask.children:
                out *= estimate_selectivity(c)
            return max(out, 0.01)
        if method in ("or", "add"):
            return min(sum(estimate_selectivity(c) for c in mask.children), 1.0)
        if method in ("invert", "not"):
            return 1.0 - estimate_selectivity(mask.children[0])
    return 0.8


def _estimate_nodes(root: PlanNode, priors: Dict[str, Any], correction: float,
                    table: Optional[Dict[str, float]]) -> Dict[int, dict]:
    """Bottom-up (rows, bytes, seconds) per node id; seconds are
    subtree-cumulative, as lowering measures them, and scaled by the
    re-plan ``correction``."""
    mem_bw = float(priors["mem_bytes_per_s"])
    parse_bw = float(priors.get("parse_bytes_per_s") or 120e6)
    bytes_per_row = float(priors.get("bytes_per_row") or 64.0)
    est: Dict[int, dict] = {}
    for node in walk(root):
        child = est.get(id(node.children[0])) if node.children else None
        rows = child["rows"] if child else None
        nbytes = child["bytes"] if child else None
        child_s = sum(est[id(c)]["s"] for c in node.children if id(c) in est)
        own_s = 0.0
        if isinstance(node, Scan):
            nbytes = _scan_bytes(node)
            if nbytes is not None:
                rows = max(int(nbytes / bytes_per_row), 1)
                scan_coeff = priors.get("scan_s_per_row")
                own_s = rows * float(scan_coeff) if scan_coeff else nbytes / parse_bw
                if node.pruned is not None and len(node.all_columns):
                    frac = max(len(node.pruned), 1) / len(node.all_columns)
                    nbytes = int(nbytes * frac)
                    if node.pushed:
                        own_s *= frac
        elif isinstance(node, Source):
            rows, nbytes = _source_shape(node)
        elif isinstance(node, Filter):
            sel = estimate_selectivity(node.children[1])
            if rows is not None:
                rows = max(int(rows * sel), 1)
            if nbytes is not None:
                own_s = nbytes / mem_bw
                nbytes = max(int(nbytes * sel), 1)
        elif isinstance(node, Project):
            if nbytes is not None:
                width = (len(node.children[0].all_columns) or None) if isinstance(node.children[0], Scan) else None
                frac = len(node.keys) / width if width else 0.5
                nbytes = max(int(nbytes * min(frac, 1.0)), 1)
                own_s = nbytes / mem_bw
        elif isinstance(node, Map):
            if nbytes is not None:
                own_s = nbytes / mem_bw
        elif isinstance(node, Reduce):
            own_s = _reduce_cost(node, rows, nbytes, table, priors, mem_bw)
            rows, nbytes = 1, 8
        elif isinstance(node, GroupbyAgg):
            coeff = priors.get("groupby_s_per_row")
            if coeff and rows is not None:
                own_s = rows * float(coeff)
            elif nbytes is not None:
                own_s = 2.0 * nbytes / mem_bw
            if rows is not None:
                rows = max(int(rows**0.5), 1)
                nbytes = rows * 16
        elif isinstance(node, Sort):
            coeff = priors.get("sort_s_per_row")
            if table is not None and rows is not None:
                own_s = router.device_term(table, "sort", calstore.nlogn_scale(rows, int(table["rows"])))
            elif coeff and rows is not None:
                own_s = rows * float(coeff)
            elif nbytes is not None and rows is not None:
                own_s = nbytes * max(rows, 2).bit_length() / mem_bw
        est[id(node)] = {"rows": rows, "bytes": nbytes, "s": own_s * correction + child_s}
    return est


def _reduce_cost(node: Reduce, rows: Optional[int], nbytes: Optional[int], table: Optional[Dict[str, float]],
                 priors: Dict[str, Any], mem_bw: float) -> float:
    """One reduction's own seconds: for a sort-shaped family with a
    resolved calibration, the cheaper of the router's predicted sides."""
    if node.method in SORT_SHAPED:
        if table is not None and rows is not None:
            costs = router.predicted_costs(node.method, rows, ["sort"], table)
            return min(costs["device_s"], costs["host_s"])
        coeff = priors.get("sortred_s_per_row")
        if coeff and rows is not None:
            return rows * float(coeff)
    coeff = priors.get("reduce_s_per_row")
    if coeff and rows is not None:
        return rows * float(coeff)
    return nbytes / mem_bw if nbytes is not None else 0.0


# ---------------------------------------------------------------------- #
# choose(): the plan-time pass
# ---------------------------------------------------------------------- #


def choose(root: PlanNode, state: Optional[PlanStrategies] = None,
           exclude: Optional[Set[int]] = None) -> PlanStrategies:
    """Annotate every node with its strategy legs.  With ``state`` it is a
    re-plan: the nodes not in ``exclude`` (the already-lowered ones) are
    re-chosen in place under the accumulated correction."""
    replanning = state is not None
    if state is None:
        state = PlanStrategies()
        state.root = root
        state.priors = _resolve_priors()
    exclude = exclude or set()
    with _spans.span("opt.choose", "QUERY-COMPILER", replanning=replanning):
        table = router.calibration_peek()
        est = _estimate_nodes(root, state.priors, state.correction, table)
        for node in walk(root):
            if id(node) in exclude:
                continue
            st = state.by_node.get(id(node))
            if st is None:
                st = state.by_node[id(node)] = NodeStrategy(node)
            entry = est.get(id(node), {})
            st.est_rows = entry.get("rows")
            st.est_bytes = entry.get("bytes")
            st.est_s = float(entry.get("s") or 0.0)
            # the legs are chosen over the node's input (a reduction's own
            # output is one row, which decides nothing)
            child_entry = est.get(id(node.children[0]), {}) if node.children else {}
            _choose_node(node, st, table, child_entry)
    emit_metric("opt.choose", 1)
    return state


def _choose_node(node: PlanNode, st: NodeStrategy, table: Optional[Dict[str, float]],
                 child_entry: Dict[str, Any]) -> None:
    in_rows = child_entry.get("rows")
    if isinstance(node, (Reduce, GroupbyAgg)):
        groupby = isinstance(node, GroupbyAgg)
        residency = _plan_residency(child_entry.get("bytes"))
        st.legs["residency"] = residency
        st.leg_ops["residency"] = "scan_groupby" if groupby else "scan_reduce"
        st.firm.add("residency")
        if residency == "windowed":
            # the joint constraints: a windowed tail runs its segment once a
            # window, never as one whole-plan launch, and donating would
            # free tensors the window loop still owns
            st.legs["compile"] = "staged"
            st.firm.add("compile")
            st.donate = False
        else:
            st.legs["compile"] = "fused" if _would_fuse(in_rows) else "staged"
        if not groupby and node.method in SORT_SHAPED:
            st.legs["kernel"] = _plan_kernel(node, in_rows, table)
            st.leg_ops["kernel"] = node.method
    elif isinstance(node, Sort):
        st.legs["layout"] = router.planned_layout("sort", in_rows)
        st.leg_ops["layout"] = "sort"


def _plan_residency(in_bytes: Optional[int]) -> str:
    """``decide_residency`` over the plan-time estimate of the consumed
    working set (the same pins, ledger and headroom), so a steady plan
    agrees with the live router and only a re-plan departs from it."""
    from modin_tpu_torch.config import StreamMode
    from modin_tpu_torch.core.memory import device_ledger

    mode = StreamMode.get()
    if mode != "Auto":
        return mode.lower()
    budget = device_ledger.budget()
    if budget is None or in_bytes is None:
        return "resident"
    return "windowed" if in_bytes > budget - max(device_ledger.total_bytes(), 0) else "resident"


def _would_fuse(est_rows: Optional[int]) -> bool:
    from modin_tpu_torch.config import FuseMinRows, FuseMode

    mode = FuseMode.get().lower()
    if mode in ("fused", "staged"):
        return mode == "fused"
    return est_rows is not None and est_rows >= int(FuseMinRows.get())


def _plan_kernel(node: Reduce, in_rows: Optional[int], table: Optional[Dict[str, float]]) -> str:
    """The planned leg of a sort-shaped reduction: "view" where a live
    artifact already answers it, else the router's device/host prediction
    for a sorted column (the live ``decide`` sees the real per-column
    strategies and has the last word)."""
    if _view_hit(node):
        return "view"
    if table is None or in_rows is None:
        return "device"
    costs = router.predicted_costs(node.method, in_rows, ["sort"], table)
    return "host" if costs["device_s"] - costs["host_s"] > router.MIN_SAVINGS_S else "device"


def _view_hit(node: Reduce) -> bool:
    """Whether a live artifact of the registry already answers this
    reduction over an in-memory Source: a planning probe (nothing counted,
    no LRU touch)."""
    from modin_tpu_torch import views

    child = node.children[0]
    if not views.VIEWS_ON or not isinstance(child, Source):
        return False
    from modin_tpu_torch.views import registry

    sortred = f"sortred.{node.method}"
    for col in child.qc._modin_frame._columns:
        if col.is_device:
            for kind in registry.column_artifact_kinds(col):
                if kind == "reduce" or kind == sortred:
                    return True
    return False


# ---------------------------------------------------------------------- #
# lowering: node scope, observation, re-planning
# ---------------------------------------------------------------------- #


def begin(state: PlanStrategies, root: PlanNode, memo: dict) -> None:
    """Install a strategy set for one lowering pass (paired with :func:`end`)."""
    state.root = root
    state.done = memo
    _tls.state = state
    _tls.stack = []


def end() -> None:
    _tls.state = None
    _tls.stack = None


def push_node(node: PlanNode) -> None:
    """Enter ``node``'s lowering: the consult and :func:`donate_ok` read the
    innermost node's strategy."""
    state = getattr(_tls, "state", None)
    if state is not None:
        _tls.stack.append(state.by_node.get(id(node)))


def pop_node() -> None:
    stack = getattr(_tls, "stack", None)
    if stack:
        stack.pop()


def _current() -> Tuple[Optional[PlanStrategies], Optional[NodeStrategy]]:
    state = getattr(_tls, "state", None)
    if state is None:
        return None, None
    stack = getattr(_tls, "stack", None)
    return state, (stack[-1] if stack else None)


def planned_compile() -> Optional[str]:
    """The node being lowered's compile leg where the joint constraints
    fixed it (a windowed residency: "staged"), else None."""
    _state, st = _current()
    if st is None or "compile" not in st.firm:
        return None
    return st.legs.get("compile")


def donate_ok() -> bool:
    """Whether the node being lowered may donate its inputs: False once the
    joint constraints or a re-plan windowed it."""
    _state, st = _current()
    return st.donate if st is not None else True


def note_stream_bytes(nbytes: int) -> None:
    """The window loop's sniffed source size, for EXPLAIN beside the
    estimate."""
    _state, st = _current()
    if st is not None:
        st.measured_bytes = int(nbytes)


def observe(node: PlanNode, total_s: float) -> None:
    """Feed a lowered node's measured wall back; re-plans the rest of the
    query where the estimate was off by more than the re-plan factor."""
    state = getattr(_tls, "state", None)
    if state is None:
        return
    st = state.by_node.get(id(node))
    if st is None:
        return
    st.measured_s = total_s
    if st.est_s <= 0.0 or total_s <= REPLAN_NOISE_FLOOR_S:
        return
    from modin_tpu_torch.config import OptReplanFactor

    if total_s <= st.est_s * float(OptReplanFactor.get()):
        return
    _replan(state, "wall_divergence", key=id(node), node_label=type(node).__name__, est_s=st.est_s,
            measured_s=total_s, correction=min(total_s / st.est_s, MAX_CORRECTION))


def _replan(state: PlanStrategies, trigger: str, key: Any, **attrs: Any) -> bool:
    """Re-choose the not-yet-lowered part of the plan, at most once per
    (key, trigger); returns whether it ran."""
    fired_key = (key, trigger)
    if fired_key in state.fired or state.root is None:
        return False
    state.fired.add(fired_key)
    correction = attrs.get("correction")
    if correction is not None:
        state.correction = max(state.correction, float(correction))
    exclude = set(state.done or ())
    t0 = time.perf_counter()
    choose(state.root, state=state, exclude=exclude)
    state.replans.append({
        "trigger": trigger,
        "remaining_nodes": len(state.by_node) - len(exclude),
        **{k: (round(v, 6) if isinstance(v, float) else v) for k, v in attrs.items()},
        "replan_s": round(time.perf_counter() - t0, 6),
    })
    REPLANS[trigger] = REPLANS.get(trigger, 0) + 1
    emit_metric(f"opt.replan.{trigger}", 1)
    if _spans.TRACE_ON:
        _spans.event("opt.replan", "QUERY-COMPILER", **state.replans[-1])
    return True


# ---------------------------------------------------------------------- #
# the router's consult hook
# ---------------------------------------------------------------------- #


def _consult(leg: str, choice: str, reason: str, **ctx: Any) -> Optional[Tuple[str, str]]:
    """Answer one live residency verdict from the plan: a replacement
    ``(choice, reason)`` only where the plan disagrees (agreement keeps the
    router's own choice and reason)."""
    state, st = _current()
    if state is None or leg != "residency":
        return None
    if st is None or st.leg_ops.get("residency") != ctx.get("op"):
        return None
    planned = st.legs.get("residency")
    if planned is None:
        return None
    if planned == "resident" and choice == "windowed":
        # live ledger pressure contradicts the plan: re-plan the rest
        # against the pressured ledger, and window this node (its compile
        # leg staged, no donation) whatever the re-plan's estimate says
        _replan(state, "ledger_pressure", key=id(st.node), est_bytes=int(ctx.get("est_bytes") or 0))
        st.legs["residency"] = "windowed"
        st.legs["compile"] = "staged"
        st.firm.update(("residency", "compile"))
        st.donate = False
        return ("windowed", "opt_replan")
    if planned != choice:
        return (planned, "opt")
    return None


# the subscription fires at once (setting OPT_ON and the consult hook), so
# it stands below the functions it names
from modin_tpu_torch.config import OptMode as _OptMode  # noqa: E402

_OptMode.subscribe(_on_opt_mode)
