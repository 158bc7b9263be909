"""Planner EXPLAIN: the plan before and after the rewrite, per-rule attribution.

The port's counterpart of ``modin_tpu/plan/explain.py``.  ``qc.explain()``
renders the logical plan before and after the rewrite pass and which rules
fired on which pass; ``qc.explain(analyze=True)`` executes the plan and
annotates every node with its measured wall time, rows, bytes and kernel
launches, and its cost: the bytes and operations its launches moved (from
each kernel wrapper's shapes, ``observability/costs.py``), the bandwidth
and the roofline fraction against the peaks measured on this device, over
the launches' event time while tracing is on and over the node's wall
(marked ``~host``) otherwise, and the padding share.  Under
``MODIN_TPU_TORCH_OPT=Auto`` a materialized plan also shows each node's
strategy legs with its estimated and measured wall, and the optimizer's
re-plans.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from modin_tpu_torch.plan.ir import PlanNode
from modin_tpu_torch.plan.rules import optimize

_EAGER = (
    "status: eager (no deferred plan; set MODIN_TPU_TORCH_PLAN=Auto and start "
    "from a deferrable read, or use modin_tpu_torch.plan.defer_frame)"
)


def _fmt_bytes(n: Optional[int]) -> str:
    if n is None:
        return "?"
    if n >= 1 << 20:
        return f"{n / (1 << 20):.1f}MiB"
    if n >= 1 << 10:
        return f"{n / (1 << 10):.1f}KiB"
    return f"{n}B"


def _fmt_count(n: Optional[float]) -> str:
    """Compact rendering of an operation count: 1234567 -> ``1.2M``."""
    if n is None:
        return "?"
    n = float(n)
    for scale, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
        if n >= scale:
            return f"{n / scale:.1f}{suffix}"
    return f"{n:.0f}"


def _cost_suffix(measured: dict) -> str:
    """The cost leg of a node: the bytes and operations its launches moved,
    the bandwidth and the roofline fraction over its launches' event time
    (device clock) where events were on, else over the node's measured wall
    (host clock, marked ``~host``: the wall includes the fetch that waits
    for the card where the node's result comes to the host), and the
    padding share.  ``cost=off`` when cost capture was off for the run."""
    if "est_bytes" not in measured:
        return " cost=off"
    from modin_tpu_torch.observability import costs as _costs

    est_flops, est_bytes = measured["est_flops"], measured["est_bytes"]
    device = measured.get("device")
    if device is not None and device["launches"]:
        seconds, clock = device["device_ms"] / 1e3, ""
    else:
        seconds, clock = measured["total_s"], "~host"
    padded = measured.get("padded_bytes", 0)
    pad_pct = f"{measured.get('padding_waste_bytes', 0) / padded:.0%}" if padded > 0 else "0%"
    bandwidth = roofline = "?"
    if est_bytes > 0 and seconds > 0:
        bandwidth = f"{est_bytes / seconds / 1e9:.1f}GB/s"
        try:
            fraction = _costs.roofline_fraction(est_flops or None, est_bytes, seconds)
            if fraction is not None:
                roofline = f"{fraction:.1%}"
        except Exception:
            pass
    return (
        f" moved={_fmt_bytes(int(est_bytes))} ops={_fmt_count(est_flops)} "
        f"bw{clock}={bandwidth} padding={pad_pct} roofline{clock}={roofline}"
    )


def _actual_suffix(measured: Optional[dict]) -> str:
    """``(actual: ...)`` annotation of one analyzed node."""
    if measured is None:
        return ""
    rows = measured.get("rows")
    return (
        "  (actual: "
        f"time={measured['total_s'] * 1e3:.3f}ms "
        f"self={measured['self_s'] * 1e3:.3f}ms "
        f"rows={'?' if rows is None else rows} "
        f"bytes={_fmt_bytes(measured.get('bytes'))} "
        f"launches={measured['launches']}{_cost_suffix(measured)})"
    )


def _strategy_suffix(st: Any) -> str:
    """The optimizer's annotation of one node: its legs, its modeled wall
    and, once lowered, its measured one."""
    if st is None:
        return ""
    parts = [f"{leg}={choice}" for leg, choice in sorted(st.legs.items())]
    if st.est_s > 0.0:
        cost = f"est={st.est_s * 1e3:.3f}ms"
        if st.measured_s is not None:
            cost += f" meas={st.measured_s * 1e3:.3f}ms"
        parts.append(cost)
    return "  [strategy: " + " ".join(parts) + "]" if parts else ""


def render(root: PlanNode, actuals: Optional[dict] = None, strategies: Any = None) -> str:
    """ASCII tree of a plan; a shared (diamond) node renders once and is
    referenced as ``^N`` afterwards.  ``strategies`` (the optimizer's)
    annotates each node's legs and costs."""
    lines: List[str] = []
    ids: dict = {}
    by_node = strategies.by_node if strategies is not None else {}

    def visit(node: PlanNode, depth: int) -> None:
        indent = "  " * depth
        seen = ids.get(id(node))
        if seen is not None:
            lines.append(f"{indent}^{seen} (shared {node.kind})")
            return
        ids[id(node)] = len(ids) + 1
        suffix = _actual_suffix(actuals.get(id(node))) if actuals else ""
        suffix += _strategy_suffix(by_node.get(id(node)))
        lines.append(f"{indent}#{ids[id(node)]} {node.label()}{suffix}")
        for child in node.children:
            visit(child, depth + 1)

    visit(root, 0)
    return "\n".join(lines)


def render_attribution(applied: List[Tuple[str, int]]) -> str:
    if not applied:
        return "rewrites: none (plan already optimal)"
    by_rule: dict = {}
    for name, pass_index in applied:
        by_rule.setdefault(name, []).append(pass_index)
    lines = ["rewrites:"]
    for name, passes in by_rule.items():
        shown = ", ".join(str(p) for p in passes)
        lines.append(f"  - {name}: {len(passes)} application(s) (pass {shown})")
    return "\n".join(lines)


def render_replans(strategies: Any) -> str:
    """The optimizer's re-plans of one materialization, each with its
    trigger and the evidence that fired it."""
    if strategies is None or not strategies.replans:
        return "re-plans: none"
    lines = [f"re-plans: {len(strategies.replans)} (correction x{strategies.correction:.2f})"]
    for event in strategies.replans:
        detail = " ".join(f"{k}={v}" for k, v in event.items() if k != "trigger")
        lines.append(f"  - {event['trigger']}: {detail}")
    return "\n".join(lines)


def explain_plan(root: PlanNode, optimized: Optional[PlanNode] = None,
                 applied: Optional[List[Tuple[str, int]]] = None, actuals: Optional[dict] = None,
                 strategies: Any = None) -> str:
    if optimized is None:
        optimized, applied = optimize(root)
    after = "with actuals" if actuals else None
    parts = [
        "== logical plan (before rewrite) ==",
        render(root),
        "",
        f"== logical plan (after rewrite{', ' + after if after else ''}) ==",
        render(optimized, actuals, strategies),
        "",
        render_attribution(applied or []),
    ]
    if strategies is not None:
        parts += ["", render_replans(strategies)]
    return "\n".join(parts)


def explain_qc(qc: Any, analyze: bool = False) -> str:
    """EXPLAIN of a query compiler: its pending plan, its last materialized
    plan, or a note that it is eager; ``analyze`` executes the plan (a
    pending one materializes into ``qc``) and annotates the nodes."""
    if analyze:
        from modin_tpu_torch.plan import runtime

        analyzed = runtime.explain_analyze(qc)
        if analyzed is None:
            return _EAGER.replace("no deferred plan", "nothing to analyze")
        actuals, (root, optimized, applied) = analyzed
        return "status: analyzed (plan executed with per-node measurement)\n" + explain_plan(
            root, optimized, applied, actuals, getattr(qc, "_plan_strategies", None)
        )
    plan = getattr(qc, "_plan", None)
    if plan is not None:
        return "status: deferred (not yet materialized)\n" + explain_plan(plan)
    history = getattr(qc, "_plan_explain", None)
    if history is not None:
        root, optimized, applied = history
        return "status: materialized\n" + explain_plan(
            root, optimized, applied, strategies=getattr(qc, "_plan_strategies", None)
        )
    return _EAGER
