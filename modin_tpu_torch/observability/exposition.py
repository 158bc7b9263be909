"""Exposition: render a meter snapshot for the outside world.

The port's counterpart of ``modin_tpu/observability/exposition.py``, over the
same :func:`modin_tpu_torch.observability.meters.snapshot` dict:

- :func:`to_prometheus`: the Prometheus text exposition format (one
  ``# HELP``/``# TYPE`` block per series; histograms expand to
  ``_bucket{le=...}``/``_sum``/``_count`` lines).  Metric names are the
  emitted dotted names with non-alphanumerics folded to ``_`` and a
  ``modin_tpu_torch_`` prefix.
- :func:`to_json`: the snapshot as canonical JSON (stable key order).

:func:`parse_prometheus` is a minimal validating parser: every non-comment
line must be ``name{labels} value`` with a float value, every TYPE a known
meter kind, and histogram buckets cumulative.  :func:`meter_rollup`
compresses a snapshot into a small headline dict.
"""

from __future__ import annotations

import fnmatch
import json
import re
from typing import Any, Dict, List, Optional

_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_]")
_SAMPLE_LINE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^}]*\})?"
    r" (?P<value>[0-9eE+.\-]+|NaN|\+Inf|-Inf)$"
)

PROMETHEUS_KINDS = {"counter", "gauge", "histogram"}

#: the prefix of every exposed name
PREFIX = "modin_tpu_torch_"


def prometheus_name(metric_name: str) -> str:
    """``resilience.engine.deploy.oom`` -> ``modin_tpu_torch_resilience_engine_deploy_oom``."""
    return PREFIX + _NAME_SANITIZE.sub("_", metric_name)


def _fmt(value: Any) -> str:
    if value is None:
        return "NaN"
    if isinstance(value, int) or (isinstance(value, float) and value.is_integer()):
        return str(int(value))
    return repr(float(value))


#: name -> rendered HELP text; bounded because exposition accepts
#: arbitrary snapshots (the live registry itself is cardinality-capped)
_HELP_CACHE: Dict[str, str] = {}
_HELP_CACHE_MAX = 4096


def help_text(metric_name: str) -> str:
    """The ``# HELP`` line body for a metric: the family's description
    from the ``METRICS`` registry (the 3-tuples already carry one),
    whitespace-normalized and escaped per the Prometheus text format
    (``\\`` -> ``\\\\``, newline -> ``\\n``).  Ad-hoc names not matching
    any registry pattern keep the generic fallback text."""
    cached = _HELP_CACHE.get(metric_name)
    if cached is not None:
        return cached
    text = f"modin_tpu_torch metric {metric_name}"
    try:
        from modin_tpu_torch.logging.metrics import METRICS

        for entry in METRICS:
            if fnmatch.fnmatchcase(metric_name, entry[0]) and len(entry) > 2:
                text = " ".join(str(entry[2]).split())
                break
    except ImportError:  # teardown: keep the fallback
        pass
    text = text.replace("\\", "\\\\").replace("\n", "\\n")
    if len(_HELP_CACHE) < _HELP_CACHE_MAX:
        _HELP_CACHE[metric_name] = text
    return text


def to_prometheus(snapshot: dict) -> str:
    """Render a meter snapshot as Prometheus text exposition format."""
    lines: List[str] = []
    for name, series in snapshot.get("series", {}).items():
        kind = series.get("kind", "counter")
        promname = prometheus_name(name)
        lines.append(f"# HELP {promname} {help_text(name)}")
        if kind == "histogram":
            lines.append(f"# TYPE {promname} histogram")
            for bound, cum_count in series.get("buckets", []):
                lines.append(
                    f'{promname}_bucket{{le="{_fmt(float(bound))}"}} {cum_count}'
                )
            lines.append(f'{promname}_bucket{{le="+Inf"}} {series["count"]}')
            lines.append(f"{promname}_sum {_fmt(series['sum'])}")
            lines.append(f"{promname}_count {series['count']}")
        elif kind == "gauge":
            lines.append(f"# TYPE {promname} gauge")
            lines.append(f"{promname} {_fmt(series.get('value'))}")
        else:
            lines.append(f"# TYPE {promname} counter")
            lines.append(f"{promname} {_fmt(series.get('total', 0))}")
    lines.append("")
    return "\n".join(lines)


def to_json(snapshot: dict, indent: Optional[int] = None) -> str:
    """Render a meter snapshot as canonical JSON."""
    return json.dumps(snapshot, sort_keys=True, indent=indent)


def parse_prometheus(text: str) -> Dict[str, dict]:
    """Validate + parse Prometheus text format back into
    ``{name: {"type": kind, "samples": {sample_line_name+labels: value}}}``.

    Raises ``ValueError`` on any malformed line, unknown TYPE, or a
    non-monotonic histogram bucket sequence.
    """
    out: Dict[str, dict] = {}
    current_type: Dict[str, str] = {}
    last_bucket: Dict[str, float] = {}
    help_texts: Dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.rstrip()
        if not line:
            continue
        if line.startswith("# HELP "):
            parts = line.split(" ", 3)
            if len(parts) < 3 or not parts[2]:
                raise ValueError(f"malformed HELP line: {line!r}")
            help_texts[parts[2]] = parts[3] if len(parts) > 3 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4:
                raise ValueError(f"malformed TYPE line: {line!r}")
            _, _, name, kind = parts
            if kind not in PROMETHEUS_KINDS:
                raise ValueError(f"unknown TYPE {kind!r} for {name}: {line!r}")
            current_type[name] = kind
            out[name] = {
                "type": kind,
                "samples": {},
                "help": help_texts.get(name),
            }
            continue
        if line.startswith("#"):
            raise ValueError(f"unknown comment directive: {line!r}")
        m = _SAMPLE_LINE.match(line)
        if m is None:
            raise ValueError(f"malformed sample line: {line!r}")
        sample_name = m.group("name")
        base = sample_name
        for suffix in ("_bucket", "_sum", "_count"):
            if base.endswith(suffix) and base[: -len(suffix)] in current_type:
                base = base[: -len(suffix)]
                break
        if base not in current_type:
            raise ValueError(f"sample before TYPE declaration: {line!r}")
        value = float(m.group("value").replace("+Inf", "inf").replace("-Inf", "-inf"))
        if sample_name.endswith("_bucket"):
            prev = last_bucket.get(base, float("-inf"))
            if value < prev:
                raise ValueError(
                    f"non-cumulative histogram buckets for {base}: "
                    f"{value} after {prev}"
                )
            last_bucket[base] = value
        out[base]["samples"][sample_name + (m.group("labels") or "")] = value
    return out


def meter_rollup(snapshot: Optional[dict] = None) -> dict:
    """Headline counters from a snapshot.

    ``{dispatches, compiles, compile_s, bytes_parsed, io_reads, spills,
    cache_hits: {fused, sorted_rep, plan_scan}, api_calls}`` — everything
    defaults to 0, so the dict has the same keys whatever the snapshot
    touched.

    ``bytes_parsed`` sums ``io.read.bytes``, which bills the SOURCE file
    size per physical read (best-effort, FileDispatcher): it measures how
    much data the query went to disk for, and does not shrink when
    projection pushdown parses a column subset of the same file — that
    benefit shows up in ``plan.scan.pruned_columns``, not here.
    """
    if snapshot is None:
        from modin_tpu_torch.observability import meters

        snapshot = meters.snapshot()
    series = snapshot.get("series", {})

    def total(name: str) -> Any:
        return series.get(name, {}).get("total", 0)

    def hist(name: str, field: str) -> Any:
        return series.get(name, {}).get(field, 0) or 0

    api_calls = sum(
        s.get("count", 0)
        for name, s in series.items()
        if name.startswith("pandas-api.")
    )
    return {
        "dispatches": total("engine.dispatch"),
        "compiles": total("engine.compile"),
        "compile_s": round(float(total("engine.compile_s")), 4),
        "bytes_parsed": int(hist("io.read.bytes", "sum")),
        "io_reads": hist("io.read.bytes", "count"),
        "spills": total("memory.device.spill"),
        "cache_hits": {
            "fused": total("fusion.cache.hit"),
            "sorted_rep": total("sortcache.hit"),
            "plan_scan": total("plan.scan.cache_hit"),
        },
        "api_calls": api_calls,
        # estimated work + padding waste (0 when cost capture was off or
        # nothing launched)
        "cost": {
            "est_flops": float(total("engine.cost.flops")),
            "est_bytes": float(total("engine.cost.bytes")),
            "padded_bytes": int(total("engine.cost.padded_bytes")),
            "padding_waste_bytes": int(
                total("engine.cost.padding_waste_bytes")
            ),
        },
    }
