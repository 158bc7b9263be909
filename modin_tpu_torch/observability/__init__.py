"""Observability of the port: spans, the launch ledger, meters, costs, the
flight recorder and the live telemetry service (``watch/``).

The port's counterpart of ``modin_tpu/observability/``, with its public
names.  Where a query spends its time, across the seams of the port:

1. **pandas API entry**: every ``ClassLogger``-wrapped call emits a span
   tagged with its layer (``PANDAS-API``, ``QUERY-COMPILER``,
   ``CORE-FRAME``, ``CORE-IO``, ``TORCH-ENGINE``);
2. **the engine seam**: one span per resilience attempt
   (``engine.<op>.attempt``), fallbacks and raises as ``fallback.<family>``/
   ``raised.<family>`` spans;
3. **the kernels**: each launch of the four hand kernels is counted per
   kernel and signature, with its bytes and operations, and (while
   tracing) timed by CUDA events (``compile_ledger``);
4. **the seams between**: spills, re-seats, router decisions, plan passes,
   fused legs, view folds and file reads.

Quick use::

    import modin_tpu_torch.observability as obs

    with obs.profile() as prof:
        df.groupby("k").sum()._to_pandas()
    print(prof.rollup())                       # host / device / build split
    print(obs.get_compile_ledger().launch_snapshot())  # launches per kernel
    prof.export_chrome_trace("query.trace.json")       # chrome://tracing

Always on: ``MODIN_TPU_TORCH_TRACE=1`` (spans, the flight recorder's ring),
``MODIN_TPU_TORCH_METERS=1`` (the meter registry),
``MODIN_TPU_TORCH_COST_CAPTURE=On``, and ``MODIN_TPU_TORCH_WATCH=1`` (the
sampler, the exporter on 127.0.0.1, SLO burn and tripwires).  All off (the default), an
instrumented call reads one module attribute and makes nothing.
"""

from modin_tpu_torch.observability.chrome_trace import (  # noqa: F401
    export_chrome_trace,
    to_chrome_trace,
)
from modin_tpu_torch.observability.compile_ledger import (  # noqa: F401
    CompileLedger,
    get_compile_ledger,
    resolve_events,
)
from modin_tpu_torch.observability.flight_recorder import (  # noqa: F401
    dump_flight_record,
    flight_snapshot,
)
from modin_tpu_torch.observability.spans import (  # noqa: F401
    SPANS,
    Profile,
    Span,
    counter_samples,
    current_span,
    finish_span,
    layer_span,
    profile,
    span,
    span_alloc_count,
    start_span,
    trace_enabled,
)
from modin_tpu_torch.observability.meters import (  # noqa: F401
    HISTOGRAM_BUCKETS,
    QueryStats,
    meter_alloc_count,
    meters_enabled,
    query_stats,
)
from modin_tpu_torch.observability.meters import (  # noqa: F401
    reset as meters_reset,
    snapshot as meters_snapshot,
)
from modin_tpu_torch.observability.exposition import (  # noqa: F401
    meter_rollup,
    parse_prometheus,
    to_json,
    to_prometheus,
)
from modin_tpu_torch.observability.costs import (  # noqa: F401
    CostLedger,
    get_cost_ledger,
    measure_substrate_peaks,
    note_padding,
    roofline_fraction,
    substrate_peaks,
)
from modin_tpu_torch.observability.watch import (  # noqa: F401
    WatchService,
    httpd_port,
    recent_trips,
    slo_health,
    watch_alloc_count,
    watch_snapshot,
)
