"""The build and launch ledger: the port's compiles and kernel launches.

The port's counterpart of ``modin_tpu/observability/compile_ledger.py``.
There is no ``jax.monitoring`` event here; the port's "compiles" are

- the ``nvcc`` builds of ``ops/cuda/csrc/*.cu`` (``ops/cuda/build.py``), and
- the host lowerings of a fused program on a program-cache miss
  (``ops/lazy.py``, ``ops/cuda/fused_program.py``).

Each is billed to the innermost QUERY-COMPILER span open on the thread
(``spans.attribution_signature()``), as the JAX ledger bills a compile, and
adds ``compile_s`` to the innermost span.  Program-cache lookups are the
dispatches: a hit is a cache hit, and ``recompile_storms`` names the
signatures that miss often.

Launches.  The four kernel wrappers (``ops/cuda/groupby_kernels.bincount``,
``scan_kernels.scan``, ``fused_kernels.run_program``,
``groupagg_kernels.groupagg``) report each launch here after it is enqueued
(:func:`note_launch`): per kernel and signature, the launches, the rows
read, and the bytes and operations counted from the wrapper's shapes.
While tracing is on, a pair of ``torch.cuda.Event(enable_timing=True)``
brackets each launch and each engine-seam attempt, and, inside a
``profile()``, each root span; the events are resolved by
:func:`resolve_events`, with one synchronize, when a ``profile()`` exits or
a record is read, never once a span (past :data:`PENDING_MAX` pairs the
next pair resolves the batch, so an always-on trace holds a bounded number
of events).  Resolved events go back to a pool: a CUDA event is made once,
not once a launch.  A hook runs after its launch returned: it never sees,
let alone catches, the launch's exception; only its own bookkeeping may
degrade.

The ledger is on while tracing, meter accounting or cost capture is
(:data:`LEDGER_ON`); with all three off (the default) a wrapper reads that
one attribute and the ledger's counts stay 0.
"""

from __future__ import annotations

import sys
import threading
from typing import Any, Dict, List, Optional

import torch

from modin_tpu_torch.concurrency import named_lock
from modin_tpu_torch.logging.metrics import emit_metric
from modin_tpu_torch.observability import spans as _spans

#: the ledger records (tracing, meter accounting or cost capture is on)
LEDGER_ON: bool = False
#: launches are bracketed by CUDA events (tracing is on)
EVENTS_ON: bool = False

#: the four hand kernels, in the order the tables list them
KERNELS = ("bincount", "scan", "fused", "groupagg")


class CompileLedger:
    """Per-signature builds, lowerings and program-cache dispatches, and
    per-kernel, per-signature launches."""

    def __init__(self) -> None:
        self._lock = named_lock("compile_ledger.entries")
        self._entries: Dict[str, dict] = {}
        self._launches: Dict[str, Dict[str, dict]] = {}
        self.total_compiles = 0
        self.total_compile_s = 0.0

    def _entry(self, signature: str) -> dict:
        entry = self._entries.get(signature)
        if entry is None:
            entry = self._entries[signature] = {
                "compiles": 0,
                "compile_s": 0.0,
                "dispatches": 0,
                "cache_hits": 0,
                "builds": 0,
                "lowerings": 0,
            }
        return entry

    def record_compile(self, signature: str, duration_s: float, kind: str = "lowering") -> None:
        """One build (``kind="build"``) or lowering of ``signature``."""
        with self._lock:
            entry = self._entry(signature)
            entry["compiles"] += 1
            entry["compile_s"] += duration_s
            entry["builds" if kind == "build" else "lowerings"] += 1
            self.total_compiles += 1
            self.total_compile_s += duration_s

    def record_dispatch(self, signature: str, compiled: bool) -> None:
        with self._lock:
            entry = self._entry(signature)
            entry["dispatches"] += 1
            if not compiled:
                entry["cache_hits"] += 1

    def record_launch(self, kernel: str, signature: str, rows: int, nbytes: float, flops: float) -> None:
        with self._lock:
            per_sig = self._launches.setdefault(kernel, {})
            rec = per_sig.get(signature)
            if rec is None:
                rec = per_sig[signature] = {
                    "launches": 0, "rows": 0, "bytes": 0.0, "flops": 0.0, "device_ms": 0.0, "timed": 0,
                }
            rec["launches"] += 1
            rec["rows"] += int(rows)
            rec["bytes"] += nbytes
            rec["flops"] += flops

    def add_device_ms(self, kernel: str, signature: str, ms: float) -> None:
        with self._lock:
            rec = self._launches.get(kernel, {}).get(signature)
            if rec is not None:
                rec["device_ms"] += ms
                rec["timed"] += 1

    def totals(self) -> tuple:
        """``(total_compiles, total_compile_s)``."""
        with self._lock:
            return (self.total_compiles, self.total_compile_s)

    def launch_counts(self) -> Dict[str, int]:
        """``{kernel: launches}`` over every signature."""
        with self._lock:
            return {k: sum(r["launches"] for r in sigs.values()) for k, sigs in self._launches.items()}

    def launch_snapshot(self) -> Dict[str, dict]:
        """Per kernel: launches, rows, bytes, operations, event-timed device
        ms and the launches those ms cover (``timed``), with the split by
        signature.  Resolves pending events first."""
        resolve_events()
        with self._lock:
            out = {}
            for kernel, sigs in self._launches.items():
                total = {"launches": 0, "rows": 0, "bytes": 0.0, "flops": 0.0, "device_ms": 0.0, "timed": 0}
                for rec in sigs.values():
                    for key in total:
                        total[key] += rec[key]
                total["signatures"] = {s: dict(r) for s, r in sigs.items()}
                out[kernel] = total
            return out

    def snapshot(self) -> dict:
        """{signature: {compiles, compile_s, dispatches, cache_hits, builds,
        lowerings}}, the process totals and the launches."""
        launches = self.launch_snapshot()
        with self._lock:
            return {
                "total_compiles": self.total_compiles,
                "total_compile_s": self.total_compile_s,
                "signatures": {sig: dict(e) for sig, e in self._entries.items()},
                "launches": launches,
            }

    def recompile_storms(self, min_compiles: int = 3) -> Dict[str, int]:
        """Signatures compiled at least ``min_compiles`` times: programs
        whose fingerprint keeps changing defeat the program cache."""
        with self._lock:
            return {sig: e["compiles"] for sig, e in self._entries.items() if e["compiles"] >= min_compiles}

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()
            self._launches.clear()
            self.total_compiles = 0
            self.total_compile_s = 0.0
        with _pending_lock:
            _pending.clear()


_LEDGER = CompileLedger()


def get_compile_ledger() -> CompileLedger:
    return _LEDGER


# ---------------------------------------------------------------------- #
# enable/disable plumbing
# ---------------------------------------------------------------------- #


def refresh() -> None:
    """Recompute :data:`LEDGER_ON`/:data:`EVENTS_ON` and the root spans'
    device clock (called by the spans, meters and costs switches)."""
    global LEDGER_ON, EVENTS_ON
    meters = sys.modules.get("modin_tpu_torch.observability.meters")
    costs = sys.modules.get("modin_tpu_torch.observability.costs")
    EVENTS_ON = _spans.TRACE_ON and _cuda_available()
    LEDGER_ON = (
        _spans.TRACE_ON
        or bool(meters is not None and meters.ACCOUNTING_ON)
        or bool(costs is not None and costs.COST_ON)
    )
    # a root span's interval is a profile's figure (its rollup's device_s)
    _spans.set_root_clock((_root_begin, _root_end) if EVENTS_ON and _spans._collectors else None)


_cuda: Optional[bool] = None


def _cuda_available() -> bool:
    global _cuda
    if _cuda is None:
        try:
            _cuda = bool(torch.cuda.is_available())
        except Exception:
            _cuda = False
    return _cuda


# ---------------------------------------------------------------------- #
# device events
# ---------------------------------------------------------------------- #

# (kind, payload..., start event, end event), resolved by resolve_events
_pending: List[tuple] = []
_pending_lock = named_lock("compile_ledger.pending")

#: pairs held before the next one resolves the batch (one synchronize)
PENDING_MAX = 2048
#: resolved events kept for reuse, at most this many
POOL_MAX = 2 * PENDING_MAX
_pool: List[Any] = []


def _event(device: Any = None) -> Any:
    """A timing event recorded now on ``device``'s current stream (the
    current device's when None); from the pool where one is free."""
    try:
        ev = _pool.pop()
    except IndexError:
        ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _hold(item: tuple, resolve: bool = False) -> None:
    """Keep one closed pair until it is resolved; with ``resolve``, past
    :data:`PENDING_MAX` pairs the batch resolves now (a launch's hook does
    that, outside its own bookkeeping: a device error the synchronize
    meets is the device's, and reaches the launch's caller)."""
    with _pending_lock:
        _pending.append(item)
        full = len(_pending) > PENDING_MAX
    if resolve and full:
        resolve_events()


def launch_begin(device: Any = None) -> Any:
    """The start event of a launch or an engine attempt, or None while
    events are off or no CUDA context exists yet (never made here)."""
    if not EVENTS_ON:
        return None
    try:
        if not torch.cuda.is_initialized():
            return None
        return _event(device)
    except Exception:
        return None


def _root_begin() -> Any:
    return launch_begin()


def _root_end(sp: Any) -> None:
    start, sp._dev = sp._dev, None
    try:
        end = _event()
    except Exception:
        return
    _hold(("interval", sp, start, end))


def note_interval(sp: Any, start: Any, attr: str = "engine_device_ms") -> None:
    """Close the event pair of an engine attempt (``start`` from
    :func:`launch_begin`): its device ms land in ``sp.attrs[attr]``."""
    if start is None:
        return
    try:
        end = _event()
    except Exception:
        return
    _hold((attr, sp, start, end))


_tls = threading.local()


def push_device_acc() -> Optional[dict]:
    """While events are on, open an accumulator on this thread: each launch
    enqueued before :func:`pop_device_acc` adds its event ms and one launch
    to it when it resolves (EXPLAIN ANALYZE's nodes).  None while off."""
    if not EVENTS_ON:
        return None
    acc = {"device_ms": 0.0, "launches": 0}
    stack = getattr(_tls, "accs", None)
    if stack is None:
        stack = _tls.accs = []
    stack.append(acc)
    return acc


def pop_device_acc(acc: Optional[dict]) -> None:
    """Close the innermost accumulator, ``acc`` (pushes and pops nest)."""
    if acc is not None:
        popped = _tls.accs.pop()
        assert popped is acc, "device accumulators must nest"


def note_launch(kernel: str, device: Any, start: Any, rows: int, nbytes: float, flops: float) -> None:
    """One launch of ``kernel`` enqueued: count it for the innermost
    signature, bill its bytes and operations, and close its event pair
    (``start`` from :func:`launch_begin`).  Called by the wrapper after
    the launch returned; the wrapper checks :data:`LEDGER_ON` first."""
    signature = sp = None
    try:
        signature = _spans.attribution_signature()
        _LEDGER.record_launch(kernel, signature, rows, nbytes, flops)
        emit_metric(f"kernel.launch.{kernel}", 1)
        emit_metric(f"kernel.rows.{kernel}", int(rows))
        costs = sys.modules.get("modin_tpu_torch.observability.costs")
        if costs is not None and costs.COST_ON:
            costs.note_launch_cost(nbytes, flops)
        sp = _spans.current_span() if _spans.TRACE_ON else None
        if sp is not None:
            rec = sp.attrs.setdefault("launches", {}).setdefault(
                kernel, {"launches": 0, "bytes": 0, "flops": 0, "device_ms": 0.0}
            )
            rec["launches"] += 1
            rec["bytes"] += nbytes
            rec["flops"] += flops
    except Exception:
        sp = signature = None  # the bookkeeping degrades; the launch went out
    if start is not None:
        accs = tuple(getattr(_tls, "accs", None) or ())
        _hold(("launch", kernel, signature or "<unknown>", sp, nbytes, flops, accs, start, _event(device)),
              resolve=True)


def pending_events() -> int:
    with _pending_lock:
        return len(_pending)


def resolve_events() -> int:
    """Resolve every pending event pair with one synchronize; returns how
    many.  A CUDA error the synchronize meets is the device's and
    propagates."""
    with _pending_lock:
        items = list(_pending)
        _pending.clear()
    if not items:
        return 0
    torch.cuda.synchronize()
    costs = sys.modules.get("modin_tpu_torch.observability.costs")
    for item in items:
        start, end = item[-2], item[-1]
        try:
            ms = float(start.elapsed_time(end))
        except Exception:
            continue  # an event that never ran (recorded on another context)
        if len(_pool) < POOL_MAX:
            _pool.extend((start, end))
        if item[0] == "launch":
            _, kernel, signature, sp, nbytes, flops, accs = item[:7]
            _LEDGER.add_device_ms(kernel, signature, ms)
            for acc in accs:
                acc["device_ms"] += ms
                acc["launches"] += 1
            if costs is not None:
                costs.record_launch_time(kernel, signature, ms / 1e3, flops, nbytes)
            if sp is not None:
                sp.attrs["device_ms"] = sp.attrs.get("device_ms", 0.0) + ms
                rec = sp.attrs.get("launches", {}).get(kernel)
                if rec is not None:
                    rec["device_ms"] += ms
        elif item[0] == "interval":
            item[1].attrs["device_interval_ms"] = ms
        else:
            sp = item[1]
            sp.attrs[item[0]] = sp.attrs.get(item[0], 0.0) + ms
    return len(items)


# ---------------------------------------------------------------------- #
# builds, lowerings and the program cache
# ---------------------------------------------------------------------- #


def _bill_compile(duration_s: float, kind: str) -> None:
    _LEDGER.record_compile(_spans.attribution_signature(), duration_s, kind)
    if _spans.TRACE_ON:
        sp = _spans.current_span()
        if sp is not None:
            sp.attrs["compile_s"] = sp.attrs.get("compile_s", 0.0) + duration_s
    meters = sys.modules.get("modin_tpu_torch.observability.meters")
    if meters is not None and meters.ACCOUNTING_ON:
        meters.note_compile(duration_s)


def note_build(names: List[str], duration_s: float) -> None:
    """``nvcc`` built ``names`` in ``duration_s`` wall seconds (in parallel:
    each name is billed its share)."""
    try:
        for name in names:
            _bill_compile(duration_s / max(len(names), 1), "build")
            emit_metric(f"kernel.build.{name}", 1)
    except Exception:
        pass


def note_lowering(duration_s: float) -> None:
    """A fused program lowered on the host (a program-cache miss)."""
    try:
        _bill_compile(duration_s, "lowering")
        _LEDGER.record_dispatch(_spans.attribution_signature(), compiled=True)
    except Exception:
        pass


def note_cache_hit() -> None:
    """A fused program served from the program cache."""
    try:
        _LEDGER.record_dispatch(_spans.attribution_signature(), compiled=False)
    except Exception:
        pass


refresh()
