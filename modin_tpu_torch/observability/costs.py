"""Costs: roofline efficiency and padding waste of the kernel launches.

The port's counterpart of ``modin_tpu/observability/costs.py``.  Spans say
where the time went and meters what a query consumed; this module says how
well the card was used.  Three legs, on the seams the earlier layers cut:

1. **Launch costs.**  No ``cost_analysis()`` exists for a hand kernel: each
   wrapper counts a launch's bytes and operations from its own shapes, as
   ``PERF.md`` counts its bound column (every input read once, every output
   written once, bytes a row times rows; one operation a row per combine or
   instruction) and reports them through the launch ledger
   (``compile_ledger.note_launch``).  They feed ``engine.cost.bytes``/
   ``flops``, the per-thread counters EXPLAIN ANALYZE bills, and, when the
   launch's CUDA events resolve, the ledger below.

2. **Achieved efficiency.**  Bytes and operations join the launches' event
   time (device clock) into achieved bandwidth, operation rate and a
   roofline fraction against :func:`substrate_peaks`: the peaks that
   :func:`measure_substrate_peaks` measured on the card when called (a
   device-to-device copy of 1 GiB, and a float64 FMA loop,
   ``ops/cuda/csrc/peaks.cu``) and cached per card name under
   ``CacheDir``; nothing else seeds it, and without them a fraction reads
   unknown.  An entry timed on the host clock
   (an engine attempt's enqueue) keeps the JAX package's ``async_caveat``.

3. **Padding waste.**  The pow2 group table of the masked fused groupby
   (``plan/fuse.py``) calls :func:`note_padding`: physical against logical
   bytes, to ``engine.cost.padded_bytes``/``padding_waste_bytes``, the
   per-thread counters, the per-site ledger and the Chrome counter track.

4. **Collective bytes.**  The range shuffle's block exchange
   (``parallel/shuffle.py``) calls :func:`note_collective`: the bytes of
   every routed column's blocks, to ``engine.cost.collective_bytes``, the
   per-thread counter and the per-site ledger.

Disabled contract: ``COST_ON`` is False unless ``MODIN_TPU_TORCH_COST_CAPTURE``
is On or, under Auto (the default), meter accounting is on; every site reads
that one attribute first.  The JAX package's ``Full`` (a second compile for
``memory_analysis()``) has no counterpart: a hand kernel has no executable
to analyse.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any, Dict, Optional, Tuple

from modin_tpu_torch.concurrency import named_lock
from modin_tpu_torch.logging.metrics import emit_metric
from modin_tpu_torch.observability import spans as _spans

#: the sites' fast path: cost capture and padding accounting are on
COST_ON: bool = False

UNKNOWN = "unknown"

_mode = "Auto"

_tls = threading.local()

_pad_lock = named_lock("costs.padding")
_total_padded_bytes = 0
_total_waste_bytes = 0
_last_achieved_bw = 0.0


# ---------------------------------------------------------------------- #
# enable/disable plumbing
# ---------------------------------------------------------------------- #


def _refresh() -> None:
    """Recompute the fast-path flags from the setting and the meters."""
    global COST_ON
    if _mode == "Off":
        COST_ON = False
    elif _mode == "On":
        COST_ON = True
    else:  # Auto: while meter accounting is on
        from modin_tpu_torch.observability import meters as _meters

        COST_ON = _meters.ACCOUNTING_ON
    refresh = getattr(sys.modules.get("modin_tpu_torch.observability.compile_ledger"), "refresh", None)
    if refresh is not None:  # None while it is still being imported
        refresh()


def _on_cost_param(param: Any) -> None:
    global _mode
    _mode = str(param.get())
    _refresh()


def cost_capture_mode() -> str:
    return _mode


def _merge_known(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    """Overlay only the known fields of ``src``."""
    for key, value in src.items():
        if value != UNKNOWN:
            dst[key] = value
        else:
            dst.setdefault(key, UNKNOWN)


# ---------------------------------------------------------------------- #
# the cost ledger
# ---------------------------------------------------------------------- #


class CostLedger:
    """Thread-safe per-signature and per-kernel costs joined with time."""

    def __init__(self) -> None:
        self._lock = named_lock("costs.ledger")
        self._entries: Dict[str, dict] = {}
        self._kernels: Dict[str, dict] = {}
        self._padding: Dict[str, dict] = {}
        self._collective: Dict[str, dict] = {}

    @staticmethod
    def _blank(clock: str) -> dict:
        return {"dispatches": 0, "wall_s": 0.0, "flops_total": 0.0, "bytes_total": 0.0, "clock": clock}

    def record_dispatch(
        self,
        signature: str,
        wall_s: float,
        flops: Any = UNKNOWN,
        bytes_accessed: Any = UNKNOWN,
        kernel: Optional[str] = None,
        clock: str = "events",
    ) -> None:
        with self._lock:
            targets = [self._entries.setdefault(signature, self._blank(clock))]
            if kernel is not None:
                targets.append(self._kernels.setdefault(kernel, self._blank(clock)))
            for entry in targets:
                entry["dispatches"] += 1
                entry["wall_s"] += wall_s
                if flops != UNKNOWN and flops is not None:
                    entry["flops_total"] += flops
                if bytes_accessed != UNKNOWN and bytes_accessed is not None:
                    entry["bytes_total"] += bytes_accessed
                if entry["clock"] != clock:
                    entry["clock"] = "mixed"

    def record_padding(self, site: str, padded_bytes: int, valid_bytes: int) -> None:
        with self._lock:
            entry = self._padding.setdefault(site, {"events": 0, "padded_bytes": 0, "waste_bytes": 0})
            entry["events"] += 1
            entry["padded_bytes"] += padded_bytes
            entry["waste_bytes"] += max(padded_bytes - valid_bytes, 0)

    def record_collective(self, site: str, nbytes: int) -> None:
        with self._lock:
            entry = self._collective.setdefault(site, {"events": 0, "bytes": 0})
            entry["events"] += 1
            entry["bytes"] += nbytes

    @staticmethod
    def _efficiency(entry: Optional[dict]) -> Optional[dict]:
        if entry is None or entry["dispatches"] == 0:
            return None
        wall, flops_total, bytes_total = entry["wall_s"], entry["flops_total"], entry["bytes_total"]
        return {
            **entry,
            "achieved_flops_per_s": flops_total / wall if flops_total > 0 and wall > 0 else UNKNOWN,
            "achieved_bytes_per_s": bytes_total / wall if bytes_total > 0 and wall > 0 else UNKNOWN,
            "roofline_fraction": roofline_fraction(flops_total or None, bytes_total or None, wall) or UNKNOWN,
            # a host-clock wall is an enqueue on an asynchronous card
            "async_caveat": entry["clock"] != "events",
        }

    def efficiency(self, signature: str) -> Optional[dict]:
        """Achieved operation rate, bandwidth and roofline fraction of one
        signature (None if it never launched)."""
        with self._lock:
            entry = self._entries.get(signature)
            entry = dict(entry) if entry is not None else None
        return self._efficiency(entry)

    def kernel_efficiency(self, kernel: str) -> Optional[dict]:
        """The same for one kernel over every signature."""
        with self._lock:
            entry = self._kernels.get(kernel)
            entry = dict(entry) if entry is not None else None
        return self._efficiency(entry)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "signatures": {s: dict(e) for s, e in self._entries.items()},
                "kernels": {k: dict(e) for k, e in self._kernels.items()},
                "padding": {s: dict(e) for s, e in self._padding.items()},
                "collective": {s: dict(e) for s, e in self._collective.items()},
            }

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()
            self._kernels.clear()
            self._padding.clear()
            self._collective.clear()


_LEDGER = CostLedger()


def get_cost_ledger() -> CostLedger:
    return _LEDGER


def reset() -> None:
    """Clear the cost ledger and the process padding accumulators."""
    global _total_padded_bytes, _total_waste_bytes, _last_achieved_bw
    _LEDGER.reset()
    with _pad_lock:
        _total_padded_bytes = 0
        _total_waste_bytes = 0
        _last_achieved_bw = 0.0


# ---------------------------------------------------------------------- #
# per-thread counters (EXPLAIN ANALYZE takes deltas)
# ---------------------------------------------------------------------- #


def thread_cost() -> Tuple[float, float]:
    """Monotonic per-thread (operations, bytes) of the launches."""
    return (getattr(_tls, "flops", 0.0), getattr(_tls, "bytes", 0.0))


def thread_padding() -> Tuple[int, int]:
    """Monotonic per-thread (padded bytes, padding-waste bytes)."""
    return (getattr(_tls, "padded", 0), getattr(_tls, "waste", 0))


def thread_collective() -> int:
    """Monotonic per-thread bytes of the shuffle's block exchanges."""
    return getattr(_tls, "collective", 0)


# ---------------------------------------------------------------------- #
# the launch hooks (called by the launch ledger)
# ---------------------------------------------------------------------- #


def note_launch_cost(nbytes: float, flops: float) -> None:
    """One launch's bytes and operations, from its wrapper's shapes."""
    try:
        _tls.flops = getattr(_tls, "flops", 0.0) + flops
        _tls.bytes = getattr(_tls, "bytes", 0.0) + nbytes
        if flops:
            emit_metric("engine.cost.flops", flops)
        emit_metric("engine.cost.bytes", nbytes)
    except Exception:
        pass


def record_launch_time(kernel: str, signature: str, seconds: float, flops: float, nbytes: float) -> None:
    """One launch's event-timed seconds, joined with its costs."""
    global _last_achieved_bw
    try:
        _LEDGER.record_dispatch(signature, seconds, flops, nbytes, kernel=kernel, clock="events")
        if seconds > 0:
            _last_achieved_bw = nbytes / seconds
    except Exception:
        pass


# ---------------------------------------------------------------------- #
# padding-waste accounting
# ---------------------------------------------------------------------- #


def note_padding(site: str, padded_bytes: int, valid_bytes: int) -> None:
    """One padded device allocation: ``padded_bytes`` physical against
    ``valid_bytes`` logical.  Sites check :data:`COST_ON` first.  Zero
    waste is recorded too."""
    global _total_padded_bytes, _total_waste_bytes
    try:
        padded_bytes = int(padded_bytes)
        waste = max(padded_bytes - int(valid_bytes), 0)
        _tls.padded = getattr(_tls, "padded", 0) + padded_bytes
        _tls.waste = getattr(_tls, "waste", 0) + waste
        with _pad_lock:
            _total_padded_bytes += padded_bytes
            _total_waste_bytes += waste
        _LEDGER.record_padding(site, padded_bytes, int(valid_bytes))
        emit_metric("engine.cost.padded_bytes", padded_bytes)
        emit_metric("engine.cost.padding_waste_bytes", waste)
        if _spans.TRACE_ON:
            sp = _spans.current_span()
            if sp is not None:
                sp.attrs["padding_waste_bytes"] = sp.attrs.get("padding_waste_bytes", 0) + waste
    except Exception:
        pass


def note_collective(site: str, nbytes: int) -> None:
    """One exchange between the row shards: ``nbytes`` of blocks moved at
    ``site`` (``shuffle.all_to_all``).  Sites check :data:`COST_ON` first.
    Feeds ``engine.cost.collective_bytes`` (``QueryStats.collective_bytes``),
    the per-thread counter EXPLAIN ANALYZE bills and the per-site ledger."""
    try:
        nbytes = int(nbytes)
        _tls.collective = getattr(_tls, "collective", 0) + nbytes
        _LEDGER.record_collective(site, nbytes)
        emit_metric("engine.cost.collective_bytes", nbytes)
        if _spans.TRACE_ON:
            sp = _spans.current_span()
            if sp is not None:
                sp.attrs["collective_bytes"] = sp.attrs.get("collective_bytes", 0) + nbytes
    except Exception:
        pass


def counter_sample() -> tuple:
    """(padding-waste bytes, last achieved bandwidth bytes/s): the cost
    layer's Chrome-trace counter tracks, sampled at span finish."""
    return (_total_waste_bytes, int(_last_achieved_bw))


# ---------------------------------------------------------------------- #
# roofline peaks
# ---------------------------------------------------------------------- #

#: published figures (float64 vector FLOP/s, HBM bytes/s; NVIDIA's H100
#: SXM data sheet) of the card the port runs on: shown beside the measured
#: peaks, labelled published, and never used as the roofline
PUBLISHED_PEAKS: Dict[str, Tuple[float, float]] = {
    "H100 80GB HBM3": (34e12, 3.35e12),
}

#: the card's measurement: copy size and FMA loop shape
PEAK_COPY_BYTES = 1 << 30
PEAK_FMA_ITERS = 1 << 16
PEAK_FMA_THREADS = 256

_peaks_cache: Optional[dict] = None
_peaks_lock = named_lock("costs.peaks")


def published_peaks(device_name: str) -> Optional[dict]:
    """The published figures of ``device_name``, or None."""
    for known, (flops, bw) in PUBLISHED_PEAKS.items():
        if known.lower() in device_name.lower():
            return {"flops_per_s": flops, "bytes_per_s": bw, "source": f"published:{known}"}
    return None


def _best_of(fn: Any, sync: Any, reps: int = 3) -> float:
    fn()
    sync()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def measure_card_peaks(device: Any = None) -> dict:
    """Measure this card once: the bandwidth of a device-to-device copy of
    :data:`PEAK_COPY_BYTES` (read and write counted) and the float64 rate
    of an FMA loop (two operations an FMA), each best of 3 by CUDA events."""
    import torch

    from modin_tpu_torch.ops.cuda import peaks_kernels

    device = torch.device("cuda", torch.cuda.current_device()) if device is None else torch.device(device)

    def timed(fn: Any) -> float:
        fn()
        torch.cuda.synchronize(device)
        best = float("inf")
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(device))
            fn()
            end.record(torch.cuda.current_stream(device))
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        return best

    src = torch.empty(PEAK_COPY_BYTES, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    copy_s = timed(lambda: dst.copy_(src))
    del src, dst
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = sms * 8
    out = torch.empty(blocks * PEAK_FMA_THREADS, dtype=torch.float64, device=device)
    fma_s = timed(lambda: peaks_kernels.fma_loop(out, PEAK_FMA_ITERS, PEAK_FMA_THREADS))
    flops = float(blocks * PEAK_FMA_THREADS) * PEAK_FMA_ITERS * peaks_kernels.CHAINS * 2
    return {
        "flops_per_s": flops / fma_s,
        "bytes_per_s": 2.0 * PEAK_COPY_BYTES / copy_s,
        "copy_bytes": PEAK_COPY_BYTES,
        "copy_s": copy_s,
        "fma_flops": flops,
        "fma_s": fma_s,
        "source": "measured",
    }


def _measure_host_peaks() -> dict:
    """This host's dense-product rate and copy bandwidth via numpy (the
    port on the CPU)."""
    import numpy as np

    k = 512
    a = np.random.default_rng(0).random((k, k))
    b = np.random.default_rng(1).random((k, k))
    flops = 2.0 * k**3 / max(_best_of(lambda: a @ b, lambda: None), 1e-9)
    src = np.zeros(8 << 20, dtype=np.int8)
    dst = np.empty_like(src)
    bw = 2.0 * src.nbytes / max(_best_of(lambda: np.copyto(dst, src), lambda: None), 1e-9)
    return {"flops_per_s": flops, "bytes_per_s": bw, "source": "measured"}


def _device_identity() -> Tuple[str, str]:
    """(platform, device name) of the port's device."""
    from modin_tpu_torch import get_device

    device = get_device()
    if device.type == "cuda":
        import torch

        return "cuda", torch.cuda.get_device_name(device)
    import platform

    return "cpu", platform.processor() or platform.machine()


def substrate_peaks() -> Optional[dict]:
    """Peak operation rate and memory bandwidth of the port's device, or
    None (no basis for a roofline: fractions read unknown).  Never measures:
    the peaks come from :func:`measure_substrate_peaks` in this process or
    from the table an earlier measurement cached per card name under
    ``CacheDir``; a card also carries its published figures under
    ``published``."""
    global _peaks_cache
    if _peaks_cache is not None:
        return _peaks_cache or None
    with _peaks_lock:
        if _peaks_cache is not None:
            return _peaks_cache or None
        peaks: Optional[dict] = None
        try:
            platform_, name = _device_identity()
            peaks = _load_cached_peaks(platform_, name)
            if peaks is not None and platform_ == "cuda":
                peaks = {**peaks, "published": published_peaks(name)}
        except Exception:  # the table's read degrades to unknown, counted
            emit_metric("engine.cost.peaks_unreadable", 1)
            peaks = None
        _peaks_cache = peaks if peaks is not None else {}
        return peaks


def measure_substrate_peaks() -> dict:
    """Measure the port's device now (:func:`measure_card_peaks` on a card,
    numpy's rates on the CPU), cache the result per card name under
    ``CacheDir`` and make it this process's peaks.  Only an explicit call
    measures: on a card it allocates 2 GiB outside the memory ledger and
    may build ``peaks.cu``, so a failure raises to the caller."""
    global _peaks_cache
    platform_, name = _device_identity()
    peaks = measure_card_peaks() if platform_ == "cuda" else _measure_host_peaks()
    peaks = {**peaks, "platform": platform_, "device": name}
    _store_cached_peaks(platform_, name, peaks)
    if platform_ == "cuda":
        peaks = {**peaks, "published": published_peaks(name)}
    with _peaks_lock:
        _peaks_cache = peaks
    return peaks


def _peaks_path(platform_: str, name: str) -> Optional[str]:
    from modin_tpu_torch.ops import calibration as calstore

    return calstore.table_path("roofline", platform_, device_key=name)


def _load_cached_peaks(platform_: str, name: str) -> Optional[dict]:
    from modin_tpu_torch.ops import calibration as calstore

    peaks = calstore.load_table(_peaks_path(platform_, name), platform=platform_, device_key=name)
    if isinstance(peaks, dict) and peaks.get("flops_per_s", 0) > 0 and peaks.get("bytes_per_s", 0) > 0:
        return {**peaks, "source": "measured (cached)"}
    return None


def _store_cached_peaks(platform_: str, name: str, peaks: dict) -> None:
    from modin_tpu_torch.ops import calibration as calstore

    calstore.store_table(_peaks_path(platform_, name), peaks)


def set_substrate_peaks(peaks: Optional[dict]) -> None:
    """Replace the process's peaks (None: measure again on next use)."""
    global _peaks_cache
    with _peaks_lock:
        _peaks_cache = peaks


def roofline_fraction(flops: Optional[float], bytes_accessed: Optional[float], wall_s: float) -> Optional[float]:
    """Achieved fraction of the roofline-attainable rate: achieved
    operations over ``min(peak_flops, intensity * peak_bw)``; for a program
    of pure movement, achieved over peak bandwidth.  None when the wall or
    the estimates are unknown."""
    if wall_s <= 0:
        return None
    peaks = substrate_peaks()
    if peaks is None:
        return None
    peak_flops = peaks["flops_per_s"]
    peak_bw = peaks["bytes_per_s"]
    if flops is not None and flops > 0:
        if bytes_accessed is not None and bytes_accessed > 0:
            attainable = min(peak_flops, flops / bytes_accessed * peak_bw)
        else:
            attainable = peak_flops
        return (flops / wall_s) / attainable
    if bytes_accessed is not None and bytes_accessed > 0:
        return (bytes_accessed / wall_s) / peak_bw
    return None


# wire the setting (fires at once with its current value)
from modin_tpu_torch.config import CostCapture as _CostCapture  # noqa: E402

_CostCapture.subscribe(_on_cost_param)
