"""The kernel router: device or pandas for the sort-shaped reductions, and
the fused/staged, layout and residency verdicts.

The port's counterpart of ``modin_tpu/ops/router.py``.  Each sort-shaped
site of the query compiler (median, quantile, nunique, mode, describe's
quantiles) asks :func:`forced_host` before any device work and, once
``ops/reductions.plan_sort_reduce`` has given each column its strategy,
:func:`decide` whether the device plan or pandas is predicted faster at the
observed rows; a ``"host"`` verdict declines to pandas like every other
decline (``DEFAULTS_TO_PANDAS`` counts it).

The model is seeded by a one-shot calibration (:func:`_measure`): on the
device, ``torch.sort`` of an all-distinct int64 column, the sorted-consume
pass of ``nunique`` over it and the ``hist`` strategy's histogram through
the port's bincount kernel (``ops/cuda/groupby_kernels.bincount``), each
timed with the device synchronised inside the timer; on the host, pandas'
median, quantile, nunique and mode in both cardinality regimes.  The host
runs at ``KernelRouterCalibrationRows`` rows.  The device runs there and at
:data:`DEVICE_FIT_FACTOR` times as many rows, and each device entry is a
fixed cost plus a term that grows with the rows (n·log n for the sort,
linear for the rest) fitted through the two: at the calibration size a
launch costs about what its work does, so scaling that one time would
predict large frames many times too slow.  The table is cached under
``CacheDir``, keyed by the platform, the card's name, the torch version
and the mesh, so it is paid once per card and mesh.  Frames under ``KernelRouterMinRows`` never
calibrate.

The layout leg (:func:`decide_layout`) sends the sort, the
sorted-representation build, the merge's right-side sort and a groupby
UDF through the range shuffle over the row-shard mesh (``ops/spmd.py``,
the query compiler) or keeps them local: a single shard is always local,
``SpmdMode`` pins a side (``RangePartitioning`` reads as Sharded for the
sort), and under Auto a frame of ``SpmdMinRows`` rows or more takes the
side the table predicts faster.  On a mesh of two or more shards the
table also holds the shuffle's sharded sort and the block exchange's bytes
a second, measured on that mesh (:func:`_measure_sharded`); the table's
key names the mesh (``parallel/mesh.mesh_shape_key``), so a reshape
measures again.

Every verdict adds one to ``COUNTS["router.<op>.<choice>"]`` (and the fused
gate's to ``router.fuse.<choice>``), plain integers as the port counts its
launches, each also emitted to the metric stream; while tracing, a verdict
of :func:`verdict` and :func:`layout_verdict` is a ``router.decide`` span with its predicted costs.  The plan
optimizer's consult hook (:data:`_opt_consult`) is offered the residency verdict only (``plan/optimizer.py`` says
why): the kernel, compile and layout verdicts are the router's own.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from modin_tpu_torch.logging.metrics import CountView, emit_counted, emit_metric
from modin_tpu_torch.observability import spans as _spans
from modin_tpu_torch.ops import calibration as calstore

#: column strategies a sort-shaped plan may carry (``plan_sort_reduce``):
#: "dict" costs ~0 (the categories are on the host), "cached" consumes an
#: existing sorted representation, "hist" is the O(n) histogram, "sort" pays
#: the O(n log n) device sort, and "view" a cached whole result
#: (``views/``), which costs 0
STRATEGIES = ("dict", "view", "cached", "hist", "sort")

#: predicted device-minus-host savings (seconds) the host side must clear
#: before Auto declines a device path: below it the verdict is noise and
#: device residency wins ties
MIN_SAVINGS_S = 0.05

_CAL_VERSION = 3

#: the device entries are timed at the calibration rows and at this many
#: times as many (2^24 rows at the default 2^18), where the card's sort
#: and histogram are bound by their bytes, not by their launches
DEVICE_FIT_FACTOR = 64

#: the device entries of a table: ``device_<name>_s`` is the part that
#: grows with the rows, at the table's ``rows``, and
#: ``device_<name>_fixed_s`` the fixed part (0 where a table has none)
DEVICE_ENTRIES = ("sort", "consume", "hist")

#: verdicts so far, ``{"router.<op>.<choice>": count}``: a read of the
#: metric layer's tally
COUNTS = CountView(prefixes=("router.",))
#: one-shot measurements run in this process, and the last one's failure
CALIBRATIONS = 0
CALIBRATION_ERROR: Optional[str] = None

_lock = threading.RLock()
#: None = not resolved; False = the calibration failed (route device); a
#: dict = the live table
_calibration: Any = None
_calibration_key: Optional[str] = None
_calibration_forced = False


#: the plan optimizer's consult hook, installed by ``plan/optimizer.py``
#: while ``OptMode`` is Auto: offered a live residency verdict of the
#: reasons below, it may answer the plan's ``(choice, reason)`` instead
#: (the forced modes and the missing budget stay the router's)
_opt_consult: Optional[Callable[..., Optional[Tuple[str, str]]]] = None
_OPT_REASONS = frozenset({"fits", "over_headroom"})


def _count(name: str) -> None:
    emit_counted(name, 1)


def set_calibration(table: Optional[Dict[str, float]]) -> None:
    """Force the calibration table (tests, the smoke's sweep) or reset it to
    lazy resolution (None)."""
    global _calibration, _calibration_forced, _calibration_key
    with _lock:
        _calibration = table
        _calibration_forced = table is not None
        _calibration_key = None


def _platform() -> str:
    from modin_tpu_torch.config import Device

    return "cuda" if Device.get() == "cuda" else "cpu"


def _device_key() -> str:
    """The card (or "cpu"), the torch version and the mesh a table belongs
    to (its sharded entries are measured on that mesh)."""
    import torch

    from modin_tpu_torch.parallel.mesh import mesh_shape_key

    if _platform() == "cuda":
        from modin_tpu_torch.parallel.mesh import get_device

        name = torch.cuda.get_device_name(get_device())
    else:
        name = "cpu"
    return f"{name}|torch-{torch.__version__}|mesh-{mesh_shape_key()}"


def _cache_path(platform: str, device_key: str) -> Optional[str]:
    return calstore.table_path("kernel_router", platform, device_key=device_key, version=_CAL_VERSION)


def _time_best(fn: Callable[[], Any], sync: Callable[[], None], reps: int = 2) -> float:
    """Best wall time of ``fn()`` over ``reps`` runs after one untimed
    warm-up, each ended by ``sync()`` inside the timer."""
    fn()
    sync()
    best = float("inf")
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def fit_fixed_and_growing(t_small: float, t_large: float, growth: float) -> Tuple[float, float]:
    """(fixed, growing) seconds of ``t(n) = fixed + growing * g(n)`` through
    two timings, with ``g`` 1 at the small size and ``growth`` at the large
    one.  Where noise leaves the large timing no slower, all of it grows."""
    if growth <= 1.0 or t_large <= t_small:
        return 0.0, t_large / max(growth, 1.0)
    growing = (t_large - t_small) / (growth - 1.0)
    return max(t_small - growing, 0.0), growing


def _measure() -> Dict[str, Any]:
    """Time the device and host kernels at the calibration size, and the
    device kernels again at ``DEVICE_FIT_FACTOR`` times the rows.

    pandas is timed in both cardinality regimes: its hash-based nunique and
    mode run many times faster a row on few distinct values (the columns
    the device answers with a histogram) than on all-distinct ones (the
    columns that need a sort), so one coefficient an op would mispredict
    one of them.
    """
    import numpy as np
    import pandas
    import torch

    from modin_tpu_torch.config import KernelRouterCalibrationRows
    from modin_tpu_torch.ops.cuda.groupby_kernels import bincount
    from modin_tpu_torch.ops.reductions import _nunique_sorted
    from modin_tpu_torch.ops.sort import sorted_valid
    from modin_tpu_torch.parallel.engine import TorchWrapper
    from modin_tpu_torch.parallel.mesh import get_device

    rows = int(KernelRouterCalibrationRows.get())
    device = get_device()
    if device.type == "cuda":
        def sync() -> None:
            torch.cuda.synchronize(device)
    else:
        def sync() -> None:
            return None

    def device_times(values_wide: Any, values_narrow: Any, n: int) -> Dict[str, float]:
        dev_wide = TorchWrapper.put(values_wide, device)
        dev_narrow = TorchWrapper.put(values_narrow, device)
        sorted_dev, n_valid = sorted_valid(dev_wide, n)
        return {
            "sort": _time_best(lambda: sorted_valid(dev_wide, n), sync),
            "consume": _time_best(lambda: _nunique_sorted(sorted_dev, n_valid, n, True), sync),
            # the hist strategy's work: offset codes, the bincount kernel,
            # the occupied bins
            "hist": _time_best(lambda: (bincount((dev_narrow - 0).contiguous(), 1024) > 0).sum(), sync),
        }

    rng = np.random.default_rng(0)
    wide = rng.integers(0, 1 << 40, rows)  # ~all distinct: the sort case
    narrow = rng.integers(0, 1024, rows)  # few distinct: the hist case
    small = device_times(wide, narrow, rows)
    fit_rows = rows * DEVICE_FIT_FACTOR
    large = device_times(rng.integers(0, 1 << 40, fit_rows), rng.integers(0, 1024, fit_rows), fit_rows)
    table: Dict[str, Any] = {
        "version": _CAL_VERSION,
        "platform": _platform(),
        "device": _device_key(),
        "rows": rows,
        "device_fit_rows": fit_rows,
    }
    for name in DEVICE_ENTRIES:
        growth = (calstore.nlogn_scale if name == "sort" else calstore.linear_scale)(fit_rows, rows)
        fixed, growing = fit_fixed_and_growing(small[name], large[name], growth)
        table[f"device_{name}_s"] = growing
        table[f"device_{name}_fixed_s"] = fixed
        table[f"device_{name}_at_rows_s"] = small[name]
        table[f"device_{name}_at_fit_rows_s"] = large[name]
    for regime, values in (("high", wide), ("low", narrow)):
        host = pandas.Series(values)
        table[f"host_median_{regime}_s"] = _time_best(lambda: host.median(), sync)
        table[f"host_quantile_{regime}_s"] = _time_best(lambda: host.quantile(0.5), sync)
        table[f"host_nunique_{regime}_s"] = _time_best(lambda: host.nunique(), sync)
        table[f"host_mode_{regime}_s"] = _time_best(lambda: host.mode(), sync)
    _measure_sharded(table, rows, fit_rows, device, sync)
    return table


def _measure_sharded(table: Dict[str, Any], rows: int, fit_rows: int, device: Any,
                     sync: Callable[[], None]) -> None:
    """The layout router's entries, measured on this mesh where it has two
    or more row shards (else none, and the layout stays local):

    - ``device_shuffle_s`` (and its fixed part): the shuffle's sharded sort
      of an all-distinct int64 key with one payload column, timed at the
      calibration rows and at the fit rows as the device entries are.  A
      shuffle no slower at the fit rows is all fixed cost (its launches and
      copies), and the growing part is at least the local sort's over the
      distinct shard devices (each row is still sorted once);
    - ``collective_bytes_per_s``: the bare block exchange of one int64
      column at the fit rows, ``S x S`` blocks of ``fit_rows / S^2`` rows.

    A failure propagates: :func:`get_calibration` records it in
    ``CALIBRATION_ERROR`` and stores no table (on the card a device failure
    raises)."""
    from modin_tpu_torch.parallel import shuffle
    from modin_tpu_torch.parallel.engine import TorchWrapper
    from modin_tpu_torch.parallel.mesh import num_row_shards, shard_devices

    shards = num_row_shards()
    if shards < 2:
        return
    import numpy as np
    import torch

    devices = shard_devices()

    def sync_all() -> None:
        # every shard device: the exchange's last copies land on them
        for dev in dict.fromkeys(devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        sync()

    rng = np.random.default_rng(1)
    timed = []
    for n in (rows, fit_rows):
        key = TorchWrapper.put(rng.integers(0, 1 << 40, n), device)
        payload = TorchWrapper.put(rng.integers(0, 1 << 40, n), device)
        timed.append(_time_best(lambda: shuffle.range_shuffle(key, [payload], n, local_sort=True), sync_all))
        del key, payload
    fixed, growing = fit_fixed_and_growing(timed[0], timed[1], calstore.nlogn_scale(fit_rows, rows))
    if timed[1] <= timed[0]:
        # no slower at the fit rows: both timings are the shuffle's launches
        # and copies, a fixed cost
        fixed, growing = min(timed), 0.0
    # every row is still sorted once, the shards' sorts side by side only
    # across distinct devices
    growing = max(growing, table["device_sort_s"] / len(set(devices)))
    table.update(device_shuffle_s=growing, device_shuffle_fixed_s=fixed, device_shuffle_at_rows_s=timed[0],
                 device_shuffle_at_fit_rows_s=timed[1], mesh_shards=shards)
    block = max(fit_rows // (shards * shards), 8)
    send = [[torch.zeros(shards * block, dtype=torch.int64, device=dev)] for dev in devices]
    sent = np.full((shards, shards), block)
    wall = _time_best(lambda: shuffle.exchange(send, sent, devices), sync_all)
    if wall > 0:
        table["collective_bytes_per_s"] = shards * shards * block * 8 / wall


def _device_failure(err: BaseException) -> bool:
    from modin_tpu_torch.core.execution.resilience import classify_device_error

    return classify_device_error(err) is not None


def calibration_peek() -> Optional[Dict[str, float]]:
    """The calibration table if ALREADY resolved, never measuring (the plan
    optimizer reads it: planning must not trigger the measurement)."""
    with _lock:
        table = _calibration
    return table if isinstance(table, dict) else None


def get_calibration() -> Optional[Dict[str, float]]:
    """The calibration table: memory, then ``CacheDir``, then the one-shot
    measurement.  None when the measurement failed (the caller routes
    device, and ``CALIBRATION_ERROR`` says why); a failure is remembered, so
    a broken device is probed once, not per verdict, and no table is
    stored.  On the card a device failure of the probe (an OOM, a kernel
    or a copy that did not run) raises instead, as the device paths do."""
    global _calibration, _calibration_key, CALIBRATIONS, CALIBRATION_ERROR
    with _lock:
        key = None
        if _calibration is not None:
            if _calibration_forced:
                return _calibration or None
            key = _device_key()
            if _calibration_key == key:
                return _calibration or None
            _calibration = None  # another card or device setting
        platform, key = _platform(), key or _device_key()
        path = _cache_path(platform, key)
        table = calstore.load_table(path, version=_CAL_VERSION, platform=platform, device_key=key)
        if table is None:
            try:
                with _spans.span("router.calibrate", "QUERY-COMPILER", platform=platform):
                    table = _measure()
            except Exception as err:  # noqa: BLE001 -- a failed probe routes device; the smoke prints CALIBRATION_ERROR
                CALIBRATION_ERROR = f"{type(err).__name__}: {err}"
                if platform == "cuda" and _device_failure(err):
                    raise  # not remembered: the next verdict measures again
                _calibration, _calibration_key = False, key
                return None
            emit_metric("router.calibrate", 1)
            CALIBRATIONS += 1
            CALIBRATION_ERROR = None
            calstore.store_table(path, table)
        _calibration, _calibration_key = table, key
        return table


def device_term(table: Dict[str, float], name: str, growth: float) -> float:
    """One device entry's predicted seconds: its fixed part plus its
    growing part times ``growth`` (the rows' scale against the table's)."""
    return table.get(f"device_{name}_fixed_s", 0.0) + table[f"device_{name}_s"] * growth


def predicted_costs(op: str, n: int, strategies: List[str], table: Dict[str, float]) -> Dict[str, float]:
    """Predicted ``{device_s, host_s}`` of ``op`` over ``n`` rows with the
    given per-column strategies: linear scaling, but the sort term grows
    n·log2(n); each device term adds its fixed part."""
    cal_rows = max(int(table["rows"]), 2)
    scale = calstore.linear_scale(n, cal_rows)
    logscale = calstore.nlogn_scale(n, cal_rows)
    consume = device_term(table, "consume", scale)
    per_strategy = {
        "dict": 0.0,
        "view": 0.0,
        "cached": consume,
        "hist": device_term(table, "hist", scale),
        "sort": device_term(table, "sort", logscale) + consume,
    }
    device_s = sum(per_strategy[s] for s in strategies)
    # pandas is cardinality-sensitive: hist/dict columns are the regime it
    # hashes fast, the others the slow one
    host_s = sum(
        table[f"host_{op}_{'low' if s in ('hist', 'dict') else 'high'}_s"] for s in strategies
    ) * scale
    return {"device_s": device_s, "host_s": host_s}


def _layout_choice(op: str, n: int, payload_cols: int, itemsize: int,
                   resolve_table: Callable[[], Optional[Dict[str, float]]]) -> Tuple[str, str, Dict[str, float]]:
    """(choice, reason, predicted costs) of the layout verdict; the table is
    resolved only on the cost model's arm."""
    from modin_tpu_torch.config import RangePartitioning, SpmdMinRows, SpmdMode
    from modin_tpu_torch.parallel.mesh import num_row_shards

    mode = SpmdMode.get()
    if mode == "Auto" and op == "sort" and RangePartitioning.get():
        mode = "Sharded"
    if num_row_shards() < 2:
        return "local", "single_shard", {}
    if mode == "Sharded":
        return "sharded", "forced", {}
    if mode == "Local":
        return "local", "forced", {}
    if n < int(SpmdMinRows.get()):
        return "local", "below_min_rows", {}
    table = resolve_table()
    if table is None or "device_shuffle_s" not in table:
        return "local", "uncalibrated", {}
    costs = predicted_layout_costs(n, payload_cols, itemsize, table, op)
    return ("sharded" if costs["sharded_s"] < costs["local_s"] else "local"), "cost_model", costs


def predicted_layout_costs(n: int, payload_cols: int, itemsize: int, table: Dict[str, float],
                           op: str = "sort") -> Dict[str, float]:
    """Predicted ``{local_s, sharded_s}`` of one sort over ``n`` rows: both
    sides grow n·log n from their calibrated entries (the local sort and
    the shuffle's sharded sort of a key and one payload column), and each
    payload column past that one is billed at the measured
    ``collective_bytes_per_s``.  A groupby UDF (``apply``) runs in pandas
    on the same rows on either side, so its sides differ by the shuffle
    alone: ``local_s`` is 0."""
    logscale = calstore.nlogn_scale(n, int(table["rows"]))
    local_s = 0.0 if op == "apply" else device_term(table, "sort", logscale)
    sharded_s = device_term(table, "shuffle", logscale)
    bw = float(table.get("collective_bytes_per_s") or 0.0)
    if bw > 0 and payload_cols > 1:
        sharded_s += (payload_cols - 1) * n * itemsize / bw
    return {"local_s": local_s, "sharded_s": sharded_s}


def layout_verdict(op: str, n: int, payload_cols: int = 0, itemsize: int = 8) -> Dict[str, Any]:
    """The verdict of :func:`decide_layout` with its reason and predicted
    costs, counted the same way (the smoke prints it)."""
    choice, reason, costs = _layout_choice(op, n, payload_cols, itemsize, get_calibration)
    _count(f"router.spmd_{op}.{choice}")
    if _spans.TRACE_ON:
        _spans.event("router.decide", "QUERY-COMPILER", op=f"spmd_{op}", n=n, choice=choice, reason=reason,
                     payload_cols=payload_cols, **{k: round(v, 6) for k, v in costs.items()})
    return {"choice": choice, "reason": reason, **costs}


def decide_layout(op: str, n: int, payload_cols: int = 0, itemsize: int = 8) -> str:
    """"local" or "sharded" for one collective-eligible op over ``n`` rows.

    ``op`` names the family (``sort`` for ``sort_values`` and the
    sorted-representation build, ``merge`` for the join's right-side
    sort, ``apply`` for a groupby UDF); ``payload_cols`` counts the columns
    the shuffle would move beside the key.  A single-shard mesh answers
    "local" (``single_shard``) before anything else; ``SpmdMode`` Sharded
    and Local pin a side (``RangePartitioning`` pins the sort Sharded
    under Auto); under Auto a frame under ``SpmdMinRows`` stays local,
    a table without the sharded entries (measured on a single shard, or
    not at all) too (``uncalibrated``), and otherwise
    :func:`predicted_layout_costs` decides.  Counted as
    ``router.spmd_<op>.<choice>``; while tracing, a ``router.decide`` event
    with the predicted costs."""
    return layout_verdict(op, n, payload_cols, itemsize)["choice"]


def planned_layout(op: str, n: Optional[int]) -> str:
    """The plan-time layout leg: :func:`decide_layout`'s arms over the
    already resolved table (planning never measures), not counted."""
    if n is None:
        return "local"
    return _layout_choice(op, int(n), 1, 8, calibration_peek)[0]


def decide_residency(op: str, est_bytes: int, self_bytes: int = 0) -> str:
    """"resident" or "windowed" for one streaming-eligible op.

    ``op`` names the family (``scan_reduce``/``scan_groupby`` for the
    planner's window loop, ``sort``/``merge`` for the external kernels);
    ``est_bytes`` is the op's working set (the source's size or the
    frames' bytes) and ``self_bytes`` the share of the device ledger its
    own inputs already hold (taken off, so a frame is not counted against
    its own headroom).  Under ``StreamMode`` Auto the op streams exactly
    when its estimate passes the headroom, ``budget`` less the other
    residents; no budget, resident.  Resident and Windowed pin a side.
    The optimizer's consult (:data:`_opt_consult`) may answer an Auto
    verdict from the plan.  Counted as ``router.residency_<op>.<choice>``;
    while tracing, a ``router.decide`` event with the estimate and the
    headroom."""
    from modin_tpu_torch.config import StreamMode
    from modin_tpu_torch.core.memory import device_ledger

    mode = StreamMode.get()
    headroom = None
    if mode == "Resident":
        choice, reason = "resident", "forced"
    elif mode == "Windowed":
        choice, reason = "windowed", "forced"
    else:
        budget = device_ledger.budget()
        if budget is None:
            choice, reason = "resident", "no_budget"
        else:
            headroom = budget - max(device_ledger.total_bytes() - max(int(self_bytes), 0), 0)
            choice, reason = ("windowed", "over_headroom") if int(est_bytes) > headroom else ("resident", "fits")
    consult = _opt_consult
    if consult is not None and reason in _OPT_REASONS:
        planned = consult("residency", choice, reason, op=op, est_bytes=int(est_bytes))
        if planned is not None:
            choice, reason = planned
    _count(f"router.residency_{op}.{choice}")
    if _spans.TRACE_ON:
        extra = {} if headroom is None else {"headroom_bytes": int(headroom)}
        _spans.event("router.decide", "QUERY-COMPILER", op=f"residency_{op}", est_bytes=int(est_bytes),
                     choice=choice, reason=reason, **extra)
    return choice


def decide_compile(plan_sig: Any, n: int) -> str:
    """"fused" or "staged" for a segment over ``n`` rows: the one gate of
    the whole-plan fused leg and of the eager groupby's ``groupagg`` route.
    ``MODIN_TPU_TORCH_FUSE`` pins a side; under Auto a segment under
    ``MODIN_TPU_TORCH_FUSE_MIN_ROWS`` rows stays staged.  ``plan_sig`` names
    the segment (None for an eager groupby), as the reference's gate takes
    it."""
    from modin_tpu_torch.config import FuseMinRows, FuseMode

    mode = FuseMode.get().lower()
    if mode in ("fused", "staged"):
        choice = mode
    else:
        choice = "staged" if n < int(FuseMinRows.get()) else "fused"
    _count(f"router.fuse.{choice}")
    return choice


def forced_host(op: str, n: int) -> bool:
    """True when routing is pinned to Host: callers ask this BEFORE any
    device work (materialization, the histogram's range probe), so a pinned
    op pays no device work on its way to pandas.  Counted like any other
    verdict."""
    from modin_tpu_torch.config import KernelRouterMode

    if KernelRouterMode.get().lower() != "host":
        return False
    decide(op, n, [])
    return True


def verdict(op: str, n: int, strategies: List[str]) -> Dict[str, Any]:
    """The verdict of :func:`decide` with its reason and predicted costs,
    counted the same way (the smoke's sweep prints it)."""
    from modin_tpu_torch.config import KernelRouterMinRows, KernelRouterMode

    mode = KernelRouterMode.get().lower()
    costs: Dict[str, float] = {}
    if mode in ("device", "host"):
        choice, reason = mode, "forced"
    elif n < int(KernelRouterMinRows.get()):
        choice, reason = "device", "below_min_rows"
    else:
        table = get_calibration()
        if table is None:
            choice, reason = "device", "uncalibrated"
        else:
            costs = predicted_costs(op, n, strategies, table)
            choice = "host" if costs["device_s"] - costs["host_s"] > MIN_SAVINGS_S else "device"
            reason = "cost_model"
    _count(f"router.{op}.{choice}")
    if _spans.TRACE_ON:
        _spans.event(
            "router.decide", "QUERY-COMPILER", op=op, n=n, choice=choice, reason=reason,
            strategies=",".join(strategies), **{k: round(v, 6) for k, v in costs.items()},
        )
    return {"choice": choice, "reason": reason, **costs}


def decide(op: str, n: int, strategies: List[str]) -> str:
    """"device" or "host" for one sort-shaped ``op`` (median, quantile,
    nunique, mode) over ``n`` rows, with one :data:`STRATEGIES` entry per
    column."""
    return verdict(op, n, strategies)["choice"]
