#!/usr/bin/env python3
"""Smoke run of modin_tpu_torch on one NVIDIA GPU: build, check, drive, time.

    python3 chip_smoke.py [--rows N] [--float-rows N] [--seed S]

Phases, one JSON object per line each:

1. device  - card name, ``nvidia-smi`` name and power limit, versions.
2. build   - every CUDA kernel built from the sources in this checkout.
3. kernel  - ``bincount`` held against its plain torch version (exactly) on
             the card at 1e8 codes (and a ragged 1e8 + 77), widths from 3
             to 2^22 across the shared-memory cap, codes that include the
             overflow value, and all codes in one slot; times of the
             kernel, the plain version and ``torch.bincount`` (medians of 5
             runs after a warm-up, CUDA events) beside the bound.
4. main    - the asv main path (``make_frame((rows, 10), ngroups=g)`` for
             g in 100 and 10 000, plus a key of range 1e6) through
             ``modin_tpu_torch.pandas``: from_pandas, add/mul/mod/abs,
             df1 + df2, gt, sum/mean/count, groupby count/size/sum/mean,
             to_pandas; every result against pandas (ints exactly, floats
             to rtol 1e-12).  Without pandas the same queries go through
             ``TorchQueryCompiler.from_numpy_columns`` against numpy.
5. float   - float keys with NaN and float values with NaN (1e7 rows):
             groupby sum/mean/count under dropna True/False and the skipna
             reductions; the group mean twice, bit for bit.

Then the card's name and power limit, one ``{"kernels": [...]}`` line, and
last ``{"ok": true, "device": {...}}``.  Any mismatch raises and the process
exits non-zero.  Without a CUDA card, or without the package beside this
file, it exits non-zero and prints no result.
"""

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# H100 SXM device-memory rate (NVIDIA data sheet), for the bound of a kernel
HBM_BYTES_PER_S = 3.35e12
FLOAT_RTOL = 1e-12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` runs after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn):
    """(result, wall ms) of ``fn`` ended by a device synchronise."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def make_data(rows: int, seed: int, ngroups: int) -> dict:
    """The asv recipe (asv_bench/benchmarks/utils.py::make_frame)."""
    rng = np.random.default_rng(seed)
    data = {f"col{i}": rng.integers(0, 100, rows) for i in range(10)}
    data["groupby_col"] = rng.integers(0, ngroups, rows)
    return data


def mem_available_gib() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


def free_device_memory() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------- #
# 1-2. device and build
# ---------------------------------------------------------------------- #


def phase_device() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    try:
        import pandas

        pandas_version = pandas.__version__
    except ImportError:
        pandas_version = None
    emit({
        "phase": "device",
        "name": torch.cuda.get_device_name(0),
        "nvidia_smi": smi,
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "pandas": pandas_version,
        "mem_available_gib": round(mem_available_gib(), 1),
    })
    return smi


def phase_build() -> None:
    from modin_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    paths = build.build_all()
    emit({
        "phase": "build",
        "seconds": round(time.perf_counter() - t0, 3),
        "libraries": {k: os.path.relpath(v, HERE) for k, v in paths.items()},
        "ptxas": {k: [ln for ln in v.splitlines() if "registers" in ln or "spill" in ln]
                  for k, v in build.BUILD_LOGS.items()},
    })


# ---------------------------------------------------------------------- #
# 3. the kernel against its plain version
# ---------------------------------------------------------------------- #


def phase_kernel(rows: int, seed: int) -> dict:
    import torch

    from modin_tpu_torch.ops.cuda import groupby_kernels as gk

    dev = torch.device("cuda", torch.cuda.current_device())
    cap = gk.smem_slots(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    by_width = {}
    max_err = 0

    def check_and_time(codes, width, label):
        nonlocal max_err
        got = gk.bincount(codes, width)
        want = gk.bincount_plain(codes, width)
        torch.cuda.synchronize()
        err = int((got - want).abs().max()) if width else 0
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise AssertionError(f"bincount != bincount_plain ({label}, width {width}): max err {err}")
        n = codes.numel()
        rec = {
            "phase": "kernel", "case": label, "n": n, "width": width,
            "mode": "shared" if width <= cap else "global",
            "exact": True,
            "kernel_ms": cuda_ms(lambda: gk.bincount(codes, width)),
            "plain_ms": cuda_ms(lambda: gk.bincount_plain(codes, width)),
            "library_ms": cuda_ms(lambda: torch.bincount(codes, minlength=width)),
            "bound_ms": (8 * n + 8 * width) / HBM_BYTES_PER_S * 1e3,
        }
        emit(rec)
        return rec

    for n in (rows, rows + 77):
        for width in (3, 100, 512, 10_000, cap, cap + 1, 10**6, 1 << 22):
            # codes in [0, width]: the top value is the overflow bucket
            codes = torch.randint(0, width + 1, (n,), device=dev, generator=gen)
            rec = check_and_time(codes, width, "uniform+overflow")
            if n == rows:
                by_width[width] = rec
            del codes
    for width in (100, cap + 1):
        codes = torch.full((rows,), 7, dtype=torch.int64, device=dev)
        check_and_time(codes, width, "one_slot")
        del codes
    free_device_memory()
    return {"cap": cap, "by_width": by_width, "max_abs_err": max_err}


# ---------------------------------------------------------------------- #
# 4-5. the main path and the float path
# ---------------------------------------------------------------------- #


MAIN_QUERIES = {
    "add": lambda d, d2: d.add(2),
    "mul": lambda d, d2: d.mul(2),
    "mod": lambda d, d2: d.mod(2),
    "abs": lambda d, d2: d.abs(),
    "df_plus_df": lambda d, d2: d + d2,
    "gt": lambda d, d2: d > 50,
    "sum": lambda d, d2: d.sum(),
    "mean": lambda d, d2: d.mean(),
    "count": lambda d, d2: d.count(),
    "groupby_count": lambda d, d2: d.groupby("groupby_col").count(),
    "groupby_size": lambda d, d2: d.groupby("groupby_col").size(),
    "groupby_sum": lambda d, d2: d.groupby("groupby_col").sum(),
    "groupby_mean": lambda d, d2: d.groupby("groupby_col").mean(),
}


def assert_same_values(got: np.ndarray, want: np.ndarray, what: str) -> None:
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} != {want.shape}")
    if got.dtype.kind == "f" or want.dtype.kind == "f":
        g, w = got.astype(np.float64), want.astype(np.float64)
        if not np.array_equal(np.isnan(g), np.isnan(w)):
            raise AssertionError(f"{what}: NaN positions differ")
        ok = ~np.isnan(w)
        bad = np.abs(g[ok] - w[ok]) > FLOAT_RTOL * np.abs(w[ok])
        if bad.any():
            raise AssertionError(f"{what}: {int(bad.sum())} values beyond rtol {FLOAT_RTOL}")
    elif not np.array_equal(got, want):
        raise AssertionError(f"{what}: values differ")


def assert_same_pandas(got, want, what: str) -> None:
    import pandas

    if type(got) is not type(want):
        raise AssertionError(f"{what}: {type(got).__name__} != {type(want).__name__}")
    if not got.index.equals(want.index):
        raise AssertionError(f"{what}: index differs")
    if isinstance(want, pandas.Series):
        got, want = got.to_frame(), want.to_frame()
    if list(got.columns) != list(want.columns):
        raise AssertionError(f"{what}: columns differ")
    for i, label in enumerate(want.columns):
        g, w = got.iloc[:, i], want.iloc[:, i]
        if g.dtype != w.dtype:
            raise AssertionError(f"{what}[{label}]: dtype {g.dtype} != {w.dtype}")
        assert_same_values(g.to_numpy(), w.to_numpy(), f"{what}[{label}]")


def assert_on_cuda(qc, what: str) -> None:
    for col in qc._modin_frame._columns:
        if not col.is_device or col.data.device.type != "cuda":
            raise AssertionError(f"{what}: a value column is not on cuda")


def run_main_pandas(rows: int, seed: int) -> None:
    import pandas

    import modin_tpu_torch.pandas as tpd

    for g in (100, 10_000):
        p1 = pandas.DataFrame(make_data(rows, seed, g))
        p2 = pandas.DataFrame(make_data(rows, seed + 1, g))
        t1, from_ms = host_ms(lambda: tpd.from_pandas(p1))
        t2 = tpd.from_pandas(p2)
        assert_on_cuda(t1._query_compiler, "from_pandas")
        assert_on_cuda(t2._query_compiler, "from_pandas")
        emit({"phase": "main", "ngroups": g, "rows": rows, "query": "from_pandas",
              "port_ms": from_ms, "pandas_ms": None})
        for name, fn in MAIN_QUERIES.items():
            result, port_ms = host_ms(lambda: fn(t1, t2))
            assert_on_cuda(result._query_compiler, name)
            got, to_pandas_ms = host_ms(lambda: tpd.to_pandas(result))
            t0 = time.perf_counter()
            want = fn(p1, p2)
            pandas_ms = (time.perf_counter() - t0) * 1e3
            assert_same_pandas(got, want, f"{name} (ngroups {g})")
            emit({"phase": "main", "ngroups": g, "rows": rows, "query": name,
                  "port_ms": port_ms, "pandas_ms": pandas_ms,
                  "to_pandas_ms": to_pandas_ms, "match": True})
            del result, got, want
        del p1, p2, t1, t2
        free_device_memory()
    # a key of range 1e6: wider than the shared-memory cap, so the
    # factorization histogram takes the kernel's global mode
    rng = np.random.default_rng(seed + 2)
    p = pandas.DataFrame({"key": rng.integers(0, 10**6, rows), "col0": rng.integers(0, 100, rows)})
    t = tpd.from_pandas(p)
    for name, fn in {"groupby_wide_sum": lambda d: d.groupby("key").sum(),
                     "groupby_wide_size": lambda d: d.groupby("key").size()}.items():
        result, port_ms = host_ms(lambda: fn(t))
        got = tpd.to_pandas(result)
        t0 = time.perf_counter()
        want = fn(p)
        pandas_ms = (time.perf_counter() - t0) * 1e3
        assert_same_pandas(got, want, name)
        emit({"phase": "main", "ngroups": int(len(want)), "rows": rows, "query": name,
              "port_ms": port_ms, "pandas_ms": pandas_ms, "match": True})
    del p, t
    free_device_memory()


def _np_groupby(key: np.ndarray, col: np.ndarray, agg: str):
    """numpy reference of an int-key groupby (sorted keys, present only)."""
    uniq, inv = np.unique(key, return_inverse=True)
    counts = np.bincount(inv)
    if agg in ("count", "size"):
        return counts
    sums = np.bincount(inv, weights=col)
    return sums if agg == "sum" else sums / counts


def run_main_numpy(rows: int, seed: int) -> None:
    """The main-path queries below the pandas API, against numpy."""
    from modin_tpu_torch.core.storage_formats.torch.query_compiler import (
        TorchQueryCompiler,
    )

    def values(qc) -> list:
        frame = qc._modin_frame
        return [frame.get_column(i).to_numpy() for i in range(frame.num_cols)]

    def gb(agg):
        return lambda q, q2: q.groupby_agg(
            ["groupby_col"], agg, groupby_kwargs={}, agg_kwargs={}, drop=True
        )

    qc_queries = {
        "add": lambda q, q2: q.add(2), "mul": lambda q, q2: q.mul(2),
        "mod": lambda q, q2: q.mod(2), "abs": lambda q, q2: q.abs(),
        "df_plus_df": lambda q, q2: q.add(q2), "gt": lambda q, q2: q.gt(50),
        "sum": lambda q, q2: q.sum(), "mean": lambda q, q2: q.mean(),
        "count": lambda q, q2: q.count(),
        "groupby_count": gb("count"), "groupby_size": gb("size"),
        "groupby_sum": gb("sum"), "groupby_mean": gb("mean"),
    }
    for g in (100, 10_000):
        d1, d2 = make_data(rows, seed, g), make_data(rows, seed + 1, g)
        labels = list(d1)
        np_refs = {
            "add": lambda: [d1[k] + 2 for k in labels],
            "mul": lambda: [d1[k] * 2 for k in labels],
            "mod": lambda: [d1[k] % 2 for k in labels],
            "abs": lambda: [np.abs(d1[k]) for k in labels],
            "df_plus_df": lambda: [d1[k] + d2[k] for k in labels],
            "gt": lambda: [d1[k] > 50 for k in labels],
            "sum": lambda: [np.array([d1[k].sum() for k in labels])],
            "mean": lambda: [np.array([d1[k].mean() for k in labels])],
            "count": lambda: [np.full(len(labels), rows)],
            "groupby_size": lambda: [_np_groupby(d1["groupby_col"], None, "size")],
        }
        for agg in ("count", "sum", "mean"):
            np_refs[f"groupby_{agg}"] = lambda agg=agg: [
                _np_groupby(d1["groupby_col"], d1[k], agg) for k in labels[:-1]
            ]
        q1, from_ms = host_ms(lambda: TorchQueryCompiler.from_numpy_columns(d1))
        q2 = TorchQueryCompiler.from_numpy_columns(d2)
        assert_on_cuda(q1, "from_numpy_columns")
        emit({"phase": "main", "api": "query_compiler+numpy", "ngroups": g, "rows": rows,
              "query": "from_numpy_columns", "port_ms": from_ms, "numpy_ms": None})
        for name, fn in qc_queries.items():
            result, port_ms = host_ms(lambda: fn(q1, q2))
            assert_on_cuda(result, name)
            got = values(result)
            t0 = time.perf_counter()
            want = np_refs[name]()
            numpy_ms = (time.perf_counter() - t0) * 1e3
            if len(got) != len(want):
                raise AssertionError(f"{name}: {len(got)} columns != {len(want)}")
            for j, (a, b) in enumerate(zip(got, want)):
                assert_same_values(np.asarray(a), np.asarray(b), f"{name}[{j}] (ngroups {g})")
            emit({"phase": "main", "api": "query_compiler+numpy", "ngroups": g,
                  "rows": rows, "query": name, "port_ms": port_ms,
                  "numpy_ms": numpy_ms, "match": True})
            del result, got, want
        del q1, q2, d1, d2
        free_device_memory()


def phase_main(rows: int, seed: int, have_pandas: bool) -> dict:
    from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
    from modin_tpu_torch.ops.cuda import groupby_kernels as gk

    gk.LAUNCHES = 0
    tqc.DEFAULTS_TO_PANDAS = 0
    if have_pandas:
        run_main_pandas(rows, seed)
    else:
        emit({"phase": "main", "note": "pandas is not importable: the queries run "
              "through TorchQueryCompiler.from_numpy_columns against numpy"})
        run_main_numpy(rows, seed)
    launches, defaults = gk.LAUNCHES, tqc.DEFAULTS_TO_PANDAS
    emit({"phase": "main", "bincount_launches": launches, "defaults_to_pandas": defaults})
    if launches == 0:
        raise AssertionError("the main path never launched the bincount kernel")
    if defaults != 0:
        raise AssertionError(f"{defaults} main-path queries defaulted to pandas")
    return {"bincount": launches}


def float_frame(rows: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 1000, rows) / 8.0
    key[rng.random(rows) < 0.01] = np.nan
    # positive values: no cancellation in the group sums, so rtol 1e-12
    # measures the summation order and nothing else
    val = rng.uniform(0, 100, rows)
    val[rng.random(rows) < 0.01] = np.nan
    return {"key": key, "val": val, "ival": rng.integers(0, 100, rows)}


def phase_float(rows: int, seed: int, have_pandas: bool) -> None:
    from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
    from modin_tpu_torch.ops.cuda import groupby_kernels as gk

    gk.LAUNCHES = 0
    tqc.DEFAULTS_TO_PANDAS = 0
    data = float_frame(rows, seed + 3)
    if have_pandas:
        import pandas

        import modin_tpu_torch.pandas as tpd

        p = pandas.DataFrame(data)
        t = tpd.from_pandas(p)
        queries = {}
        for dropna in (True, False):
            for agg in ("sum", "mean", "count"):
                queries[f"groupby_{agg}_dropna{dropna}"] = (
                    lambda d, agg=agg, dropna=dropna: getattr(d.groupby("key", dropna=dropna), agg)()
                )
        for skipna in (True, False):
            for op in ("sum", "mean", "min", "max"):
                queries[f"{op}_skipna{skipna}"] = (
                    lambda d, op=op, skipna=skipna: getattr(d, op)(skipna=skipna)
                )
        for name, fn in queries.items():
            result, port_ms = host_ms(lambda: fn(t))
            got = tpd.to_pandas(result)
            t0 = time.perf_counter()
            want = fn(p)
            pandas_ms = (time.perf_counter() - t0) * 1e3
            assert_same_pandas(got, want, name)
            emit({"phase": "float", "rows": rows, "query": name, "port_ms": port_ms,
                  "pandas_ms": pandas_ms, "match": True})
        first = tpd.to_pandas(t.groupby("key").mean())
        second = tpd.to_pandas(t.groupby("key").mean())
        a, b = first.to_numpy(), second.to_numpy()
    else:
        from modin_tpu_torch.core.storage_formats.torch.query_compiler import (
            TorchQueryCompiler,
        )

        q = TorchQueryCompiler.from_numpy_columns(data)
        key, val = data["key"], data["val"]
        ok = ~np.isnan(key)
        uniq, inv = np.unique(key[ok], return_inverse=True)
        v = val[ok]
        vcount = np.bincount(inv, weights=~np.isnan(v))
        vsum = np.bincount(inv, weights=np.where(np.isnan(v), 0.0, v))
        refs = {"count": vcount, "sum": vsum, "mean": vsum / vcount}
        for agg, want in refs.items():
            r = q.groupby_agg(["key"], agg, groupby_kwargs={}, agg_kwargs={}, drop=True)
            got = r._modin_frame.get_column(0).to_numpy()
            assert_same_values(got, want, f"groupby_{agg} (numpy reference)")
            np.testing.assert_array_equal(r._modin_frame._index.arrays[0], uniq)
            emit({"phase": "float", "api": "query_compiler+numpy", "rows": rows,
                  "query": f"groupby_{agg}", "match": True})

        def mean_values():
            r = q.groupby_agg(["key"], "mean", groupby_kwargs={}, agg_kwargs={}, drop=True)
            return np.stack([c.to_numpy() for c in r._modin_frame._columns])

        a, b = mean_values(), mean_values()
    bitwise = bool(np.array_equal(a.view(np.int64), b.view(np.int64)))
    emit({"phase": "float", "group_mean_bitwise_repeat": bitwise,
          "bincount_launches": gk.LAUNCHES, "defaults_to_pandas": tqc.DEFAULTS_TO_PANDAS})
    if not bitwise:
        raise AssertionError("the float group mean differs between two runs")
    if tqc.DEFAULTS_TO_PANDAS != 0:
        raise AssertionError("a float-path query defaulted to pandas")
    free_device_memory()


def kernels_line(kernel: dict, launches: dict, rows: int) -> dict:
    by_width = kernel["by_width"]
    main = by_width[100]
    return {"kernels": [{
        "name": "bincount",
        "route": "cuda",
        "source": "modin_tpu_torch/ops/cuda/csrc/bincount.cu",
        "replaces": "modin_tpu/ops/pallas/groupby_kernels.py:29",
        "launches": launches["bincount"],
        "exact": True,
        "max_abs_err": kernel["max_abs_err"],
        "n": rows,
        "width": 100,
        "ms": main["kernel_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main["library_ms"],
        "smem_slots": kernel["cap"],
        "by_width": {
            str(w): {k: by_width[w][k] for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms", "mode")}
            for w in (100, 10_000)
        },
    }]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, default=10**8,
                        help="rows of the main-path frames and kernel inputs")
    parser.add_argument("--float-rows", type=int, default=10**7)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a CUDA card",
              file=sys.stderr)
        return 2
    try:
        import modin_tpu_torch
    except ImportError as err:
        print(f"chip_smoke: modin_tpu_torch is not importable here: {err}", file=sys.stderr)
        return 2
    if not os.path.abspath(modin_tpu_torch.__file__).startswith(os.path.join(HERE, "")):
        print("chip_smoke: modin_tpu_torch must come from this checkout, found "
              f"{modin_tpu_torch.__file__}", file=sys.stderr)
        return 2
    modin_tpu_torch.set_device("cuda")
    try:
        import pandas  # noqa: F401

        have_pandas = True
    except ImportError:
        have_pandas = False

    smi = phase_device()
    phase_build()
    rows = args.rows
    if rows >= 10**8 and mem_available_gib() < 60:
        rows = 5 * 10**7
        emit({"phase": "main", "note": f"host memory {mem_available_gib():.0f} GiB "
              f"cannot hold the 1e8-row frames: rows cut to {rows}"})
    kernel = phase_kernel(args.rows, args.seed)
    launches = phase_main(rows, args.seed, have_pandas)
    phase_float(args.float_rows, args.seed, have_pandas)
    print(smi, flush=True)
    emit(kernels_line(kernel, launches, args.rows))
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
