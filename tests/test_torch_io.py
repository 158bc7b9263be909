"""The IO layer of the torch port against the JAX package and pandas.

Small files under ``tmp_path``: the record splitter (native and plain) is
held to the JAX package's ``core/io/chunker.py`` byte range for byte range;
``read_csv``/``read_table`` through the port equal ``modin_tpu.pandas``'s and
pandas' own, on the serial and (with ``MIN_PARALLEL_BYTES`` and
``MIN_RANGE_BYTES`` lowered) the parallel path over several byte ranges; ``to_csv`` writes pandas' bytes; Parquet and Feather round
trip; a reader without a dispatcher defaults to pandas exactly once.
"""

import io
import threading

import numpy as np
import pandas
import pytest

import modin_tpu.pandas as mpd
from modin_tpu.core.io import chunker as jax_chunker
from modin_tpu.utils import to_pandas as jax_to_pandas

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch.core.io import chunker, file_dispatcher
from modin_tpu_torch.core.io.file_dispatcher import FileDispatcher
from modin_tpu_torch.core.io.text import csv_dispatcher
from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc


@pytest.fixture(autouse=True)
def _cpu_device():
    modin_tpu_torch.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _join_jax_watchdog_threads():
    """Let the JAX package's per-fetch watchdog threads end before the next
    test file runs in this worker (``tests/test_watch.py`` counts threads)."""
    yield
    for t in threading.enumerate():
        if t.name.startswith("modin-tpu-watchdog"):
            t.join(timeout=5)


def _csv_bytes(rows: int = 400, seed: int = 0) -> bytes:
    """A CSV whose quoted fields hold commas, quotes and newlines."""
    rng = np.random.default_rng(seed)
    lines = ["a,b,note,c"]
    for i in range(rows):
        note = ['"x, y"', '"two\nlines"', "plain", '"say ""hi"""', '""'][i % 5]
        lines.append(f"{rng.integers(0, 100)},{rng.normal():.6f},{note},{i}")
    return ("\n".join(lines) + "\n").encode()


# ---------------------------------------------------------------------- #
# the record splitter
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("target", [1, 7, 64, 1000, 1 << 20])
def test_native_splitter_matches_jax(target):
    buf = _csv_bytes()
    header_end = chunker.find_header_end(buf, 1)
    assert header_end == jax_chunker.find_header_end(buf, 1)
    before = chunker.NATIVE_SPLITS
    got = chunker.split_record_ranges(buf, header_end, target)
    assert got == jax_chunker.split_record_ranges(buf, header_end, target)
    if chunker._get_lib() is not None:  # g++ built the native library
        assert chunker.NATIVE_SPLITS == before + 1
    # the ranges tile the body, and each holds whole records only
    assert got[0][0] == header_end and got[-1][1] == len(buf)
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
    records = [len(pandas.read_csv(io.BytesIO(buf[s:e]), header=None)) for s, e in got]
    assert sum(records) == 400


@pytest.mark.parametrize("target", [1, 7, 64, 1000, 1 << 20])
def test_python_splitter_matches_jax(target):
    buf = _csv_bytes(seed=1)
    header_end = chunker.find_header_end(buf, 1)
    got = chunker._split_record_ranges_py(buf, header_end, target, '"', 1 << 16)
    assert got == jax_chunker._split_record_ranges_py(buf, header_end, target, '"', 1 << 16)
    assert got == chunker.split_record_ranges(buf, header_end, target)


# ---------------------------------------------------------------------- #
# read_csv / read_table
# ---------------------------------------------------------------------- #


def _frame_data(rows: int = 3000, seed: int = 2) -> dict:
    rng = np.random.default_rng(seed)
    f = rng.normal(size=rows)
    f[rng.random(rows) < 0.1] = np.nan
    s = np.array(["alpha", "beta", "gamma-delta", "x, y"], dtype=object)[rng.integers(0, 4, rows)]
    s[rng.random(rows) < 0.05] = np.nan
    return {
        "i": rng.integers(0, 100, rows),
        "f": f,
        "s": s,
        "j": rng.integers(-5, 5, rows),
        "t": np.array(["u", "v"], dtype=object)[rng.integers(0, 2, rows)],
    }


READS = {
    "plain": ("read_csv", {}),
    "usecols": ("read_csv", {"usecols": ["i", "s", "j"]}),
    "skiprows": ("read_csv", {"skiprows": 3}),
    "tab_read_table": ("read_table", {}),
    "tab_sep": ("read_csv", {"sep": "\t"}),
    "dtype": ("read_csv", {"dtype": {"j": "float64"}}),
}


@pytest.fixture
def csv_files(tmp_path):
    df = pandas.DataFrame(_frame_data())
    comma, tab = tmp_path / "d.csv", tmp_path / "d.tsv"
    df.to_csv(comma, index=False)
    df.to_csv(tab, index=False, sep="\t")
    return str(comma), str(tab)


@pytest.fixture
def parallel_ranges(monkeypatch):
    """Lowers the parallel read's size floors so that a small file parses
    in several byte ranges; the list holds the range count of each read."""
    monkeypatch.setattr(FileDispatcher, "MIN_PARALLEL_BYTES", 1)
    monkeypatch.setattr(FileDispatcher, "MIN_RANGE_BYTES", 1)
    counts = []
    threaded = FileDispatcher._parse_ranges_threaded.__func__

    def counting(cls, ranges, parse):
        counts.append(len(ranges))
        return threaded(cls, ranges, parse)

    monkeypatch.setattr(FileDispatcher, "_parse_ranges_threaded", classmethod(counting))
    return counts


@pytest.mark.parametrize("parallel", [False, True], ids=["serial", "parallel"])
@pytest.mark.parametrize("case", sorted(READS))
def test_read_csv_matches_jax_and_pandas(case, parallel, csv_files, request):
    reader, kwargs = READS[case]
    path = csv_files[1] if case.startswith("tab") else csv_files[0]
    ranges = request.getfixturevalue("parallel_ranges") if parallel else []
    reads = file_dispatcher.PARALLEL_READS
    before = tqc.DEFAULTS_TO_PANDAS
    got = getattr(tpd, reader)(path, **kwargs)
    # a deferred read (MODIN_TPU_TORCH_PLAN=Auto) parses at its first
    # materialization
    frame = got._query_compiler._modin_frame
    assert tqc.DEFAULTS_TO_PANDAS == before
    assert file_dispatcher.PARALLEL_READS == reads + int(parallel)
    assert all(n >= 8 for n in ranges) and len(ranges) == int(parallel)
    for label, col in zip(frame.columns, frame._columns):
        # numbers on the device, strings on the host
        assert col.is_device == (col.pandas_dtype.kind in "iuf"), label
    want = getattr(pandas, reader)(path, **kwargs)
    pandas.testing.assert_frame_equal(tpd.to_pandas(got), want)
    pandas.testing.assert_frame_equal(jax_to_pandas(getattr(mpd, reader)(path, **kwargs)), want)


def test_read_csv_quoted_newlines_parallel(tmp_path, parallel_ranges):
    path = tmp_path / "q.csv"
    path.write_bytes(_csv_bytes(rows=2000, seed=5))
    reads = file_dispatcher.PARALLEL_READS
    got = tpd.read_csv(str(path))
    got._query_compiler._modin_frame  # a deferred read parses here
    assert file_dispatcher.PARALLEL_READS == reads + 1
    assert parallel_ranges[0] >= 8
    pandas.testing.assert_frame_equal(tpd.to_pandas(got), pandas.read_csv(path))


def _typed_apart_data(rows: int = 4000, seed: int = 6) -> dict:
    """Columns whose byte ranges parse to different types: text only in the
    last rows (the first ranges see an all-missing float64 column), numbers
    in the first rows and text in the last, ints with missing values in one
    stretch, bools with missing values in one stretch."""
    rng = np.random.default_rng(seed)
    tail = np.arange(rows) >= rows * 7 // 8
    sparse = np.where(tail & (rng.random(rows) < 0.5), "late", None).astype(object)
    mixed = np.where(tail, "word", rng.integers(0, 9, rows).astype(str)).astype(object)
    ints = rng.integers(0, 1000, rows).astype(float)
    ints[rows // 3:rows // 3 + 20] = np.nan
    flags = (rng.random(rows) < 0.5).astype(object)
    flags[rows // 2:rows // 2 + 20] = None
    return {"i": rng.integers(0, 100, rows), "sparse": sparse, "mixed": mixed,
            "ints": ints, "flags": flags, "f": rng.normal(size=rows)}


@pytest.mark.parametrize("columns", [["i", "ints", "f"], None], ids=["agree", "apart"])
def test_read_csv_ranges_typed_apart(columns, tmp_path, parallel_ranges):
    path = tmp_path / "apart.csv"
    pandas.DataFrame(_typed_apart_data()).to_csv(path, index=False, columns=columns)
    want = pandas.read_csv(path)
    reads = file_dispatcher.PARALLEL_READS
    got = tpd.read_csv(str(path))
    got._query_compiler._modin_frame  # a deferred read parses here
    assert parallel_ranges[0] >= 8
    if columns is None:
        # the ranges typed the text and bool columns apart, and pandas' own
        # parse answered: the parallel read is not counted
        assert str(want["sparse"].dtype) == "str" and str(want["mixed"].dtype) == "str"
        assert file_dispatcher.PARALLEL_READS == reads
    else:
        # ints beside floats: the concatenation widens as pandas' parse does
        assert want["ints"].dtype == np.float64
        assert file_dispatcher.PARALLEL_READS == reads + 1
    pandas.testing.assert_frame_equal(tpd.to_pandas(got), want)
    pandas.testing.assert_frame_equal(jax_to_pandas(mpd.read_csv(str(path))), want)


def test_unparallelizable_options_read_serially(csv_files, parallel_ranges):
    reads = file_dispatcher.PARALLEL_READS
    got = tpd.read_csv(csv_files[0], nrows=100, index_col="j")
    got._query_compiler._modin_frame  # a deferred read parses here
    assert file_dispatcher.PARALLEL_READS == reads and parallel_ranges == []
    pandas.testing.assert_frame_equal(
        tpd.to_pandas(got), pandas.read_csv(csv_files[0], nrows=100, index_col="j")
    )


# ---------------------------------------------------------------------- #
# writers
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("index", [True, False])
def test_to_csv_bytes_equal_pandas(index, tmp_path, monkeypatch):
    # small windows: several appends, and computed device columns fetched
    # with one device-to-host copy per window
    monkeypatch.setattr(csv_dispatcher, "_WRITE_CHUNK_ROWS", 700)
    data = _frame_data(rows=2500)
    pdf, tdf = pandas.DataFrame(data), tpd.DataFrame(data)
    pdf["k"], tdf["k"] = pdf["i"] * 2 + pdf["j"], tdf["i"] * 2 + tdf["j"]
    pdf["b"], tdf["b"] = pdf["f"] > 0, tdf["f"] > 0
    pdf, tdf = pdf[pdf["j"] != 0], tdf[tdf["j"] != 0]
    before = tqc.DEFAULTS_TO_PANDAS
    tdf.to_csv(str(tmp_path / "port.csv"), index=index)
    assert tqc.DEFAULTS_TO_PANDAS == before
    pdf.to_csv(tmp_path / "pandas.csv", index=index)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "pandas.csv").read_bytes()


def test_window_to_pandas_fetches_computed_columns():
    data = _frame_data(rows=300)
    tdf = tpd.DataFrame(data)
    tdf["k"] = tdf["i"] + 1
    frame = tdf._query_compiler._modin_frame
    want = tpd.to_pandas(tdf).iloc[40:170]
    pandas.testing.assert_frame_equal(frame.window_to_pandas(40, 170), want)


def test_series_to_csv_defaults_once(tmp_path):
    data = _frame_data(rows=200)
    before = tqc.DEFAULTS_TO_PANDAS
    tpd.DataFrame(data)["s"].to_csv(str(tmp_path / "port.csv"))
    assert tqc.DEFAULTS_TO_PANDAS == before + 1
    pandas.DataFrame(data)["s"].to_csv(tmp_path / "pandas.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "pandas.csv").read_bytes()


def test_parquet_round_trip(tmp_path, monkeypatch):
    monkeypatch.setattr(csv_dispatcher, "_WRITE_CHUNK_ROWS", 900)
    data = _frame_data(rows=3000)
    pdf, tdf = pandas.DataFrame(data), tpd.DataFrame(data)
    tdf["k"] = tdf["i"] * 3
    pdf["k"] = pdf["i"] * 3
    before = tqc.DEFAULTS_TO_PANDAS
    tdf.to_parquet(str(tmp_path / "port.parquet"))
    # several row groups
    pdf.to_parquet(tmp_path / "pandas.parquet", row_group_size=500)
    back = tpd.read_parquet(str(tmp_path / "port.parquet"))
    other = tpd.read_parquet(str(tmp_path / "pandas.parquet"))
    assert tqc.DEFAULTS_TO_PANDAS == before
    want = pandas.read_parquet(tmp_path / "pandas.parquet")
    pandas.testing.assert_frame_equal(tpd.to_pandas(back), want)
    pandas.testing.assert_frame_equal(tpd.to_pandas(other), want)
    pandas.testing.assert_frame_equal(pandas.read_parquet(tmp_path / "port.parquet"), want)
    pandas.testing.assert_frame_equal(
        tpd.to_pandas(tpd.read_parquet(str(tmp_path / "port.parquet"), columns=["s", "i"])),
        pandas.read_parquet(tmp_path / "pandas.parquet", columns=["s", "i"]),
    )


def test_feather_round_trip(tmp_path):
    data = _frame_data(rows=1000)
    before = tqc.DEFAULTS_TO_PANDAS
    tpd.DataFrame(data).to_feather(str(tmp_path / "port.feather"))
    back = tpd.read_feather(str(tmp_path / "port.feather"))
    assert tqc.DEFAULTS_TO_PANDAS == before
    pandas.DataFrame(data).to_feather(tmp_path / "pandas.feather")
    pandas.testing.assert_frame_equal(
        tpd.to_pandas(back), pandas.read_feather(tmp_path / "pandas.feather")
    )


def test_parquet_read_options_match_pandas(tmp_path):
    data = _frame_data(rows=2000)
    path = tmp_path / "d.parquet"
    pandas.DataFrame(data).to_parquet(path, row_group_size=300)
    for kwargs in ({"columns": ["j", "s"]}, {"filters": [("i", "<", 30)]}):
        before = tqc.DEFAULTS_TO_PANDAS
        got = tpd.read_parquet(str(path), **kwargs)
        assert tqc.DEFAULTS_TO_PANDAS == before
        pandas.testing.assert_frame_equal(tpd.to_pandas(got), pandas.read_parquet(path, **kwargs))


def test_defaulted_reader_counts_once(tmp_path):
    # read_stata has no dispatcher (read_json has one since the JSON
    # dispatcher was ported)
    df = pandas.DataFrame(_frame_data(rows=50)).drop(columns=["s", "t"])
    df.to_stata(tmp_path / "d.dta", write_index=False)
    before = tqc.DEFAULTS_TO_PANDAS
    got = tpd.read_stata(str(tmp_path / "d.dta"))
    assert tqc.DEFAULTS_TO_PANDAS == before + 1
    assert isinstance(got, tpd.DataFrame)
    pandas.testing.assert_frame_equal(tpd.to_pandas(got), pandas.read_stata(tmp_path / "d.dta"))


def test_readers_bind_pandas_signatures(tmp_path):
    path = tmp_path / "p.csv"
    path.write_text("a;b\n1;x\n2;y\n")
    with pytest.raises(TypeError):
        tpd.read_csv(str(path), "extra-positional")
    got = tpd.read_csv(str(path), sep=";")
    pandas.testing.assert_frame_equal(tpd.to_pandas(got), pandas.read_csv(path, sep=";"))
    assert tpd.read_csv.__module__ == "modin_tpu_torch.pandas.io"
