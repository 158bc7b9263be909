"""JSON lines, fixed-width, SQL, Excel and HDF through the torch port.

Each reader and writer is held against ``modin_tpu.pandas`` (the JAX
package on its CPU mesh) and pandas on inputs made from a seed with numpy,
in small files under ``tmp_path``:

- ``read_json`` and ``read_fwf`` in one parse, also where
  ``MIN_PARALLEL_BYTES``/``MIN_RANGE_BYTES`` are lowered so that
  ``read_csv`` would split the file; files whose columns change type part
  way; the non-lines forms, ``typ="series"``, ``chunksize``; streamed
  ``to_json`` writes pandas' bytes;
- ``read_sql`` through a plain connection and a ``ModinDatabaseConnection``,
  ``index_col``, ``chunksize``, columns that are NULL in the first rows;
  the ``to_sql`` round trip;
- Excel without an engine (none is installed here): the port's xlsx codec
  writes and reads what the JAX package's does, and an unsupported form
  raises ``ImportError`` as there;
- HDF without PyTables raises pandas' own ``ImportError``.

Every dispatchable form leaves ``DEFAULTS_TO_PANDAS`` where it was.
"""

import io
import sqlite3
import threading

import numpy as np
import pandas
import pytest

import modin_tpu.pandas as mpd
from modin_tpu.db_conn import ModinDatabaseConnection as JaxConnection
from modin_tpu.utils import to_pandas as jax_to_pandas

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch.core.io import file_dispatcher
from modin_tpu_torch.core.io.text import csv_dispatcher
from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
from modin_tpu_torch.db_conn import ModinDatabaseConnection, UnsupportedDatabaseException
from tests.test_torch_io import parallel_ranges  # noqa: F401  (a fixture)


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


@pytest.fixture
def defaults():
    """``DEFAULTS_TO_PANDAS`` at the start of the test; the test asserts
    the change."""
    return tqc.DEFAULTS_TO_PANDAS


def _frame_data(rows: int = 3000, seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    f = rng.normal(size=rows)
    f[rng.random(rows) < 0.1] = np.nan
    return {
        "i": rng.integers(-50, 50, rows),
        "j": rng.integers(0, 10**12, rows),
        "f": f,
        "g": rng.uniform(0, 1, rows).round(6),
        "s": np.array(['alpha', 'q"uote', "new\nline", "x, y"], dtype=object)[rng.integers(0, 4, rows)],
        "b": rng.random(rows) < 0.5,
    }


def _assert_on_device(got) -> None:
    frame = got._query_compiler._modin_frame
    for label, col in zip(frame.columns, frame._columns):
        assert col.is_device == (col.pandas_dtype.kind in "biuf"), label


def _typed_apart_data(rows: int = 4000, seed: int = 6) -> dict:
    """Columns whose type changes part way through the file: text only in
    the last rows (all missing before), numbers in the first rows and text
    in the last, bools with missing values in one stretch; ``ints`` has
    missing values in one stretch (ints beside floats)."""
    rng = np.random.default_rng(seed)
    tail = np.arange(rows) >= rows * 7 // 8
    sparse = np.where(tail & (rng.random(rows) < 0.5), "late", None).astype(object)
    mixed = np.where(tail, "word", rng.integers(0, 9, rows)).astype(object)
    ints = rng.integers(0, 1000, rows).astype(float)
    ints[rows // 3:rows // 3 + 20] = np.nan
    flags = (rng.random(rows) < 0.5).astype(object)
    flags[rows // 2:rows // 2 + 20] = None
    return {"i": rng.integers(0, 100, rows), "sparse": sparse, "mixed": mixed,
            "ints": ints, "flags": flags, "f": rng.normal(size=rows)}


# ---------------------------------------------------------------------- #
# JSON
# ---------------------------------------------------------------------- #


JSON_FILES = {"mixed": _frame_data, "typed_apart": _typed_apart_data}


@pytest.mark.parametrize("data", sorted(JSON_FILES))
@pytest.mark.parametrize("kwargs", [{}, {"orient": "records"}, {"dtype": {"i": "float64"}}],
                         ids=["plain", "orient_records", "dtype"])
def test_read_json_lines_matches_jax_and_pandas(kwargs, data, tmp_path, parallel_ranges, defaults):
    # with the size floors lowered read_csv would split this file; the
    # JSON read parses it once
    path = tmp_path / "d.jsonl"
    pandas.DataFrame(JSON_FILES[data]()).to_json(path, orient="records", lines=True)
    reads = file_dispatcher.PARALLEL_READS
    got = tpd.read_json(str(path), lines=True, **kwargs)
    assert tqc.DEFAULTS_TO_PANDAS == defaults
    assert file_dispatcher.PARALLEL_READS == reads and parallel_ranges == []
    _assert_on_device(got)
    want = pandas.read_json(path, lines=True, **kwargs)
    pandas.testing.assert_frame_equal(tpd.to_pandas(got), want)
    pandas.testing.assert_frame_equal(jax_to_pandas(mpd.read_json(str(path), lines=True, **kwargs)), want)


def test_read_json_lines_with_other_keys(tmp_path):
    # a key that only the last records carry: pandas' column order, the
    # column missing in the first rows
    lines = [f'{{"a": {i}, "b": {i * 0.5}}}' for i in range(400)]
    lines += [f'{{"c": "late", "a": {i}, "b": 1.0}}' for i in range(40)]
    path = tmp_path / "keys.jsonl"
    path.write_text("\n".join(lines) + "\n")
    got = tpd.read_json(str(path), lines=True)
    want = pandas.read_json(path, lines=True)
    pandas.testing.assert_frame_equal(tpd.to_pandas(got), want)
    pandas.testing.assert_frame_equal(jax_to_pandas(mpd.read_json(str(path), lines=True)), want)


@pytest.mark.parametrize("orient", [None, "records", "split", "columns", "index"])
def test_read_json_not_lines(orient, tmp_path, defaults):
    data = _frame_data(rows=200)
    del data["s"]  # newlines in keys of the index/columns orients aside
    path = tmp_path / "plain.json"
    pandas.DataFrame(data).to_json(path, orient=orient)
    got = tpd.read_json(str(path), orient=orient)
    assert tqc.DEFAULTS_TO_PANDAS == defaults
    want = pandas.read_json(path, orient=orient)
    pandas.testing.assert_frame_equal(tpd.to_pandas(got), want)
    pandas.testing.assert_frame_equal(jax_to_pandas(mpd.read_json(str(path), orient=orient)), want)


@pytest.mark.parametrize("lines", [False, True])
def test_read_json_series(lines, tmp_path, defaults):
    s = pandas.Series(np.random.default_rng(4).integers(0, 9, 50), name="v")
    path = tmp_path / "s.json"
    s.to_json(path, orient="records", lines=lines)
    got = tpd.read_json(str(path), typ="series", orient="records", lines=lines)
    assert isinstance(got, tpd.Series)
    assert tqc.DEFAULTS_TO_PANDAS == defaults
    want = pandas.read_json(path, typ="series", orient="records", lines=lines)
    pandas.testing.assert_series_equal(tpd.to_pandas(got), want)
    pandas.testing.assert_series_equal(
        jax_to_pandas(mpd.read_json(str(path), typ="series", orient="records", lines=lines)), want
    )


def test_read_json_chunksize_gives_pandas_reader(tmp_path):
    path = tmp_path / "c.jsonl"
    pandas.DataFrame(_frame_data(rows=250)).to_json(path, orient="records", lines=True)
    with tpd.read_json(str(path), lines=True, chunksize=100) as reader:
        chunks = list(reader)
    assert [len(c) for c in chunks] == [100, 100, 50]
    with pandas.read_json(path, lines=True, chunksize=100) as reader:
        want = list(reader)
    for got_chunk, want_chunk in zip(chunks, want):
        pandas.testing.assert_frame_equal(got_chunk, want_chunk)


def _written_frames(rows: int = 2500):
    """A port frame with computed and filtered columns, and pandas' twin."""
    data = _frame_data(rows=rows)
    pdf, tdf = pandas.DataFrame(data), tpd.DataFrame(data)
    pdf["k"], tdf["k"] = pdf["i"] * 2 + pdf["j"], tdf["i"] * 2 + tdf["j"]
    pdf["h"], tdf["h"] = pdf["f"] + pdf["g"], tdf["f"] + tdf["g"]
    return pdf[pdf["i"] != 0], tdf[tdf["i"] != 0]


def test_to_json_lines_streamed_equals_pandas_bytes(tmp_path, monkeypatch, defaults):
    # small windows: several appends, each window's computed columns
    # fetched in one device-to-host copy
    monkeypatch.setattr(csv_dispatcher, "_WRITE_CHUNK_ROWS", 700)
    pdf, tdf = _written_frames()
    calls = []
    window = type(tdf._query_compiler._modin_frame).window_to_pandas

    def counting(frame, start, stop):
        calls.append((start, stop))
        return window(frame, start, stop)

    monkeypatch.setattr(type(tdf._query_compiler._modin_frame), "window_to_pandas", counting)
    assert tdf.to_json(str(tmp_path / "port.jsonl"), orient="records", lines=True) is None
    assert tqc.DEFAULTS_TO_PANDAS == defaults
    assert len(calls) == -(-len(pdf) // 700) >= 3
    pdf.to_json(tmp_path / "pandas.jsonl", orient="records", lines=True)
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "pandas.jsonl").read_bytes()


@pytest.mark.parametrize("orient", [None, "split", "records", "index", "columns", "values", "table"])
def test_to_json_other_forms_write_pandas_bytes(orient, tmp_path, defaults):
    pdf, tdf = _written_frames(rows=300)
    tdf.to_json(str(tmp_path / "port.json"), orient=orient)
    pdf.to_json(tmp_path / "pandas.json", orient=orient)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "pandas.json").read_bytes()
    assert tdf.to_json(orient=orient) == pdf.to_json(orient=orient)
    # one pandas write each, counted
    assert tqc.DEFAULTS_TO_PANDAS == defaults + 2


def test_series_to_json_equals_pandas(tmp_path):
    pdf, tdf = _written_frames(rows=300)
    tdf["k"].to_json(str(tmp_path / "port.jsonl"), orient="records", lines=True)
    pdf["k"].to_json(tmp_path / "pandas.jsonl", orient="records", lines=True)
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "pandas.jsonl").read_bytes()


def test_to_json_lines_without_orient_raises_like_pandas(tmp_path):
    pdf, tdf = _written_frames(rows=50)
    with pytest.raises(ValueError) as want:
        pdf.to_json(tmp_path / "p.jsonl", lines=True)
    with pytest.raises(ValueError) as got:
        tdf.to_json(str(tmp_path / "t.jsonl"), lines=True)
    with pytest.raises(ValueError) as jax:
        mpd.DataFrame(pdf).to_json(str(tmp_path / "j.jsonl"), lines=True)
    assert str(got.value) == str(want.value) == str(jax.value)


# ---------------------------------------------------------------------- #
# fixed width
# ---------------------------------------------------------------------- #


def _write_fwf(path, rows: int = 5000, skip: int = 0, seed: int = 7) -> None:
    rng = np.random.default_rng(seed)
    ints = rng.integers(-10**6, 10**6, rows)
    floats = rng.normal(size=rows) * 1e3
    tags = np.array(["tag0", "tag1", "longer tag", "t"])[rng.integers(0, 4, rows)]
    with open(path, "w") as f:
        for i in range(skip):
            f.write(f"junk line {i}\n")
        f.write("%-12s%-14s%-12s\n" % ("alpha", "beta", "gamma"))
        for a, b, c in zip(ints, floats, tags):
            f.write("%-12d%-14.4f%-12s\n" % (a, b, c))


FWF_READS = {
    "infer": {},
    "explicit": {"colspecs": [(0, 12), (12, 26), (26, 38)]},
    "widths": {"widths": [12, 14, 12]},
    "skiprows": {"skiprows": 2},
    "infer_nrows": {"infer_nrows": 20},
}


@pytest.mark.parametrize("source", ["path", "buffer"])
@pytest.mark.parametrize("case", sorted(FWF_READS))
def test_read_fwf_matches_jax_and_pandas(case, source, tmp_path, parallel_ranges, defaults):
    # with the size floors lowered read_csv would split this file; the
    # fixed-width read parses it once
    kwargs = FWF_READS[case]
    path = tmp_path / "d.txt"
    _write_fwf(path, skip=kwargs.get("skiprows", 0))
    reads = file_dispatcher.PARALLEL_READS
    if source == "buffer":
        got = tpd.read_fwf(io.StringIO(path.read_text()), **kwargs)
    else:
        got = tpd.read_fwf(str(path), **kwargs)
    assert tqc.DEFAULTS_TO_PANDAS == defaults
    assert file_dispatcher.PARALLEL_READS == reads and parallel_ranges == []
    _assert_on_device(got)
    want = pandas.read_fwf(path, **kwargs)
    pandas.testing.assert_frame_equal(tpd.to_pandas(got), want)
    pandas.testing.assert_frame_equal(jax_to_pandas(mpd.read_fwf(str(path), **kwargs)), want)


@pytest.mark.parametrize("apart", [False, True], ids=["ints_with_blanks", "words_late"])
def test_read_fwf_column_changing_type(apart, tmp_path):
    rows = 4000
    rng = np.random.default_rng(8)
    path = tmp_path / "apart.txt"
    with open(path, "w") as f:
        f.write("%-8s%-10s\n" % ("n", "x"))
        for r in range(rows):
            # "x": ints with a blank stretch (ints beside floats), or words
            # only in the last rows (all missing before)
            if apart:
                x = "word" if r >= rows * 7 // 8 and r % 2 else ""
            else:
                x = "" if rows // 3 <= r < rows // 3 + 20 else str(rng.integers(0, 999))
            f.write("%-8d%-10s\n" % (r, x))
    want = pandas.read_fwf(path)
    got = tpd.read_fwf(str(path))
    pandas.testing.assert_frame_equal(tpd.to_pandas(got), want)
    pandas.testing.assert_frame_equal(jax_to_pandas(mpd.read_fwf(str(path))), want)


def test_read_fwf_nrows_and_index_col(tmp_path, defaults):
    path = tmp_path / "d.txt"
    _write_fwf(path, rows=300)
    got = tpd.read_fwf(str(path), nrows=100, index_col=0)
    assert tqc.DEFAULTS_TO_PANDAS == defaults
    pandas.testing.assert_frame_equal(tpd.to_pandas(got), pandas.read_fwf(path, nrows=100, index_col=0))


# ---------------------------------------------------------------------- #
# SQL
# ---------------------------------------------------------------------- #


@pytest.fixture
def sqlite_db(tmp_path):
    path = str(tmp_path / "test.db")
    rng = np.random.default_rng(4)
    pdf = pandas.DataFrame({
        "id": np.arange(5000),
        "v": rng.uniform(0, 1, 5000).round(6),
        "k": rng.integers(0, 100, 5000),
        "s": np.array(["a", "bb", "ccc"], dtype=object)[rng.integers(0, 3, 5000)],
    })
    conn = sqlite3.connect(path)
    pdf.to_sql("items", conn, index=False)
    conn.close()
    return path, pdf


SQL_READS = {
    "plain_connection": (lambda path: sqlite3.connect(path), {}),
    "descriptor": (lambda path: ModinDatabaseConnection("sqlite3", path), {}),
    "descriptor_index_col": (lambda path: ModinDatabaseConnection("sqlite3", path), {"index_col": "id"}),
    "descriptor_params": (lambda path: ModinDatabaseConnection("sqlite3", path), {"params": (10,)}),
}


@pytest.mark.parametrize("case", sorted(SQL_READS))
def test_read_sql_matches_jax_and_pandas(case, sqlite_db, defaults):
    path, _ = sqlite_db
    make_con, kwargs = SQL_READS[case]
    query = "SELECT * FROM items WHERE k < ?" if "params" in kwargs else "SELECT * FROM items"
    con = make_con(path)
    got = tpd.read_sql(query, con, **kwargs)
    assert tqc.DEFAULTS_TO_PANDAS == defaults
    _assert_on_device(got)
    ref = sqlite3.connect(path)
    want = pandas.read_sql(query, ref, **kwargs)
    jax_con = JaxConnection("sqlite3", path) if case != "plain_connection" else ref
    pandas.testing.assert_frame_equal(tpd.to_pandas(got), want)
    pandas.testing.assert_frame_equal(jax_to_pandas(mpd.read_sql(query, jax_con, **kwargs)), want)
    ref.close()
    if case == "plain_connection":
        con.close()


@pytest.mark.parametrize("descriptor", [False, True], ids=["connection", "descriptor"])
def test_read_sql_columns_null_in_the_first_rows(descriptor, tmp_path, defaults):
    # a float and a text column added late: NULL in the first 3000 of 5000
    # rows; pandas types them from the whole result
    rows, late = 5000, 3000
    rng = np.random.default_rng(12)
    v = rng.uniform(0, 1, rows).round(6)
    s = np.array(["a", "bb", "ccc"], dtype=object)[rng.integers(0, 3, rows)]
    path = str(tmp_path / "late.db")
    conn = sqlite3.connect(path)
    conn.execute("CREATE TABLE items (id INTEGER, v REAL, s TEXT)")
    conn.executemany("INSERT INTO items VALUES (?, ?, ?)",
                     [(i, None if i < late else float(v[i]), None if i < late else s[i]) for i in range(rows)])
    conn.commit()
    con = ModinDatabaseConnection("sqlite3", path) if descriptor else conn
    got = tpd.read_sql("SELECT * FROM items", con)
    assert tqc.DEFAULTS_TO_PANDAS == defaults
    want = pandas.read_sql("SELECT * FROM items", conn)
    assert want["v"].dtype == np.float64
    pandas.testing.assert_frame_equal(tpd.to_pandas(got), want)
    conn.close()


def test_read_sql_table_name_through_descriptor(sqlite_db):
    path, pdf = sqlite_db
    got = tpd.read_sql("items", ModinDatabaseConnection("sqlite3", path))
    pandas.testing.assert_frame_equal(tpd.to_pandas(got), pdf)
    pandas.testing.assert_frame_equal(
        jax_to_pandas(mpd.read_sql("items", JaxConnection("sqlite3", path))), pdf
    )


def test_read_sql_through_descriptor_raises_pandas_error(sqlite_db):
    path, _ = sqlite_db
    kwargs = {"parse_dates": {"s": {"format": "%Y-%m-%d"}}}
    with pytest.raises(ValueError) as want:
        pandas.read_sql("SELECT * FROM items", sqlite3.connect(path), **kwargs)
    with pytest.raises(ValueError) as got:
        tpd.read_sql("SELECT * FROM items", ModinDatabaseConnection("sqlite3", path), **kwargs)
    assert str(got.value) == str(want.value)


def test_read_sql_chunksize_returns_pandas_iterator(sqlite_db):
    path, pdf = sqlite_db
    chunks = list(tpd.read_sql("SELECT * FROM items", ModinDatabaseConnection("sqlite3", path),
                               chunksize=1000))
    assert len(chunks) == 5 and all(isinstance(c, pandas.DataFrame) for c in chunks)
    pandas.testing.assert_frame_equal(pandas.concat(chunks, ignore_index=True), pdf)


def test_partition_query_shape():
    con = ModinDatabaseConnection("sqlite3", ":memory:")
    q = con.partition_query("SELECT * FROM t", 10, 20)
    assert q == JaxConnection("sqlite3", ":memory:").partition_query("SELECT * FROM t", 10, 20)
    assert "LIMIT 10 OFFSET 20" in q
    assert con.supports_stable_offset_partitioning()
    assert con.row_count_query("SELECT 1") == JaxConnection("sqlite3", ":memory:").row_count_query("SELECT 1")


def test_unsupported_lib():
    with pytest.raises(UnsupportedDatabaseException):
        ModinDatabaseConnection("mongodb")


@pytest.mark.parametrize("descriptor", [False, True], ids=["connection", "descriptor"])
def test_to_sql_round_trip(descriptor, tmp_path, defaults):
    pdf, tdf = _written_frames(rows=400)
    path = str(tmp_path / "w.db")
    con = ModinDatabaseConnection("sqlite3", path) if descriptor else sqlite3.connect(path)
    tdf.to_sql("t", con, index=False)
    tdf["k"].to_sql("s", con)
    assert tqc.DEFAULTS_TO_PANDAS == defaults
    if not descriptor:
        con.close()
    ref = sqlite3.connect(str(tmp_path / "pandas.db"))
    pdf.to_sql("t", ref, index=False)
    pdf["k"].to_sql("s", ref)
    port = sqlite3.connect(path)
    for table in ("t", "s"):
        pandas.testing.assert_frame_equal(
            pandas.read_sql(f"SELECT * FROM {table}", port), pandas.read_sql(f"SELECT * FROM {table}", ref)
        )
    back = tpd.read_sql("SELECT * FROM t", port)
    pandas.testing.assert_frame_equal(tpd.to_pandas(back), pandas.read_sql("SELECT * FROM t", ref))
    port.close()
    ref.close()


# ---------------------------------------------------------------------- #
# Excel (no engine installed: the port's xlsx codec)
# ---------------------------------------------------------------------- #


@pytest.fixture
def no_excel_engine():
    from modin_tpu_torch.core.io.io import _no_excel_engine_installed

    if not _no_excel_engine_installed():
        pytest.skip("an Excel engine is installed: pandas reads and writes")


def _excel_frame(rows: int = 5, seed: int = 9) -> pandas.DataFrame:
    rng = np.random.default_rng(seed)
    f = rng.normal(size=rows).round(3)
    f[rows // 2] = np.nan
    return pandas.DataFrame({
        "i": rng.integers(-100, 100, rows),
        "f": f,
        "s": np.array(["a", "bb", "ccc"], dtype=object)[rng.integers(0, 3, rows)],
    })


def test_excel_round_trip_without_engine_matches_jax(tmp_path, no_excel_engine, defaults):
    # the repair: the port raised ModuleNotFoundError/ImportError here
    # while the JAX package wrote and read through its own codec
    df = _excel_frame()
    mpd.DataFrame(df).to_excel(str(tmp_path / "j.xlsx"), index=False)
    tpd.DataFrame(df).to_excel(str(tmp_path / "t.xlsx"), index=False)
    got = tpd.read_excel(str(tmp_path / "t.xlsx"))
    assert tqc.DEFAULTS_TO_PANDAS == defaults
    _assert_on_device(got)
    jax = jax_to_pandas(mpd.read_excel(str(tmp_path / "j.xlsx")))
    pandas.testing.assert_frame_equal(tpd.to_pandas(got), jax)
    pandas.testing.assert_frame_equal(tpd.to_pandas(got), df, check_dtype=False)
    assert [str(d) for d in tpd.to_pandas(got).dtypes] == ["int64", "float64", "str"]
    # each package reads the other's file alike
    pandas.testing.assert_frame_equal(tpd.to_pandas(tpd.read_excel(str(tmp_path / "j.xlsx"))), jax)
    pandas.testing.assert_frame_equal(jax_to_pandas(mpd.read_excel(str(tmp_path / "t.xlsx"))), jax)


EXCEL_READS = {
    "header_none": {"header": None},
    "skiprows": {"skiprows": 2},
    "skiprows_list": {"skiprows": [1, 3]},
    "nrows": {"nrows": 4},
    "usecols": {"usecols": [0, 2]},
    "index_col": {"index_col": 0},
    "names": {"names": ["w", "x", "y", "z"]},
    "dtype": {"dtype": {"i": "float64"}},
    "sheet_name_none": {"sheet_name": None},
    "sheet_name_list": {"sheet_name": ["Sheet1"]},
    "sheet_name_label": {"sheet_name": "Sheet1"},
}


@pytest.mark.parametrize("case", sorted(EXCEL_READS))
def test_read_excel_forms_match_jax(case, tmp_path, no_excel_engine, defaults):
    kwargs = EXCEL_READS[case]
    path = str(tmp_path / "d.xlsx")
    tpd.DataFrame(_excel_frame(rows=12)).to_excel(path, index=True)
    got = tpd.read_excel(path, **kwargs)
    want = mpd.read_excel(path, **kwargs)
    assert tqc.DEFAULTS_TO_PANDAS == defaults
    if isinstance(want, dict):
        assert list(got) == list(want)
        for key in want:
            pandas.testing.assert_frame_equal(tpd.to_pandas(got[key]), jax_to_pandas(want[key]))
    else:
        pandas.testing.assert_frame_equal(tpd.to_pandas(got), jax_to_pandas(want))


@pytest.mark.parametrize("kwargs", [{}, {"index": False}, {"header": False}, {"sheet_name": "data"}],
                         ids=["plain", "no_index", "no_header", "sheet_name"])
def test_series_to_excel_matches_jax(kwargs, tmp_path, no_excel_engine, defaults):
    s = pandas.Series(np.arange(7) * 1.5, name="v")
    tpd.Series(s).to_excel(str(tmp_path / "t.xlsx"), **kwargs)
    mpd.Series(s).to_excel(str(tmp_path / "j.xlsx"), **kwargs)
    assert tqc.DEFAULTS_TO_PANDAS == defaults
    sheet = kwargs.get("sheet_name", 0)
    pandas.testing.assert_frame_equal(
        tpd.to_pandas(tpd.read_excel(str(tmp_path / "t.xlsx"), sheet_name=sheet)),
        jax_to_pandas(mpd.read_excel(str(tmp_path / "j.xlsx"), sheet_name=sheet)),
    )


def test_excel_positional_writer_arguments(tmp_path, no_excel_engine):
    df = _excel_frame()
    tpd.DataFrame(df).to_excel(str(tmp_path / "t.xlsx"), sheet_name="data")
    with tpd.ExcelFile(str(tmp_path / "t.xlsx")) as book:
        assert book.sheet_names == ["data"]
        got = book.parse("data", index_col=0)
    assert isinstance(got, tpd.DataFrame)
    mpd.DataFrame(df).to_excel(str(tmp_path / "j.xlsx"), sheet_name="data")
    pandas.testing.assert_frame_equal(
        tpd.to_pandas(got), jax_to_pandas(mpd.read_excel(str(tmp_path / "j.xlsx"), "data", index_col=0))
    )


@pytest.mark.parametrize("call", ["read_converters", "read_engine", "write_na_rep", "parse_converters"])
def test_unsupported_excel_forms_raise_import_error(call, tmp_path, no_excel_engine):
    path = str(tmp_path / "d.xlsx")
    tpd.DataFrame(_excel_frame()).to_excel(path)
    calls = {
        "read_converters": lambda pd: pd.read_excel(path, converters={"i": str}),
        "read_engine": lambda pd: pd.read_excel(path, engine="openpyxl"),
        "write_na_rep": lambda pd: pd.DataFrame(_excel_frame()).to_excel(path, na_rep="-"),
        "parse_converters": lambda pd: tpd.ExcelFile(path).parse(0, converters={"i": str}),
    }
    with pytest.raises(ImportError):
        calls[call](tpd)
    if call != "parse_converters":
        with pytest.raises(ImportError):
            calls[call](mpd)
        with pytest.raises(ImportError):
            calls[call](pandas)


@pytest.mark.parametrize("content", [b"not a zip", b"PK\x03\x04 truncated"], ids=["text", "bad_zip"])
def test_read_excel_of_a_non_workbook_raises_like_jax(content, tmp_path, no_excel_engine):
    path = tmp_path / "x.xlsx"
    path.write_bytes(content)
    with pytest.raises(Exception) as jax:
        mpd.read_excel(str(path))
    with pytest.raises(type(jax.value)):
        tpd.read_excel(str(path))


# ---------------------------------------------------------------------- #
# HDF (PyTables is not installed here)
# ---------------------------------------------------------------------- #


@pytest.fixture
def no_pytables():
    from modin_tpu_torch.core.io.column_stores.hdf_dispatcher import _pytables_available

    if _pytables_available():
        pytest.skip("PyTables is installed: the error path is not reachable")


@pytest.mark.parametrize("obj", ["frame", "series"])
def test_to_hdf_without_pytables_raises_pandas_error(obj, tmp_path, no_pytables):
    pdf, tdf = _written_frames(rows=50)
    if obj == "series":
        pdf, tdf = pdf["k"], tdf["k"]
    with pytest.raises(ImportError) as want:
        pdf.to_hdf(tmp_path / "p.h5", key="k")
    with pytest.raises(ImportError) as got:
        tdf.to_hdf(str(tmp_path / "t.h5"), key="k")
    assert str(got.value) == str(want.value)


def test_read_hdf_without_pytables_raises_pandas_error(tmp_path, no_pytables):
    # pandas checks that the file exists before importing PyTables
    stub = tmp_path / "present.h5"
    stub.write_bytes(b"\x89HDF\r\n\x1a\n")
    with pytest.raises(ImportError) as want:
        pandas.read_hdf(stub, key="k")
    with pytest.raises(ImportError) as got:
        tpd.read_hdf(str(stub), key="k")
    with pytest.raises(ImportError):
        mpd.read_hdf(str(stub), key="k")
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------- #
# the IO layer's bindings
# ---------------------------------------------------------------------- #


def test_io_class_binds_the_dispatchers():
    from modin_tpu_torch.core.execution.torch_engine import io as engine_io
    from modin_tpu_torch.core.io.io import BaseIO

    io_cls = engine_io.CudaOnTorchIO
    for name in ("read_json", "read_fwf", "read_sql", "read_hdf", "to_json", "to_sql", "to_hdf"):
        assert getattr(io_cls, name).__func__ is not getattr(BaseIO, name).__func__, name
        assert getattr(io_cls, name).__qualname__.startswith("CudaOnTorchIO."), name
    for name in ("read_excel", "to_excel"):
        assert "native_fallback" in getattr(io_cls, name).__func__.__name__, name


def test_json_buffer_reads_serially(defaults):
    text = pandas.DataFrame(_frame_data(rows=30)).to_json(orient="records", lines=True)
    got = tpd.read_json(io.StringIO(text), lines=True)
    assert tqc.DEFAULTS_TO_PANDAS == defaults
    pandas.testing.assert_frame_equal(tpd.to_pandas(got), pandas.read_json(io.StringIO(text), lines=True))
