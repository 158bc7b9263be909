"""The interchange producer and ``to_numpy`` of the torch port.

The port's producer (``core/dataframe/torch/interchange/``) is held against
pandas' own producer and the JAX package's, through pandas'
``from_dataframe`` on inputs made from a seed with numpy: a round trip,
zero copy over a column's host cache, one fetch per requested computed
column (``COLUMN_FETCHES``), column selections, chunks, and the port's
consumer ``pd.api.interchange.from_dataframe``.  ``to_numpy`` is held to
pandas' values and dtype over mixed dtypes, NaN and the ``dtype``/
``na_value``/``copy`` forms; a frame of device columns comes over in one
device-to-host copy.
"""

import threading
import warnings

import numpy as np
import pandas
import pytest
from pandas.api.interchange import from_dataframe

import modin_tpu.pandas as mpd

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch.core.dataframe.torch.interchange import dataframe as xchg
from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
from modin_tpu_torch.parallel.engine import TorchWrapper

N = 500


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


@pytest.fixture(autouse=True)
def _quiet_protocol_deprecation():
    # pandas 3 deprecates the protocol; its warning is not under test
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        warnings.simplefilter("ignore", FutureWarning)
        yield


def _data(seed: int = 21) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "f": np.where(rng.random(N) < 0.1, np.nan, rng.normal(size=N)),
        "i": rng.integers(-100, 100, N),
        "u": rng.integers(0, 100, N).astype(np.uint32),
        "b": rng.random(N) < 0.5,
        "dt": np.datetime64("2024-01-01", "ns") + rng.integers(0, 10**9, N).astype("timedelta64[ns]"),
        "s": np.array([f"name_{i % 7}" for i in range(N)]),
    }


@pytest.fixture
def frames():
    data = _data()
    return tpd.DataFrame(data), pandas.DataFrame(data)


def _computed(n_cols: int = 10, seed: int = 5):
    """A port frame of computed (deferred) columns, and pandas' twin."""
    rng = np.random.default_rng(seed)
    data = {f"c{i}": rng.normal(size=N) for i in range(n_cols)}
    t, p = tpd.DataFrame(data), pandas.DataFrame(data)
    return t * 2.0 + 1.0, p * 2.0 + 1.0


def test_round_trip_matches_pandas_and_jax_producers(frames):
    tdf, pdf = frames
    producer = tdf.__dataframe__()
    assert isinstance(producer, xchg.TorchDataFrameXchg)
    want = from_dataframe(pdf.__dataframe__())
    pandas.testing.assert_frame_equal(from_dataframe(producer), want)
    pandas.testing.assert_frame_equal(from_dataframe(mpd.DataFrame(_data()).__dataframe__()), want)


def test_zero_copy_over_host_cache(frames):
    tdf, _ = frames
    fetches = xchg.COLUMN_FETCHES
    buf, _dtype = tdf.__dataframe__().get_column_by_name("i").get_buffers()["data"]
    cache = tdf._query_compiler._modin_frame.get_column(1).host_cache
    assert buf.ptr == cache.__array_interface__["data"][0]
    assert buf.__dlpack_device__() == (1, 0)
    assert xchg.COLUMN_FETCHES == fetches


def test_no_full_frame_materialization(frames, monkeypatch):
    tdf, _ = frames
    frame_cls = type(tdf._query_compiler._modin_frame)
    called = []
    monkeypatch.setattr(frame_cls, "to_pandas", lambda self: called.append(1))
    tdf.__dataframe__().get_column_by_name("f").get_buffers()
    assert called == []


def test_computed_column_fetched_once(monkeypatch):
    tdf, pdf = _computed(n_cols=3)
    fetches = xchg.COLUMN_FETCHES
    producer = tdf.__dataframe__()
    for _ in range(3):
        col = producer.get_column_by_name("c1")
        col.get_buffers()
        assert col.null_count == 0
    assert xchg.COLUMN_FETCHES == fetches + 1
    got = from_dataframe(producer)
    assert xchg.COLUMN_FETCHES == fetches + 3
    pandas.testing.assert_frame_equal(got, pdf)


@pytest.mark.parametrize("by", ["position", "name"])
def test_select_two_of_ten_computed_columns_fetches_two(by):
    tdf, pdf = _computed(n_cols=10)
    fetches = xchg.COLUMN_FETCHES
    defaults = tqc.DEFAULTS_TO_PANDAS
    producer = tdf.__dataframe__()
    sub = producer.select_columns([2, 7]) if by == "position" else producer.select_columns_by_name(["c2", "c7"])
    got = from_dataframe(sub)
    assert xchg.COLUMN_FETCHES == fetches + 2
    assert tqc.DEFAULTS_TO_PANDAS == defaults
    pandas.testing.assert_frame_equal(got, from_dataframe(pdf[["c2", "c7"]].__dataframe__()))
    # the selection shares the producer's fetched columns
    producer.get_column_by_name("c7").get_buffers()
    assert xchg.COLUMN_FETCHES == fetches + 2


def test_select_mixed_columns_matches_pandas(frames):
    tdf, pdf = frames
    got = from_dataframe(tdf.__dataframe__().select_columns_by_name(["i", "b", "s", "dt"]))
    want = from_dataframe(pdf[["i", "b", "s", "dt"]].__dataframe__())
    pandas.testing.assert_frame_equal(got, want)


@pytest.mark.parametrize("n_chunks", [1, 3, 7])
def test_chunks_cover_the_frame(frames, n_chunks):
    tdf, pdf = frames
    chunks = list(tdf.__dataframe__().get_chunks(n_chunks))
    assert len(chunks) == n_chunks
    assert sum(c.num_rows() for c in chunks) == N
    parts = [from_dataframe(c.select_columns_by_name(["f", "i"])) for c in chunks]
    got = pandas.concat(parts)
    pandas.testing.assert_frame_equal(got, pdf[["f", "i"]])


def test_protocol_metadata(frames):
    tdf, pdf = frames
    producer = tdf.__dataframe__()
    want = pdf.__dataframe__()
    assert producer.num_columns() == want.num_columns()
    assert producer.num_rows() == want.num_rows()
    assert producer.column_names() == list(want.column_names())
    for name in ("f", "i", "b", "dt"):
        got_col, want_col = producer.get_column_by_name(name), want.get_column_by_name(name)
        assert got_col.dtype == want_col.dtype, name
        assert got_col.null_count == want_col.null_count, name
        assert got_col.size() == want_col.size()


def test_consumer_from_dataframe(frames):
    _, pdf = frames
    defaults = tqc.DEFAULTS_TO_PANDAS
    got = tpd.api.interchange.from_dataframe(pdf.__dataframe__())
    assert isinstance(got, tpd.DataFrame)
    want = from_dataframe(pdf.__dataframe__())
    pandas.testing.assert_frame_equal(tpd.to_pandas(got), want)
    pandas.testing.assert_frame_equal(
        mpd.api.interchange.from_dataframe(pdf.__dataframe__()).modin.to_pandas(), want
    )
    # a frame with __dataframe__ (the port's own) is taken directly
    again = tpd.api.interchange.from_dataframe(got)
    pandas.testing.assert_frame_equal(tpd.to_pandas(again), want)
    assert tqc.DEFAULTS_TO_PANDAS == defaults


# ---------------------------------------------------------------------- #
# to_numpy
# ---------------------------------------------------------------------- #


def _assert_same_array(got: np.ndarray, want: np.ndarray, what: str = "") -> None:
    """Equal dtype, shape and values, NaN and NaT in the same places."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if want.dtype == object:
        missing = pandas.isna(want)
        assert (pandas.isna(got) == missing).all(), what
        assert (got[~missing] == want[~missing]).all(), what
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _numpy_frames():
    rng = np.random.default_rng(12)
    n = 300
    f = rng.normal(size=n)
    f[::7] = np.nan
    cols = {
        "i64": rng.integers(-(2**62), 2**62, n),
        "i8": rng.integers(-100, 100, n).astype(np.int8),
        "u8": rng.integers(0, 255, n).astype(np.uint8),
        "i32": rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32),
        "f64": f,
        "f32": rng.normal(size=n).astype(np.float32),
        "b": rng.random(n) < 0.5,
        "dt": np.datetime64("2020-01-01", "ns") + rng.integers(0, 10**12, n).astype("timedelta64[ns]"),
        "s": np.array(["x", "y"], dtype=object)[rng.integers(0, 2, n)],
        "u32": rng.integers(0, 2**32 - 1, n).astype(np.uint32),
    }
    return cols


# each case: its columns, and whether the device stacks it
TO_NUMPY_CASES = {
    "int64": (["i64"], True),
    "float_nan": (["f64"], True),
    "int_float": (["i64", "f64"], True),
    "int8_uint8": (["i8", "u8"], True),
    "int32_float32": (["i32", "f32"], True),
    "float32": (["f32"], True),
    "bool": (["b"], True),
    "bool_int": (["b", "i64"], False),  # pandas: object
    "bool_float": (["b", "f64"], False),
    "datetime": (["dt"], False),
    "datetime_int": (["dt", "i64"], False),
    "strings": (["s", "i64"], False),
    "uint32": (["u32", "i8"], False),  # a host column
}


@pytest.mark.parametrize("case", sorted(TO_NUMPY_CASES))
def test_to_numpy_matches_pandas(case, monkeypatch):
    names, stacked = TO_NUMPY_CASES[case]
    data = {k: v for k, v in _numpy_frames().items() if k in names}
    tdf, pdf = tpd.DataFrame(data), pandas.DataFrame(data)
    fetches = []
    materialize = TorchWrapper.materialize.__func__

    def counting(cls, obj):
        fetches.append(getattr(obj, "shape", None))
        return materialize(cls, obj)

    monkeypatch.setattr(TorchWrapper, "materialize", classmethod(counting))
    defaults = tqc.DEFAULTS_TO_PANDAS
    got = tdf.to_numpy()
    want = pdf.to_numpy()
    _assert_same_array(got, want)
    assert tqc.DEFAULTS_TO_PANDAS == defaults
    # the stacked frame comes over in one copy; the others from host caches
    assert fetches == ([(len(pdf), len(names))] if stacked else [])
    _assert_same_array(mpd.DataFrame(data).to_numpy(), want, "jax")


def test_to_numpy_of_computed_columns_one_copy(monkeypatch):
    rng = np.random.default_rng(3)
    data = {"a": rng.integers(0, 100, N), "b": rng.normal(size=N), "c": rng.integers(-5, 5, N)}
    tdf, pdf = tpd.DataFrame(data), pandas.DataFrame(data)
    tdf["d"], pdf["d"] = tdf["a"] * tdf["c"], pdf["a"] * pdf["c"]
    tdf, pdf = tdf[tdf["b"] > 0], pdf[pdf["b"] > 0]
    tdf = tdf * 2 + 1
    pdf = pdf * 2 + 1
    frame = tdf._query_compiler._modin_frame
    assert all(c.is_device and c.host_cache is None for c in frame._columns)
    fetches = []
    materialize = TorchWrapper.materialize.__func__

    def counting(cls, obj):
        fetches.append(getattr(obj, "shape", None))
        return materialize(cls, obj)

    monkeypatch.setattr(TorchWrapper, "materialize", classmethod(counting))
    defaults = tqc.DEFAULTS_TO_PANDAS
    got = tdf.to_numpy()
    assert fetches == [(len(pdf), 4)]
    assert tqc.DEFAULTS_TO_PANDAS == defaults
    want = pdf.to_numpy()
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    # a Series and .values take the same path
    np.testing.assert_array_equal(tdf["d"].to_numpy(), pdf["d"].to_numpy())
    np.testing.assert_array_equal(tdf.values, pdf.values)


TO_NUMPY_FORMS = {
    "dtype_float32": {"dtype": np.float32},
    "dtype_object": {"dtype": object},
    "na_value": {"na_value": -1.0},
    "copy": {"copy": True},
    "dtype_and_na_value": {"dtype": "float64", "na_value": 0.0},
}


@pytest.mark.parametrize("form", sorted(TO_NUMPY_FORMS))
@pytest.mark.parametrize("columns", [["i64", "f64"], ["b", "i64"]], ids=["int_float", "bool_int"])
def test_to_numpy_forms_match_pandas(form, columns):
    kwargs = TO_NUMPY_FORMS[form]
    data = {k: v for k, v in _numpy_frames().items() if k in columns}
    tdf, pdf = tpd.DataFrame(data), pandas.DataFrame(data)
    if columns == ["b", "i64"] and "na_value" in kwargs:
        kwargs = {**kwargs, "dtype": "float64"}
    _assert_same_array(tdf.to_numpy(**kwargs), pdf.to_numpy(**kwargs))
    for name in columns:
        _assert_same_array(tdf[name].to_numpy(**kwargs), pdf[name].to_numpy(**kwargs), name)
