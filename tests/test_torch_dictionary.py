"""Dictionary-coded string columns of the torch port against the JAX package.

The scenarios of ``tests/test_dictionary_encoding.py`` that the port runs on
its device (string keys of groupby, merge and sort, isin, nunique, mode,
value_counts, unique, min/max/count, comparisons with a string, and the
``.str`` predicates and measures) go through ``modin_tpu.pandas`` (TpuOnJax
on the CPU mesh), ``modin_tpu_torch.pandas`` (torch on the CPU) and pandas,
from the same seeded numpy data.  Both packages must give pandas' answer:
strings, ints and labels exactly, floats to ``rtol=1e-12``.  The port's
device paths leave ``DEFAULTS_TO_PANDAS`` where it was; the queries it
declines count one default each.  The units of ``ops/dictionary.py`` are
held against the JAX package's on the same inputs.
"""

import threading

import numpy as np
import pandas
import pytest
import torch

import modin_tpu.pandas as mpd
from modin_tpu.core.dataframe.tpu.dataframe import HostColumn as JaxHostColumn
from modin_tpu.ops import dictionary as jax_dictionary
from modin_tpu.utils import to_pandas as jax_to_pandas

import modin_tpu_torch
import modin_tpu_torch.pandas as tpd
from modin_tpu_torch.core.dataframe.torch.dataframe import HostColumn
from modin_tpu_torch.core.storage_formats.torch import query_compiler as tqc
from modin_tpu_torch.ops import dictionary

FLOAT_RTOL = 1e-12
_CITIES = np.array(["tokyo", "oslo", "lima", "cairo", "perth", "quito", "dakar"], dtype=object)


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


def _str_frame(n=1500, nan_frac=0.0, seed=0):
    rng = np.random.default_rng(seed)
    key = _CITIES[rng.integers(0, len(_CITIES), n)].copy()
    if nan_frac:
        key[rng.random(n) < nan_frac] = np.nan
    return {"city": key, "v": rng.normal(size=n), "w": rng.integers(0, 9, n)}


def _assert_equal(got, want):
    if isinstance(want, pandas.DataFrame):
        pandas.testing.assert_frame_equal(got, want, rtol=FLOAT_RTOL)
    elif isinstance(want, pandas.Series):
        pandas.testing.assert_series_equal(got, want, rtol=FLOAT_RTOL)
    else:
        assert type(got) is type(want), (type(got), type(want))
        assert [str(x) for x in got] == [str(x) for x in want]


def _three(fn, *datas, defaults=0, jax_agrees=True):
    """``fn`` on pandas, the JAX package and the port, from the same data;
    both packages must give pandas' answer, and the port must count
    ``defaults`` defaults to pandas."""
    want = fn(pandas, *[pandas.DataFrame(d) for d in datas])
    before = tqc.DEFAULTS_TO_PANDAS
    got = fn(tpd, *[tpd.DataFrame(d) for d in datas])
    assert tqc.DEFAULTS_TO_PANDAS - before == defaults
    _assert_equal(tpd.to_pandas(got), want)
    if jax_agrees:
        from_jax = fn(mpd, *[mpd.DataFrame(d) for d in datas])
        _assert_equal(jax_to_pandas(from_jax) if hasattr(from_jax, "_query_compiler") else from_jax, want)


# ---------------------------------------------------------------------- #
# groupby on string keys and string values
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("agg", ["sum", "mean", "count", "size", "min", "max"])
def test_str_key_aggs_device(agg):
    _three(lambda pd, df: getattr(df.groupby("city"), agg)(), _str_frame())


def test_str_key_selection():
    _three(lambda pd, df: df.groupby("city")["v"].mean(), _str_frame())


@pytest.mark.parametrize("dropna", [True, False])
def test_nan_keys(dropna):
    _three(lambda pd, df: df.groupby("city", dropna=dropna).sum(), _str_frame(nan_frac=0.1))


def test_multi_key_str_plus_int():
    _three(lambda pd, df: df.groupby(["city", "w"])["v"].sum(), _str_frame())


def test_by_external_str_series():
    _three(lambda pd, df: df["v"].groupby(df["city"]).sum(), _str_frame())


def test_frame_by_external_str_series():
    _three(lambda pd, df: df[["v", "w"]].groupby(df["city"]).max(), _str_frame())


@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
def test_as_index_false(agg):
    _three(lambda pd, df: getattr(df.groupby("city", as_index=False), agg)(), _str_frame())


def test_as_index_false_two_keys_selection():
    _three(
        lambda pd, df: df.groupby(["city", "w"], as_index=False)[["v"]].mean(),
        _str_frame(nan_frac=0.05),
    )


def test_mixed_object_key():
    # pandas' factorize orders numbers before strings, as its groupby does
    data = {"k": np.array([1, "a", 2.5, "a", 1] * 20, dtype=object), "v": np.arange(100.0)}
    _three(lambda pd, df: df.groupby("k")["v"].sum(), data)


def test_categorical_key():
    rng = np.random.default_rng(4)
    data = {
        "c": pandas.Categorical(_CITIES[rng.integers(0, 5, 600)], categories=list(_CITIES[:5])),
        "v": rng.normal(size=600),
    }
    _three(lambda pd, df: df.groupby("c").sum(), data)


def test_encoding_cached_across_aggs():
    tdf = tpd.DataFrame(_str_frame())
    col = tdf._query_compiler._modin_frame.get_column(0)
    before = tqc.DEFAULTS_TO_PANDAS
    tdf.groupby("city").sum()
    first = col._dict_cache
    assert first not in (None, False)
    tdf.groupby("city").mean()
    assert col._dict_cache is first  # the same encoding: no second factorize
    assert tqc.DEFAULTS_TO_PANDAS == before


def _value_frame():
    rng = np.random.default_rng(23)
    n = 900
    vals = _CITIES[rng.integers(0, 4, n)].copy()
    vals[rng.random(n) < 0.1] = np.nan
    return {"k": rng.integers(0, 7, n), "s": vals, "v": rng.normal(size=n)}


@pytest.mark.parametrize("agg", ["min", "max", "count"])
def test_groupby_str_values(agg):
    _three(lambda pd, df: getattr(df.groupby("k"), agg)(), _value_frame())


def test_groupby_str_key_and_values():
    _three(lambda pd, df: df.groupby("s").max(), _value_frame())


# ---------------------------------------------------------------------- #
# merge on string keys, with string payloads
# ---------------------------------------------------------------------- #


def _right_frame():
    rng = np.random.default_rng(2)
    return {"city": _CITIES[rng.integers(1, 7, 900)], "z": rng.normal(size=900)}


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
def test_str_key_merge_device(how):
    _three(
        lambda pd, left, right: left.merge(right, on="city", how=how),
        _str_frame(n=1200, seed=1), _right_frame(),
    )


@pytest.mark.parametrize("how", ["inner", "left", "outer"])
def test_nan_keys_match_like_pandas(how):
    right = _str_frame(n=700, nan_frac=0.1, seed=4)
    _three(
        lambda pd, left, right: left.merge(right, on="city", how=how),
        _str_frame(n=800, nan_frac=0.1, seed=3), {"city": right["city"], "z": right["v"]},
    )


def test_two_str_keys():
    rng = np.random.default_rng(5)
    left = {
        "city": _CITIES[rng.integers(0, 6, 1000)],
        "tag": np.array(["x", "y"], dtype=object)[rng.integers(0, 2, 1000)],
        "v": rng.normal(size=1000),
    }
    right = {
        "city": _CITIES[rng.integers(1, 7, 800)],
        "tag": np.array(["x", "y", "z"], dtype=object)[rng.integers(0, 3, 800)],
        "w": rng.integers(0, 5, 800),
    }
    _three(lambda pd, a, b: a.merge(b, on=["city", "tag"]), left, right)


def test_str_and_int_keys():
    rng = np.random.default_rng(9)
    left = {"city": _CITIES[rng.integers(0, 4, 600)], "w": rng.integers(0, 3, 600), "v": rng.normal(size=600)}
    right = {"city": _CITIES[rng.integers(0, 5, 300)], "w": rng.integers(0, 3, 300), "z": rng.integers(0, 9, 300)}
    for how in ("inner", "left", "outer"):
        _three(lambda pd, a, b: a.merge(b, on=["city", "w"], how=how), left, right)


def test_left_on_right_on_str():
    rng = np.random.default_rng(6)
    left = {"a_city": _CITIES[rng.integers(0, 6, 500)], "v": rng.normal(size=500)}
    right = {"b_city": _CITIES[rng.integers(1, 7, 400)], "w": rng.integers(0, 5, 400)}
    _three(lambda pd, a, b: a.merge(b, left_on="a_city", right_on="b_city"), left, right)


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
def test_str_payload_columns_gather_on_host(how):
    rng = np.random.default_rng(8)
    left = _str_frame(n=600, seed=8)
    left["note"] = np.array(["a", "bb", "ccc"], dtype=object)[rng.integers(0, 3, 600)]
    right = {
        "city": _CITIES[rng.integers(0, 7, 500)],
        "z": rng.normal(size=500),
        "label": np.array(["p", "q"], dtype=object)[rng.integers(0, 2, 500)],
    }
    _three(lambda pd, a, b: a.merge(b, on="city", how=how), left, right)


def test_mixed_numeric_and_str_key_dtypes_fall_back_correct():
    left = {"k": _CITIES[np.random.default_rng(1).integers(0, 3, 50)]}
    right = {"k": np.arange(50)}
    with pytest.raises(ValueError):
        pandas.DataFrame(left).merge(pandas.DataFrame(right), on="k")
    before = tqc.DEFAULTS_TO_PANDAS
    with pytest.raises(ValueError):
        tpd.DataFrame(left).merge(tpd.DataFrame(right), on="k")
    assert tqc.DEFAULTS_TO_PANDAS == before + 1


# ---------------------------------------------------------------------- #
# sort by string keys
# ---------------------------------------------------------------------- #


def _sort_frame():
    rng = np.random.default_rng(11)
    n = 800
    return {
        "city": _CITIES[rng.integers(0, 6, n)],
        "v": rng.normal(size=n),
        "w": rng.integers(0, 50, n),
        "note": np.array(["a", "bb", "ccc"], dtype=object)[rng.integers(0, 3, n)],
    }


SORTS = {
    "by_str": lambda df: df.sort_values("city", kind="stable"),
    "by_str_descending": lambda df: df.sort_values("city", ascending=False, kind="stable"),
    "str_then_numeric": lambda df: df.sort_values(["city", "w"], kind="stable"),
    "numeric_then_str_mixed_order": lambda df: df.sort_values(["w", "city"], ascending=[False, True]),
    "numeric_with_str_payload": lambda df: df.sort_values("v"),
    "ignore_index": lambda df: df.sort_values("city", kind="stable", ignore_index=True),
}


@pytest.mark.parametrize("name", sorted(SORTS))
def test_sort_by_str(name):
    _three(lambda pd, df: SORTS[name](df), _sort_frame())


@pytest.mark.parametrize("na_position", ["last", "first"])
def test_sort_str_nan(na_position):
    rng = np.random.default_rng(12)
    k = _CITIES[rng.integers(0, 4, 400)].copy()
    k[rng.random(400) < 0.1] = np.nan
    _three(
        lambda pd, df: df.sort_values("city", kind="stable", na_position=na_position),
        {"city": k, "v": rng.normal(size=400)},
    )


# ---------------------------------------------------------------------- #
# value_counts, nunique, mode, unique, isin
# ---------------------------------------------------------------------- #


def _counts_frame():
    rng = np.random.default_rng(13)
    n = 900
    k = _CITIES[rng.integers(0, 4, n)].copy()
    k[rng.random(n) < 0.06] = np.nan
    return {"city": k, "v": rng.normal(size=n), "w": rng.integers(0, 9, n)}


@pytest.mark.parametrize(
    "kw",
    [{}, {"normalize": True}, {"dropna": False}, {"ascending": True}, {"sort": False}],
    ids=["default", "normalize", "keep_nan", "ascending", "unsorted"],
)
def test_value_counts_str(kw):
    _three(lambda pd, df: df["city"].value_counts(**kw), _counts_frame())


def test_value_counts_int():
    _three(lambda pd, df: df["w"].value_counts(), _counts_frame())


@pytest.mark.parametrize("dropna", [True, False])
def test_nunique_mixed_frame(dropna):
    _three(lambda pd, df: df.nunique(dropna=dropna), _counts_frame())


@pytest.mark.parametrize("dropna", [True, False])
def test_mode_str_frame(dropna):
    _three(lambda pd, df: df[["city", "w"]].mode(dropna=dropna), _counts_frame())


def test_isin_mixed_values_frame():
    _three(lambda pd, df: df.isin(["tokyo", "lima", 3]), _counts_frame())


@pytest.mark.parametrize("vals", [["oslo"], ["oslo", np.nan], ["zzz"]], ids=["one", "with_nan", "absent"])
def test_isin_series_variants(vals):
    _three(lambda pd, df: df["city"].isin(vals), _counts_frame())


@pytest.mark.parametrize("vals", [[np.nan], [None], ["a", np.nan]], ids=["nan", "none", "a_nan"])
def test_object_none_vs_nan_distinct(vals):
    # object dtype keeps None and NaN apart in isin; both encode to a NaN
    # code, so the port leaves that case to pandas
    data = {"s": pandas.Series(np.array(["a", np.nan, None, "b"], dtype=object), dtype=object)}
    want = pandas.DataFrame(data)["s"].isin(vals)
    before = tqc.DEFAULTS_TO_PANDAS
    got = tpd.to_pandas(tpd.DataFrame(data)["s"].isin(vals))
    assert tqc.DEFAULTS_TO_PANDAS == before + 1
    _assert_equal(got, want)
    _assert_equal(jax_to_pandas(mpd.DataFrame(data)["s"].isin(vals)), want)


@pytest.mark.parametrize(
    "vals,defaults", [([np.nan], 0), ([None], 1), (["a", np.nan], 0)], ids=["nan", "none", "a_nan"]
)
def test_str_dtype_missing_unified_device(vals, defaults):
    # the str dtype unifies None and NaN: a NaN in the list matches the
    # missing rows on the device; a None in the list is not a literal the
    # device path takes (nor does the JAX package's)
    data = {"s": pandas.Series(["a", np.nan, None, "b"], dtype="str")}
    _three(lambda pd, df: df["s"].isin(vals), data, defaults=defaults)


def test_unique_appearance_order():
    vals = np.array(["oslo", "tokyo", "lima", "oslo", np.nan, "cairo", "tokyo"], dtype=object)
    want = pandas.Series(vals).unique()
    before = tqc.DEFAULTS_TO_PANDAS
    got = tpd.Series(vals).unique()
    assert tqc.DEFAULTS_TO_PANDAS == before
    _assert_equal(got, want)
    assert [str(x) for x in mpd.Series(vals).unique()] == [str(x) for x in want]


# ---------------------------------------------------------------------- #
# reductions of string columns
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("op", ["min", "max", "count"])
def test_frame_reduce_mixed(op):
    _three(lambda pd, df: getattr(df, op)(), _value_frame())


@pytest.mark.parametrize("op", ["min", "max"])
def test_frame_reduce_strings_only(op):
    _three(lambda pd, df: getattr(df[["s"]], op)(), _value_frame())


def test_sum_with_str_falls_back_correct():
    _three(lambda pd, df: df.sum(), _value_frame(), defaults=1)


# ---------------------------------------------------------------------- #
# comparisons with a string, and the .str lookup tables
# ---------------------------------------------------------------------- #


def _compare_data():
    rng = np.random.default_rng(33)
    vals = np.array(["berlin", "lima", "oslo", "tokyo"], dtype=object)[rng.integers(0, 4, 800)].copy()
    vals[rng.random(800) < 0.07] = np.nan
    return {"s": vals, "v": rng.normal(size=800)}


COMPARISONS = {
    "eq": lambda s: s == "oslo",
    "eq_absent": lambda s: s == "zzz",
    "ne": lambda s: s != "oslo",
    "ne_absent": lambda s: s != "zzz",
    "lt_between": lambda s: s < "m",
    "le_present": lambda s: s <= "lima",
    "gt_present": lambda s: s > "lima",
    "ge_between": lambda s: s >= "m",
}


@pytest.mark.parametrize("name", sorted(COMPARISONS))
def test_compare_with_string(name):
    _three(lambda pd, df: COMPARISONS[name](df["s"]), _compare_data())


def test_filter_chain():
    _three(lambda pd, df: df[df["s"] == "tokyo"], _compare_data())


def test_na_string_comparisons_keep_extension_dtype():
    # the NA-backed 'string' dtype answers in a boolean extension array
    data = {"s": pandas.Series(["a", pandas.NA, "b"], dtype="string")}
    for fn in (lambda s: s == "a", lambda s: s != "a", lambda s: s < "b"):
        _three(lambda pd, df: fn(df["s"]), data, defaults=1)


STR_METHODS = {
    "len": ((), {}),
    "count": (("o",), {}),
    "contains": (("o",), {}),
    "startswith": (("l",), {}),
    "endswith": (("o",), {}),
    "match": (("[bl]",), {}),
    "fullmatch": (("lima",), {}),
    "find": (("i",), {}),
    "rfind": (("o",), {}),
    "isalnum": ((), {}),
    "isalpha": ((), {}),
    "isdigit": ((), {}),
    "isspace": ((), {}),
    "islower": ((), {}),
    "isupper": ((), {}),
    "istitle": ((), {}),
    "isnumeric": ((), {}),
    "isdecimal": ((), {}),
}


@pytest.mark.parametrize("name", sorted(STR_METHODS))
@pytest.mark.parametrize("dtype", ["str", "object"])
def test_str_lookup_table(name, dtype):
    args, kwargs = STR_METHODS[name]
    data = _compare_data()
    data["s"] = pandas.Series(data["s"], dtype=dtype)
    # an object column's predicates give NaN at missing rows (an object
    # result): pandas keeps those; its measures are float64 with NaN
    measure = name in ("len", "count", "find", "rfind")
    defaults = 1 if dtype == "object" and not measure else 0
    _three(lambda pd, df: getattr(df["s"].str, name)(*args, **kwargs), data, defaults=defaults)


def test_str_output_method_defaults():
    _three(lambda pd, df: df["s"].str.upper(), _compare_data(), defaults=1)


# ---------------------------------------------------------------------- #
# units of ops/dictionary.py against the JAX package's
# ---------------------------------------------------------------------- #


def _seeded_strings(n=500, seed=3, nan_frac=0.1):
    rng = np.random.default_rng(seed)
    vals = np.array(["b", "a", "c", "dd", "aa", "é", "Z"], dtype=object)[rng.integers(0, 7, n)].copy()
    vals[rng.random(n) < nan_frac] = np.nan
    return vals


@pytest.mark.parametrize("dtype", ["object", "str"])
@pytest.mark.parametrize("nan_frac", [0.0, 0.1])
def test_encode_host_column_matches_jax(dtype, nan_frac):
    arr = pandas.Series(_seeded_strings(nan_frac=nan_frac), dtype=dtype).array
    if dtype == "object":
        arr = np.asarray(arr)
    mine = dictionary.encode_host_column(HostColumn(arr))
    theirs = jax_dictionary.encode_host_column(JaxHostColumn(arr))
    assert list(mine.categories) == list(theirs.categories)
    assert mine.has_nan == theirs.has_nan == (nan_frac > 0)
    got = mine.codes.data.numpy()
    want = np.asarray(theirs.codes.data)[: len(arr)]
    np.testing.assert_array_equal(got, want)
    assert mine.codes.pandas_dtype == np.dtype(np.float64)


def test_codes_order_isomorphic():
    enc = dictionary.encode_host_column(HostColumn(np.array(["b", "a", "c", "a"], dtype=object)))
    assert list(enc.categories) == ["a", "b", "c"]
    assert enc.has_nan is False
    assert enc.codes.data.tolist() == [1.0, 0.0, 2.0, 0.0]


def test_non_string_column_not_encoded():
    col = HostColumn(pandas.array([1, 2, None], dtype="Int64"))
    assert dictionary.encode_host_column(col) is None
    assert col._dict_cache is False  # the refusal is cached too


def test_union_categories_matches_jax():
    rng = np.random.default_rng(7)
    pool = np.array(["a", "b", "c", "d", "e", "f", "g"], dtype=object)
    left = np.unique(pool[rng.integers(0, 7, 5)])
    right = np.unique(pool[rng.integers(0, 7, 5)])
    for mine, theirs in zip(
        dictionary.union_categories(left, right), jax_dictionary.union_categories(left, right)
    ):
        assert mine.dtype == theirs.dtype
        np.testing.assert_array_equal(mine, theirs)
    u, lm, rm = dictionary.union_categories(
        np.array(["a", "c"], dtype=object), np.array(["b", "c"], dtype=object)
    )
    assert list(u) == ["a", "b", "c"] and lm.tolist() == [0.0, 2.0] and rm.tolist() == [1.0, 2.0]


def test_remap_codes_device_matches_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    codes = rng.integers(-2, 9, 400).astype(np.float64)  # beyond the table both ways
    codes[rng.random(400) < 0.1] = np.nan
    table = np.sort(rng.choice(20, 6, replace=False)).astype(np.float64)
    got = dictionary.remap_codes_device(torch.as_tensor(codes), table).numpy()
    want = np.asarray(jax_dictionary.remap_codes_device(jnp.asarray(codes), table))
    np.testing.assert_array_equal(got, want)


def test_lookup_and_decode_match_jax():
    cats = np.array(["a", "b", "c"], dtype=object)
    values = ["c", "zz", 3, "a", None]
    np.testing.assert_array_equal(
        dictionary.lookup_values(values, cats), jax_dictionary.lookup_values(values, cats)
    )
    codes = np.array([2.0, np.nan, 0.0, 1.0])
    assert [str(x) for x in dictionary.decode_codes(codes, cats)] == [
        str(x) for x in jax_dictionary.decode_codes(codes, cats)
    ]
    assert [str(x) for x in dictionary.decode_codes(codes, cats[:0])] == ["nan"] * 4
