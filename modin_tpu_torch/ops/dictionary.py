"""Dictionary encoding: device codes for host string/object columns.

The port's counterpart of ``modin_tpu/ops/dictionary.py``.  The device holds
no strings.  A host string or object column becomes device-computable for
equality- and order-shaped operations (groupby, merge and sort keys, isin,
nunique, value_counts, min/max, comparisons with a string) through a lazy,
cached factorization:

- ``categories``: the column's distinct values, **sorted**, on the host;
- ``codes``: each row's position in ``categories``, a float64 device column
  with **NaN for a missing value**.

Sorted categories make the codes order-isomorphic to the strings, and NaN
codes give every numeric kernel's missing-value rules (groupby dropna, the
total order of sort and join, na_position) to string keys unchanged.  The
``.str`` predicates and measures (``len``, ``startswith``, ...) run the
pandas method once per category and gather the table by code on the device.

The encoding is made at first use and cached on the column
(``HostColumn._dict_cache``), so a repeated ``groupby("city")`` factorizes
once.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

# Beyond this many distinct values a column stays host-only: the JAX
# package's float32 device policy keeps integers exact only to 2^24, and the
# port declines where the reference does.
_MAX_CATEGORIES = 1 << 24


class DictEncoding(NamedTuple):
    codes: Any  # DeviceColumn of float64 codes (NaN = missing)
    categories: np.ndarray  # sorted distinct values, on the host
    has_nan: bool  # whether any row is missing (a NaN code)


def encode_host_column(col: Any) -> Optional[DictEncoding]:
    """The column's :class:`DictEncoding`, or None (not an object/string
    column, unorderable mixed values, or more than ``_MAX_CATEGORIES``
    distinct values).  The result is cached on the column either way."""
    cached = col._dict_cache
    if cached is not None:
        return cached if cached is not False else None
    result = _encode(col)
    col._dict_cache = result if result is not None else False
    return result


def _encode(col: Any) -> Optional[DictEncoding]:
    import pandas
    from pandas.api.types import is_object_dtype

    dtype = col.pandas_dtype
    is_str = isinstance(dtype, pandas.StringDtype)
    # NumpyEADtype("object") != np.dtype(object) under ==: ask is_object_dtype
    if not (is_object_dtype(dtype) or is_str):
        return None
    # a string array factorizes itself (Arrow's dictionary encoding for the
    # pyarrow storage); an object column goes through its object values
    values = col.data if is_str else np.asarray(col.to_numpy(), dtype=object)
    try:
        codes, categories = pandas.factorize(values, sort=True, use_na_sentinel=True)
    except TypeError:
        return None  # unorderable mixed values
    categories = np.asarray(categories, dtype=object)
    if len(categories) > _MAX_CATEGORIES:
        return None
    return DictEncoding(_device_codes(codes), categories, bool((codes == -1).any()))


def _device_codes(codes: np.ndarray) -> Any:
    """A device column of float64 codes from factorize's int codes (-1 for
    a missing value becomes NaN)."""
    from modin_tpu_torch.core.dataframe.torch.dataframe import DeviceColumn
    from modin_tpu_torch.parallel.engine import TorchWrapper

    data = TorchWrapper.put(np.asarray(codes)).to(torch.float64)
    data = torch.where(data < 0, float("nan"), data)
    return DeviceColumn(data, np.dtype(np.float64), length=len(codes))


def encode_categorical_column(col: Any) -> Optional[DictEncoding]:
    """The encoding of a host CATEGORICAL column: pandas stores the codes
    already.  The categories keep their category order (pandas sorts
    categorical groups by it), so this encoding is cached apart, under
    ``_cat_cache``: the consumers of sorted categories (isin, nunique,
    value_counts, sort) must never receive it."""
    cached = col._cat_cache
    if cached is not None:
        return cached if cached is not False else None
    try:
        codes = np.asarray(col.data.codes)
        categories = np.asarray(col.data.categories)
    except AttributeError:
        col._cat_cache = False
        return None
    result = DictEncoding(_device_codes(codes), categories, bool((codes == -1).any()))
    col._cat_cache = result
    return result


def decode_codes(code_values: np.ndarray, categories: np.ndarray) -> np.ndarray:
    """Host object array of the categories at (possibly NaN) float codes."""
    out = np.empty(len(code_values), dtype=object)
    codes = np.asarray(code_values, dtype=np.float64)
    if len(categories) == 0:
        # an all-missing column factorizes to no categories: every code is NaN
        out[:] = np.nan
        return out
    nan_mask = np.isnan(codes)
    idx = np.where(nan_mask, 0, codes).astype(np.int64)
    out[:] = categories[idx]
    if nan_mask.any():
        out[nan_mask] = np.nan
    return out


def union_categories(
    left: np.ndarray, right: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(union, left_map, right_map): the sorted union of two sorted category
    arrays and, per side, the old-code -> union-code table.  Both maps keep
    the order, so remapped codes stay order-isomorphic and the device
    sort-merge join applies unchanged."""
    union = np.union1d(left, right)
    left_map = np.searchsorted(union, left).astype(np.float64)
    right_map = np.searchsorted(union, right).astype(np.float64)
    return union, left_map, right_map


def remap_codes_device(codes: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """``new[i] = table[codes[i]]`` on the device, NaN passing through.
    Codes beyond the table clamp to its ends, as the JAX package's
    ``take(mode="clip")`` does."""
    t = torch.as_tensor(np.asarray(table, dtype=np.float64), device=codes.device)
    nan = torch.isnan(codes)
    safe = torch.where(nan, 0.0, codes).to(torch.int64).clamp_(0, max(len(table) - 1, 0))
    return torch.where(nan, float("nan"), t[safe])


def lookup_values(values: List[Any], categories: np.ndarray) -> np.ndarray:
    """Float codes of ``values`` in ``categories`` (NaN where absent): the
    host half of a device ``isin`` on an encoded column."""
    out = np.full(len(values), np.nan, dtype=np.float64)
    for i, v in enumerate(values):
        try:
            pos = np.searchsorted(categories, v)
            if pos < len(categories) and categories[pos] == v:
                out[i] = float(pos)
        except TypeError:
            continue  # an unorderable value cannot be present
    return out


def gather_lut(codes: torch.Tensor, lut: np.ndarray) -> torch.Tensor:
    """``lut[code]`` per row on the device, where ``lut`` holds one entry
    per category and the missing-value entry last (NaN codes take it)."""
    t = torch.as_tensor(np.asarray(lut), device=codes.device)
    safe = torch.where(torch.isnan(codes), float(len(lut) - 1), codes)
    return t[safe.to(torch.int64).clamp_(0, len(lut) - 1)]
