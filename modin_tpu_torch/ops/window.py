"""Rolling, expanding and exponentially weighted windows on the device.

The port's counterpart of ``modin_tpu/ops/window.py``.  Every windowed
aggregation is O(n) work:

- sum/mean/count/var/std/sem: prefix sums and shifted differences (var
  uses windowed sums of x and x^2 over a globally centred column, which
  removes the E[x^2] - E[x]^2 cancellation);
- min/max: the van Herk/Gil-Werman two-pass, block prefix and suffix
  extrema (the scan kernel's segmented max/min over blocks of w rows, and
  over the flipped column) give any window's extremum as
  max(suffix[i-w+1], prefix[i]), whatever the window;
- expanding_*: the same formulas with the whole prefix as the window;
- ewm mean/sum/var/std and the pair cov/corr: first-order linear
  recurrences y_t = a_t*y_{t-1} + b_t, each one launch of the scan kernel's
  ``linear`` mode (``ops/cuda/scan_kernels.py``; the JAX package runs them
  as ``_linear_scan``, an XLA associative scan).

Prefix sums, counts and running extrema go through the scan kernel: float
sums in a fixed order, so a result repeats bit for bit (``torch.cumsum``
need not on CUDA), counts exactly, and extrema far faster than
``torch.cummax`` (~60 ms a column at 2e7 rows on the H100).  pandas' rules carry
over: ``_prep_values`` treats +/-inf as missing in every window
aggregation but ``count``, which (with the count that divides ``sem``)
takes them as values; ``count`` gates ``min_periods`` on rows (NaN
included); the ewm mean carries the last observation's value into missing
rows by a gather.  Columns are unpadded here (one device), so the JAX package's
validity masks are gone.
"""

from __future__ import annotations

from typing import List

import torch

from modin_tpu_torch.ops.cuda.scan_kernels import scan

ROLLING_DEVICE_OPS = ("sum", "mean", "count", "min", "max", "var", "std", "sem")
EXPANDING_DEVICE_OPS = ("sum", "mean", "count", "min", "max", "var", "std", "sem")
EWM_DEVICE_OPS = ("mean", "sum", "var", "std")

_F64 = torch.float64


def _windowed(arr: torch.Tensor, window: int) -> torch.Tensor:
    """arr[i] - arr[i - window] of a prefix array (arr[j] = 0 for j < 0)."""
    if window >= arr.shape[0]:
        return arr
    shifted = torch.cat([torch.zeros(window, dtype=arr.dtype, device=arr.device), arr[:-window]])
    return arr - shifted


def _van_herk(x: torch.Tensor, window: int, op: str) -> torch.Tensor:
    """Windowed min/max in O(n) from block prefix and suffix extrema.

    For the window [s, i] (s = i-w+1) spanning blocks b-1 and b of width w,
    suffix[s] covers [s, end of b-1] and prefix[i] covers [start of b, i];
    their extremum is the window's.  Leading windows (i < w-1) are prefix[i]
    alone: suffix[0] would reach into later rows.
    """
    n = x.shape[0]
    w = min(window, n)
    nb = -(-n // w)
    pad = nb * w - n
    neutral = float("inf") if op == "min" else float("-inf")
    xp = torch.cat([x, torch.full((pad,), neutral, dtype=x.dtype, device=x.device)]) if pad else x
    # one segment per block of w rows (flipped, the blocks run backwards)
    block = torch.arange(nb * w, device=x.device) // w
    pick = torch.minimum if op == "min" else torch.maximum
    prefix = scan(f"seg_{op}", xp, block)[:n]
    suffix = scan(f"seg_{op}", xp.flip(0), block.flip(0)).flip(0)[:n]
    idx = torch.arange(n, device=x.device)
    start = torch.clamp(idx - w + 1, min=0)
    out = pick(suffix[start], prefix)
    return torch.where(idx < w - 1, prefix, out)


def _missing(c: torch.Tensor):
    """pandas' window rule: NaN and +/-inf are missing (ints never are)."""
    if c.dtype.is_floating_point:
        return ~torch.isfinite(c)
    return None


def _cumcount(valid: torch.Tensor) -> torch.Tensor:
    """Inclusive int64 count of the True rows so far."""
    return scan("seg_add", valid.to(torch.int64))


def _windowed_count(valid: torch.Tensor, window: int) -> torch.Tensor:
    return _windowed(_cumcount(valid), window)


def _one_windowed(op: str, c: torch.Tensor, n: int, window: int, min_periods: int, ddof: int) -> torch.Tensor:
    nanm = _missing(c)
    idx = torch.arange(n, device=c.device)
    wrows = torch.clamp(idx + 1, max=window)
    if nanm is None:
        wcnt = wrows
        total_cnt = max(n, 1)
    else:
        wcnt = _windowed_count(~nanm, window)
        total_cnt = torch.clamp((~nanm).sum(), min=1)
    nan = torch.tensor(float("nan"), dtype=_F64, device=c.device)
    # pandas' count (and the count that divides sem) takes +/-inf as a value:
    # only NaN is missing there
    if nanm is None:
        wnotnan = wcnt
    elif op in ("count", "sem"):
        wnotnan = _windowed_count(~torch.isnan(c), window)

    if op == "count":
        # pandas gates count on the ROWS in the window (NaN included)
        return torch.where(wrows >= min_periods, wnotnan.to(_F64), nan)

    if op in ("min", "max"):
        x = c.to(_F64)
        if nanm is not None:
            x = torch.where(nanm, float("inf") if op == "min" else float("-inf"), x)
        r = _van_herk(x, window, op)
        return torch.where(wcnt >= max(min_periods, 1), r, nan)

    x = c.to(_F64)
    if nanm is not None:
        x = torch.where(nanm, 0.0, x)
    if op in ("var", "std", "sem"):
        # centre globally first: a window's variance is shift-invariant, and
        # sum(x^2) - sum(x)^2/n over centred values avoids the cancellation
        gmean = x.sum() / total_cnt
        x = x - gmean
        if nanm is not None:
            x = torch.where(nanm, 0.0, x)
    wsum = _windowed(scan("seg_add", x), window)

    if op == "sum":
        return torch.where(wcnt >= min_periods, wsum, nan)
    if op == "mean":
        res = wsum / torch.clamp(wcnt, min=1)
        return torch.where((wcnt >= min_periods) & (wcnt > 0), res, nan)
    wsum2 = _windowed(scan("seg_add", x * x), window)
    cntf = torch.clamp(wcnt, min=1).to(_F64)
    var = (wsum2 - wsum * wsum / cntf) / torch.clamp(wcnt - ddof, min=1)
    var = torch.clamp(var, min=0.0)  # tiny negative rounding
    var = torch.where((wcnt >= max(min_periods, 1)) & (wcnt - ddof > 0), var, nan)
    if op == "var":
        return var
    if op == "std":
        return torch.sqrt(var)
    return torch.sqrt(var) / torch.sqrt(wnotnan.to(_F64))  # sem: std / sqrt(count)


def rolling_reduce(
    op: str, cols: List[torch.Tensor], n: int, window: int, min_periods: int, ddof: int = 1
) -> List[torch.Tensor]:
    """Rolling aggregation of each column (``n`` rows); float64 results."""
    if op not in ROLLING_DEVICE_OPS:
        raise ValueError(f"rolling aggregation {op!r} is not ported")
    return [_one_windowed(op, c, int(n), int(window), int(min_periods), int(ddof)) for c in cols]


def expanding_reduce(
    op: str, cols: List[torch.Tensor], n: int, min_periods: int, ddof: int = 1
) -> List[torch.Tensor]:
    """Expanding aggregation: rolling with the whole length as the window
    (prefix differences, van Herk blocks and gates all reduce to the
    expanding forms when window >= n)."""
    return rolling_reduce(op, cols, int(n), max(int(n), 1), int(min_periods), int(ddof))


# --------------------------------------------------------------------- #
# Exponentially weighted windows
# --------------------------------------------------------------------- #
#
# pandas' kernel is a sequential update per row.  Every ewm statistic is a
# composition of first-order linear recurrences, as in the JAX package:
#
# - adjust=True: numerator, denominator and sum of squared weights all decay
#   by f = 1 - alpha per step (per observation under ignore_na), each new
#   observation entering with weight 1; mean = num / den.
# - adjust=False: pandas renormalises at every observation, so the mean is
#   itself the recurrence y_t = (f^gap*y_{t-1} + alpha*x_t)/(f^gap + alpha),
#   `gap` counting the decay steps since the previous observation; the
#   bias-correction weights renormalise by the same factor.
# - var: pandas' update cov_t = (ow*(cov_{t-1} + (mu_{t-1}-mu_t)^2) +
#   nw*(x_t-mu_t)^2)/(ow+nw) is linear in cov once the means are known, a
#   second scan; the debiasing factor is sum_wt^2/(sum_wt^2 - sum_wt2).


def _ewm_steps(valid: torch.Tensor, alpha: float, ignore_na: bool):
    """(cnt, is_first, lastv, fd): observations so far, the first
    observation, the position of the last observation (-1 before any), and
    the decay f^gap applied on entering each position."""
    n = valid.shape[0]
    f = 1.0 - alpha
    idx = torch.arange(n, dtype=torch.int64, device=valid.device)
    cnt = _cumcount(valid)
    is_first = valid & (cnt == 1)
    lastv = scan("seg_max", torch.where(valid, idx, -1))
    lastv_excl = torch.cat([torch.full((1,), -1, dtype=torch.int64, device=valid.device), lastv[:-1]])
    if ignore_na:
        gap = torch.ones(n, dtype=_F64, device=valid.device)
    else:
        gap = (idx - lastv_excl).to(_F64)
    return cnt, is_first, lastv, torch.pow(torch.tensor(f, dtype=_F64, device=valid.device), gap)


def _snap_constant_prefix(mean: torch.Tensor, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The mean where every observation so far has one value is that value,
    exactly: pandas updates its running mean only where it differs from the
    new value, so a constant column has mean x and variance 0 exactly,
    where num/den rounds."""
    hi = scan("seg_max", torch.where(valid, x, float("-inf")))
    lo = scan("seg_min", torch.where(valid, x, float("inf")))
    return torch.where(hi == lo, hi, mean)


def _shift_in(x: torch.Tensor) -> torch.Tensor:
    """x[t-1] at t, 0 at t = 0."""
    return torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device), x[:-1]])


def _one_ewm(op: str, c: torch.Tensor, n: int, alpha: float, adjust: bool,
             ignore_na: bool, min_periods: int, bias: bool) -> torch.Tensor:
    nanm = _missing(c)
    valid = torch.ones(n, dtype=torch.bool, device=c.device) if nanm is None else ~nanm
    x = c.to(_F64)
    if nanm is not None:
        x = torch.where(valid, x, 0.0)
    f = 1.0 - alpha
    mp = max(int(min_periods), 1)
    cnt, is_first, lastv, fd = _ewm_steps(valid, alpha, ignore_na)
    ones = torch.ones(n, dtype=_F64, device=c.device)
    zeros = torch.zeros(n, dtype=_F64, device=c.device)
    nan = torch.tensor(float("nan"), dtype=_F64, device=c.device)
    bv = valid.to(_F64)

    if adjust or op == "sum":
        a_step = torch.where(valid, f, ones) if ignore_na else torch.full((n,), f, dtype=_F64, device=c.device)
        num = scan("linear", a_step, x)
        if op == "sum":
            return torch.where(cnt >= mp, num, nan)
        den = scan("linear", a_step, bv)
        sum_wt2 = scan("linear", a_step * a_step, bv)
        # den >= 1 at every observation; carry the LAST OBSERVATION's value
        # into missing rows by a gather rather than by num/den, which
        # collapses to 0/0 when f**gap underflows (alpha near 1)
        mean_raw = num / torch.where(den == 0, 1.0, den)
        mean = torch.where(lastv >= 0, mean_raw[torch.clamp(lastv, min=0)], nan)
        sum_wt = den
        ow = a_step * _shift_in(den)
        nw = 1.0
    else:
        cnorm = fd + alpha
        ay = torch.where(valid, torch.where(is_first, zeros, fd / cnorm), ones)
        by = torch.where(valid, torch.where(is_first, x, alpha * x / cnorm), zeros)
        mean = torch.where(cnt >= 1, scan("linear", ay, by), nan)
        mid = valid & ~is_first
        obs = torch.where(valid, zeros, ones)
        aw = torch.where(mid, fd / cnorm, obs)
        sum_wt = scan("linear", aw, torch.where(mid, alpha / cnorm, bv))
        aw2 = torch.where(mid, (fd * fd) / (cnorm * cnorm), obs)
        sum_wt2 = scan("linear", aw2, torch.where(mid, (alpha * alpha) / (cnorm * cnorm), bv))
        ow = torch.where(is_first, zeros, fd)
        nw = alpha

    mean = _snap_constant_prefix(mean, x, valid)
    if op == "mean":
        return torch.where(cnt >= mp, mean, nan)

    # var/std: one more scan for the debiased second moment
    mid = valid & ~is_first
    mean0 = torch.where(torch.isnan(mean), 0.0, mean)
    mprev = _shift_in(mean0)
    denom_t = torch.where(mid, ow + nw, ones)
    ac = torch.where(mid, ow / denom_t, torch.where(valid, zeros, ones))
    cc = torch.where(mid, (ow * (mprev - mean0) ** 2 + nw * (x - mean0) ** 2) / denom_t, zeros)
    cov = scan("linear", ac, cc)
    if bias:
        v = cov
    else:
        numr = sum_wt * sum_wt
        denr = numr - sum_wt2
        v = torch.where(denr > 0, cov * numr / torch.where(denr == 0, 1.0, denr), nan)
    v = torch.where(cnt >= mp, v, nan)
    return torch.sqrt(v) if op == "std" else v


def ewm_reduce(
    op: str,
    cols: List[torch.Tensor],
    n: int,
    alpha: float,
    adjust: bool,
    ignore_na: bool,
    min_periods: int,
    bias: bool = False,
) -> List[torch.Tensor]:
    """Exponentially weighted aggregation of each column; float64 results."""
    if op not in EWM_DEVICE_OPS:
        raise ValueError(f"ewm aggregation {op!r} is not ported")
    return [
        _one_ewm(op, c, int(n), float(alpha), bool(adjust), bool(ignore_na), int(min_periods), bool(bias))
        for c in cols
    ]


def _one_ewm_pair(op: str, cx: torch.Tensor, cy: torch.Tensor, n: int, alpha: float,
                  adjust: bool, ignore_na: bool, min_periods: int, bias: bool) -> torch.Tensor:
    """ewm cov/corr of one column pair under JOINT validity (a row is an
    observation only where both sides are present, pandas' ewmcov rule);
    corr is the ratio of the three biased covariances."""
    valid = torch.ones(n, dtype=torch.bool, device=cx.device)
    for c in (cx, cy):
        m = _missing(c)
        if m is not None:
            valid = valid & ~m
    x = torch.where(valid, cx.to(_F64), 0.0)
    y = torch.where(valid, cy.to(_F64), 0.0)
    f = 1.0 - alpha
    mp = max(int(min_periods), 1)
    cnt, is_first, lastv, fd = _ewm_steps(valid, alpha, ignore_na)
    ones = torch.ones(n, dtype=_F64, device=cx.device)
    zeros = torch.zeros(n, dtype=_F64, device=cx.device)
    nan = torch.tensor(float("nan"), dtype=_F64, device=cx.device)
    bv = valid.to(_F64)

    if adjust:
        a_step = torch.where(valid, f, ones) if ignore_na else torch.full((n,), f, dtype=_F64, device=cx.device)
        num_x = scan("linear", a_step, x)
        num_y = scan("linear", a_step, y)
        den = scan("linear", a_step, bv)
        sum_wt2 = scan("linear", a_step * a_step, bv)
        den_safe = torch.where(den == 0, 1.0, den)
        carried = lastv >= 0
        at = torch.clamp(lastv, min=0)
        mx = torch.where(carried, (num_x / den_safe)[at], zeros)
        my = torch.where(carried, (num_y / den_safe)[at], zeros)
        sum_wt = den
        ow = a_step * _shift_in(den)
        nw = 1.0
    else:
        cnorm = fd + alpha
        a_mean = torch.where(valid, torch.where(is_first, zeros, fd / cnorm), ones)
        mid0 = valid & ~is_first
        obs = torch.where(valid, zeros, ones)
        mx = scan("linear", a_mean, torch.where(valid, torch.where(is_first, x, alpha * x / cnorm), zeros))
        my = scan("linear", a_mean, torch.where(valid, torch.where(is_first, y, alpha * y / cnorm), zeros))
        sum_wt = scan("linear", torch.where(mid0, fd / cnorm, obs), torch.where(mid0, alpha / cnorm, bv))
        sum_wt2 = scan("linear", 
            torch.where(mid0, (fd * fd) / (cnorm * cnorm), obs),
            torch.where(mid0, (alpha * alpha) / (cnorm * cnorm), bv),
        )
        ow = torch.where(is_first, zeros, fd)
        nw = alpha

    mx = _snap_constant_prefix(mx, x, valid)
    my = _snap_constant_prefix(my, y, valid)
    mid = valid & ~is_first
    mxp, myp = _shift_in(mx), _shift_in(my)
    denom_t = torch.where(mid, ow + nw, ones)
    ac = torch.where(mid, ow / denom_t, torch.where(valid, zeros, ones))

    def cov_terms(u, v, up, vp, mu, mv):
        return torch.where(mid, (ow * (up - mu) * (vp - mv) + nw * (u - mu) * (v - mv)) / denom_t, zeros)

    if op == "cov":
        cov = scan("linear", ac, cov_terms(x, y, mxp, myp, mx, my))
        if not bias:
            numr = sum_wt * sum_wt
            denr = numr - sum_wt2
            cov = torch.where(denr > 0, cov * numr / torch.where(denr == 0, 1.0, denr), nan)
        return torch.where(cnt >= mp, cov, nan)
    cxy = scan("linear", ac, cov_terms(x, y, mxp, myp, mx, my))
    cxx = scan("linear", ac, cov_terms(x, x, mxp, mxp, mx, mx))
    cyy = scan("linear", ac, cov_terms(y, y, myp, myp, my, my))
    denom = torch.sqrt(cxx * cyy)
    r = torch.where(denom > 0, cxy / torch.where(denom == 0, 1.0, denom), nan)
    return torch.where(cnt >= mp, r, nan)


def ewm_pair_reduce(
    op: str,
    xs: List[torch.Tensor],
    ys: List[torch.Tensor],
    n: int,
    alpha: float,
    adjust: bool,
    ignore_na: bool,
    min_periods: int,
    bias: bool = False,
) -> List[torch.Tensor]:
    """ewm cov/corr over matched column pairs; float64 results."""
    if op not in ("cov", "corr"):
        raise ValueError(f"ewm pair aggregation {op!r} is not ported")
    return [
        _one_ewm_pair(op, x, y, int(n), float(alpha), bool(adjust), bool(ignore_na), int(min_periods), bool(bias))
        for x, y in zip(xs, ys)
    ]
