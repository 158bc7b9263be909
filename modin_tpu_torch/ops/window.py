"""Rolling, expanding and exponentially weighted windows on the device.

The port's counterpart of ``modin_tpu/ops/window.py``.  Every windowed
aggregation is O(n) work:

- the van Herk/Gil-Werman split: over blocks of w rows, the scan kernel's
  block-segmented scans forward (prefix) and in reverse (suffix) give any
  window [s, i] as suffix[s] combined with prefix[i] (a leading or a
  block-aligned window is prefix[i] alone).  min/max take the extremum of
  the two; sum/mean their sum, so a window's rounding scales with its own
  values and not with the column's prefix; var/std/sem sum (x-c) and
  (x-c)^2 over both partials with one shift c inside the window, or, where
  the column has missing values, carry (count, sum(x-c), sum((x-c)^2)) per
  partial with a shift of its own and merge the two by Chan's formula;
- count: exact int prefix counts and shifted differences;
- expanding_*: the same formulas with one block of the whole length;
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

from typing import List, NamedTuple

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


class _Blocks(NamedTuple):
    """The van Herk geometry of one query, shared by its columns: blocks of
    w rows; the window [s, i] ending at row i spans blocks b-1 and b when
    ``split`` (then suffix[start] covers [s, end of b-1] and prefix[i] covers
    [start of b, i]); a leading window (i < w-1) or a block-aligned one is
    prefix[i] alone (suffix[0] would reach into later rows)."""

    w: int
    idx: torch.Tensor     # row index
    wrows: torch.Tensor   # rows in the window ending at each row
    split: torch.Tensor
    start: torch.Tensor   # the window's first row
    bstart: torch.Tensor  # the first row of each row's block
    any_split: bool


def _blocks(n: int, window: int, device) -> _Blocks:
    w = max(min(window, n), 1)
    idx = torch.arange(n, device=device)
    s = idx - w + 1
    return _Blocks(w, idx, torch.clamp(idx + 1, max=window), (s > 0) & (s % w != 0),
                   torch.clamp(s, min=0), idx - idx % w, w >= 2 and n >= w + 1)


def _van_herk(x: torch.Tensor, g: _Blocks, op: str) -> torch.Tensor:
    """Windowed min/max in O(n): the extremum of the block suffix and prefix
    extrema."""
    pick = torch.minimum if op == "min" else torch.maximum
    prefix = scan(f"seg_{op}", x, width=g.w)
    if not g.any_split:
        return prefix
    suffix = scan(f"seg_{op}", x, width=g.w, reverse=True)
    return torch.where(g.split, pick(suffix[g.start], prefix), prefix)


def _windowed_sum(d: torch.Tensor, g: _Blocks) -> torch.Tensor:
    """Sum over each window from block-local partial sums, so that its
    rounding scales with the window's own values."""
    pre = scan("seg_add", d, width=g.w)
    if not g.any_split:
        return pre
    suf = scan("seg_add", d, width=g.w, reverse=True)
    return torch.where(g.split, suf[g.start] + pre, pre)


def _windowed_m2(x: torch.Tensor, g: _Blocks, wcnt: torch.Tensor) -> torch.Tensor:
    """Sum of squared deviations from the mean over each window of a column
    with no missing values.

    Both partials of the window ending at i are shifted by one value c, the
    first row of i's block, which every window that uses either partial
    holds (the suffix partials of a block are shifted by the next block's
    first row).  Then S1 = sum(x-c) and S2 = sum((x-c)^2) are window sums
    and M2 = S2 - S1^2 / k rounds with the window's own spread."""
    d = x - x[g.bstart]
    s1, s2 = scan("seg_add", d, width=g.w), scan("seg_add", d * d, width=g.w)
    if g.any_split:
        e = x - x[torch.clamp(g.bstart + g.w, max=x.shape[0] - 1)]
        t1 = scan("seg_add", e, width=g.w, reverse=True)
        t2 = scan("seg_add", e * e, width=g.w, reverse=True)
        s1 = torch.where(g.split, t1[g.start] + s1, s1)
        s2 = torch.where(g.split, t2[g.start] + s2, s2)
    return torch.clamp(s2 - s1 * s1 / wcnt.to(_F64), min=0.0)


def _windowed_m2_missing(x: torch.Tensor, valid: torch.Tensor, g: _Blocks, wcnt: torch.Tensor,
                         cum: torch.Tensor) -> torch.Tensor:
    """:func:`_windowed_m2` of a column with missing values (zeros in
    ``x``).  A window's two partials may then need shifts of their own:
    each carries (count, sum(x-c), sum((x-c)^2)) with c the first valid
    value of the prefix partial's block, or the last valid value of the
    suffix partial's block, and the two merge by Chan's formula,
    M2 = M2p + M2s + d^2 np ns / n."""
    n = x.shape[0]

    def partial(pos: torch.Tensor, reverse: bool):
        c = x[torch.clamp(pos, 0, n - 1)]
        d = torch.where(valid, x - c, 0.0)
        return c, scan("seg_add", d, width=g.w, reverse=reverse), scan("seg_add", d * d, width=g.w,
                                                                      reverse=reverse)

    def m2_and_mean(cnt, c, s1, s2):
        k = torch.clamp(cnt, min=1).to(_F64)
        return torch.clamp(s2 - s1 * s1 / k, min=0.0), c + s1 / k

    cp, s1p, s2p = partial(scan("seg_min", torch.where(valid, g.idx, n), width=g.w), False)
    if not g.any_split:
        return m2_and_mean(wcnt, cp, s1p, s2p)[0]
    # rows of the prefix partial: those since the block's start
    cum_ex = torch.cat([torch.zeros(1, dtype=cum.dtype, device=x.device), cum])
    n_p = torch.where(g.split, cum - cum_ex[g.bstart], wcnt)
    n_s = wcnt - n_p
    cs, s1s, s2s = partial(scan("seg_max", torch.where(valid, g.idx, -1), width=g.w, reverse=True), True)
    m2p, mp = m2_and_mean(n_p, cp, s1p, s2p)
    m2s, ms = m2_and_mean(n_s, cs[g.start], s1s[g.start], s2s[g.start])
    npf, nsf = n_p.to(_F64), n_s.to(_F64)
    delta = ms - mp
    both = g.split & (n_p > 0) & (n_s > 0)
    merged = m2p + m2s + delta * delta * (npf * nsf / torch.clamp(npf + nsf, min=1.0))
    return torch.where(both, merged, torch.where(g.split & (n_p == 0), m2s, m2p))


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


def _one_windowed(op: str, c: torch.Tensor, g: _Blocks, window: int, min_periods: int,
                  ddof: int) -> torch.Tensor:
    nanm = _missing(c)
    if nanm is None:
        wcnt = g.wrows
    else:
        cum = _cumcount(~nanm)
        wcnt = _windowed(cum, window)
    nan = torch.tensor(float("nan"), dtype=_F64, device=c.device)
    # pandas' count (and the count that divides sem) takes +/-inf as a value:
    # only NaN is missing there
    if nanm is None:
        wnotnan = wcnt
    elif op in ("count", "sem"):
        wnotnan = _windowed_count(~torch.isnan(c), window)

    if op == "count":
        # pandas gates count on the ROWS in the window (NaN included)
        return torch.where(g.wrows >= min_periods, wnotnan.to(_F64), nan)

    if op in ("min", "max"):
        x = c.to(_F64)
        if nanm is not None:
            x = torch.where(nanm, float("inf") if op == "min" else float("-inf"), x)
        r = _van_herk(x, g, op)
        return torch.where(wcnt >= max(min_periods, 1), r, nan)

    x = c.to(_F64)
    if nanm is not None:
        x = torch.where(nanm, 0.0, x)
    if op in ("sum", "mean"):
        wsum = _windowed_sum(x, g)
        if op == "sum":
            return torch.where(wcnt >= min_periods, wsum, nan)
        res = wsum / torch.clamp(wcnt, min=1)
        return torch.where((wcnt >= min_periods) & (wcnt > 0), res, nan)
    if nanm is None or not bool(nanm.any()):
        m2 = _windowed_m2(x, g, wcnt)
    else:
        m2 = _windowed_m2_missing(x, ~nanm, g, wcnt, cum)
    var = m2 / torch.clamp(wcnt - ddof, min=1)
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
    if not cols:
        return []
    g = _blocks(int(n), int(window), cols[0].device)
    return [_one_windowed(op, c, g, int(window), int(min_periods), int(ddof)) for c in cols]


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
