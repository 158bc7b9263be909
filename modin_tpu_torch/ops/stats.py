"""Pairwise statistics: ``corr``/``cov`` as one Gram product.

The port's counterpart of ``modin_tpu/ops/stats.py::corr_cov_matrix``.  With
``V`` the validity masks of the k columns and ``Z`` their values (0 where
missing), every pairwise-complete sum the Pearson formula needs is a block
of one (3k x n) @ (n x 3k) float64 matrix product of ``[Z, Z*Z, V]``:

    N = Vᵀ V          pairwise-complete counts
    S = Zᵀ V          S[i, j] = sum of x_i over the rows valid in both
    P = Zᵀ Z          sums of x_i * x_j
    Q = (Z*Z)ᵀ V      sums of x_i^2 over the rows valid in both

Unlike the JAX package, each column is first shifted by the mean of its
valid values.  A covariance does not change under a shift, and without it
``P - S Sᵀ / N`` cancels catastrophically once a column's mean is large
against its spread (1e8 + N(0, 1) gives a negative variance); pandas'
Welford loop has no such fault, and the port follows pandas.

pandas' rules, as the JAX package encodes them: pairwise-complete rows,
``cov`` divides by N - 1 whatever ``ddof`` says once any value is missing,
``min_periods`` applies, ``corr`` is clipped to [-1, 1], and a pair with
too few rows or no spread is NaN.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from modin_tpu_torch.parallel.engine import materialize as _engine_materialize


def corr_cov_matrix(
    cols: List[torch.Tensor],
    method: str = "corr",
    ddof: int = 1,
    min_periods: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """(k x k matrix, pairwise counts) on the host for equal-length device
    columns; ``method`` is ``"corr"`` or ``"cov"``."""
    if method not in ("corr", "cov"):
        raise ValueError(f"method must be 'corr' or 'cov', not {method!r}")
    k = len(cols)
    X = torch.stack([c.to(torch.float64) for c in cols], dim=1)  # (n, k)
    V = ~torch.isnan(X)
    Vf = V.to(torch.float64)
    shift = torch.where(V, X, 0.0).sum(0) / Vf.sum(0).clamp(min=1.0)
    Z = torch.where(V, X - shift, 0.0)
    M = torch.cat([Z, Z * Z, Vf], dim=1)
    G = M.T @ M
    P, S, Q, N = G[:k, :k], G[:k, 2 * k:], G[k:2 * k, 2 * k:], G[2 * k:, 2 * k:]

    Nsafe = N.clamp(min=1.0)
    centred = P - S * S.T / Nsafe  # sum of (x_i - mean_i)(x_j - mean_j) per pair
    if method == "cov":
        # pandas: with any value missing, DataFrame.cov takes the
        # pairwise-complete path, which divides by N - 1 whatever ddof says
        eff_ddof = torch.where((~V).any(), 1.0, float(ddof))
        out = torch.where(N - eff_ddof > 0, centred / (N - eff_ddof).clamp(min=1.0), float("nan"))
    else:
        ssq = Q - S * S / Nsafe  # sum of squared deviations of x_i per pair
        denom = torch.sqrt(ssq * ssq.T)
        out = torch.where(denom > 0, centred / denom, float("nan")).clamp(-1.0, 1.0)
    out = torch.where(N >= max(int(min_periods), 1), out, float("nan"))
    out_h, counts_h = _engine_materialize((out, N))
    return np.asarray(out_h), np.asarray(counts_h)
