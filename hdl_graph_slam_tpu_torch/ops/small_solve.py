"""Unrolled tiny-matrix solves for the per-iteration 6x6 LM systems
(port of hdl_graph_slam_tpu/ops/small_solve.py).

The damped Gauss-Newton systems are SPD by construction, so an unrolled
Cholesky with clamped pivots plus unrolled triangular solves is exact; the
minimum pivot argument tells callers whether the matrix was PD. The
unrolling runs over columns with vector operations on the rows below, which
keeps the number of device operations per solve small.
"""

from __future__ import annotations

from typing import Tuple

import torch


def cholesky_unrolled(A: torch.Tensor, n: int = 6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lower-triangular Cholesky factor of the SPD (..., n, n) matrices, plus
    the minimum pivot argument encountered per matrix: non-positive iff A was
    not PD (the pivots are clamped at 1e-30, so callers can select a
    fallback). Columns are kept as (..., rows, 1) blocks, so a leading batch
    costs no extra operations."""
    L = torch.zeros_like(A)
    pivots = []
    for j in range(n):
        # column j from row j down
        s = A[..., j:, j:j + 1] - L[..., j:, :j] @ L[..., j:j + 1, :j].transpose(-1, -2)
        pivots.append(s[..., 0, :])
        d = torch.sqrt(torch.clamp(s[..., :1, :], min=1e-30))
        L[..., j:j + 1, j:j + 1] = d
        L[..., j + 1:, j:j + 1] = s[..., 1:, :] / d
    return L, torch.cat(pivots, -1).amin(-1)


def solve_spd_checked(A: torch.Tensor, b: torch.Tensor, n: int = 6) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, min_pivot) = (A^-1 b, smallest Cholesky pivot argument), for
    (n, n) systems or a batch (..., n, n) of them."""
    L, min_pivot = cholesky_unrolled(A, n)
    y = torch.zeros_like(b)[..., None]  # columns (..., n, 1)
    bc = b[..., None]
    for i in range(n):  # forward: L y = b
        y[..., i:i + 1, :] = (bc[..., i:i + 1, :] - L[..., i:i + 1, :i] @ y[..., :i, :]) / L[..., i:i + 1, i:i + 1]
    x = torch.zeros_like(y)
    Lt = L.transpose(-1, -2)
    for i in reversed(range(n)):  # backward: L^T x = y
        x[..., i:i + 1, :] = (y[..., i:i + 1, :] - Lt[..., i:i + 1, i + 1:] @ x[..., i + 1:, :]) / L[..., i:i + 1, i:i + 1]
    return x[..., 0], min_pivot


def solve_spd(A: torch.Tensor, b: torch.Tensor, n: int = 6) -> torch.Tensor:
    """x = A^-1 b for SPD (..., n, n) A via unrolled Cholesky + substitutions."""
    return solve_spd_checked(A, b, n)[0]


def gershgorin_min(A: torch.Tensor) -> torch.Tensor:
    """Lower bound on the smallest eigenvalue of symmetric A:
    min_i (A_ii - sum_{j != i} |A_ij|)."""
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    offsum = A.abs().sum(-1) - diag.abs()
    return (diag - offsum).amin(-1)

