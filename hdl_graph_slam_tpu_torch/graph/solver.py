"""Levenberg-Marquardt pose-graph solver on the device
(port of hdl_graph_slam_tpu/graph/solver.py).

Replaces g2o::SparseOptimizer + OptimizationAlgorithmLevenberg
(GraphSLAM::optimize, src/hdl_graph_slam/graph_slam.cpp:292-321). Per
iteration: linearization of all edge tables (linearize.py), the damped dense
solve (H + lam I) dx = -b over the free dofs by Cholesky, the manifold
update, and the chi2-gated accept/reject with Nielsen damping.

The JAX ``lax.while_loop`` becomes a Python loop whose state never leaves
the device. The host reads the ``done`` flag every ``CHECK_EVERY``
iterations; the state is frozen once ``done`` is set (every field is
selected against its previous value, and the iteration count stops), so the
extra iterations between two reads change nothing and ``data``, ``lam``,
``nu`` and ``iterations`` equal the JAX loop's.

A failed Cholesky (an indefinite damped system) yields NaN, as
``jnp.linalg.cholesky`` does: the trial's chi2 is then not finite and the
step is rejected, never raised.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .linearize import apply_delta, build_system, chi2_only, free_dof_mask
from .types import GraphData

CHECK_EVERY = 4  # iterations between two host reads of ``done``


class OptimizeStats(NamedTuple):
    iterations: torch.Tensor
    chi2_before: torch.Tensor
    chi2_after: torch.Tensor
    chi2_robust_before: torch.Tensor
    chi2_robust_after: torch.Tensor
    lam_final: torch.Tensor


def _select(cond: torch.Tensor, new: GraphData, old: GraphData) -> GraphData:
    """Vertex estimates of ``new`` where cond, else ``old`` (edges, masks and
    flags are the same in both)."""
    return old.replace(poses=torch.where(cond, new.poses, old.poses),
                       planes=torch.where(cond, new.planes, old.planes),
                       points=torch.where(cond, new.points, old.points))


def dense_step(H: torch.Tensor, b: torch.Tensor, lam: torch.Tensor, free_f: torch.Tensor) -> torch.Tensor:
    """dx solving (H_f + lam diag(free)) dx = -b_f, H_f the free block with a
    unit diagonal on fixed dofs; NaN where the Cholesky fails."""
    Hf = H * free_f[:, None] * free_f[None, :] + torch.diag(1.0 - free_f)
    A = Hf + lam * torch.diag(free_f)
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where(info == 0, L, torch.full((), float("nan"), dtype=L.dtype, device=L.device))
    return -torch.cholesky_solve((b * free_f)[:, None], L)[:, 0]


def optimize(data: GraphData, max_iterations: int = 512, linear_solver: str = "dense") -> tuple[GraphData, OptimizeStats]:
    """Run LM for up to max_iterations accept/reject steps.

    Only the dense Cholesky solver is ported; ``"pcg"`` and ``"schur"`` are
    ROADMAP Queue 1 item 11 of the port (graph/pcg.py, graph/schur.py).
    """
    if linear_solver in ("pcg", "schur"):
        raise NotImplementedError(
            f"linear_solver={linear_solver!r}: graph/{linear_solver}.py is ROADMAP Queue 1 item 11 of the port"
        )
    if linear_solver != "dense":
        raise ValueError(f"unknown linear_solver {linear_solver!r}")
    dtype, dev = data.poses.dtype, data.poses.device
    free = free_dof_mask(data)
    free_f = free.to(dtype)

    chi2_raw0, chi2_rob0 = chi2_only(data)
    H0, _, _, _ = build_system(data)
    # g2o computeLambdaInit: tau * max diagonal over free dofs
    zero = torch.zeros((), dtype=dtype, device=dev)
    lam0 = 1e-5 * torch.where(free, torch.diagonal(H0), zero).amax()
    lam = torch.where(lam0 > 0, lam0, torch.full((), 1e-5, dtype=dtype, device=dev))
    nu = torch.full((), 2.0, dtype=dtype, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)

    for i in range(max_iterations):
        H, b, _, chi2_rob = build_system(data)
        dx = dense_step(H, b, lam, free_f)
        data_new = apply_delta(data, dx)
        _, chi2_new = chi2_only(data_new)

        accept = (chi2_new < chi2_rob) & torch.isfinite(chi2_new)
        bf = b * free_f
        denom = torch.dot(dx, lam * dx - bf)
        rho = (chi2_rob - chi2_new) / torch.where(denom.abs() < 1e-30, 1e-30, denom)
        lam_acc = lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam_next = torch.where(accept, lam_acc, lam * nu)
        nu_next = torch.where(accept, 2.0, 2.0 * nu)
        step_small = accept & (dx.abs().amax() < 1e-10)
        done_next = step_small | (lam_next > 1e30)

        # frozen once done: every field keeps its value and the count stops
        live = ~done
        data = _select(live & accept, data_new, data)
        lam = torch.where(live, lam_next, lam)
        nu = torch.where(live, nu_next, nu)
        it = it + live.to(it.dtype)
        done = done | done_next
        if (i + 1) % CHECK_EVERY == 0 and bool(done):  # host sync
            break

    chi2_raw1, chi2_rob1 = chi2_only(data)
    stats = OptimizeStats(iterations=it, chi2_before=chi2_raw0, chi2_after=chi2_raw1,
                          chi2_robust_before=chi2_rob0, chi2_robust_after=chi2_rob1, lam_final=lam)
    return data, stats
