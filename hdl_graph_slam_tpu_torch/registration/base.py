"""Registration interface and the shared LM loop
(port of hdl_graph_slam_tpu/registration/base.py).

The JAX ``lax.while_loop`` becomes a Python loop. All LM state stays on the
device; the loop reads back two flags per iteration (``converged`` and, in
the gated branch, ``refresh``) with one host sync, to decide whether to stop
and whether to re-associate. A device-side loop or CUDA graph that removes
that sync is ROADMAP work.

``lm_loop_batched`` is the same loop over a batch of problems (the loop
detector's candidates), with the semantics of ``jax.vmap`` over the
``lax.while_loop``: each problem's state stops changing at its own
termination, the loop ends when all have, and a gated re-association
refreshes only the problems whose own ``refresh`` fired. It still reads one
flag vector per iteration.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import se3
from ..ops.small_solve import solve_spd


class AlignResult(NamedTuple):
    transformation: torch.Tensor  # (4, 4) final source->target transform
    converged: torch.Tensor  # () bool — converged within max_iterations
    iterations: torch.Tensor  # () int32 — outer iterations executed
    error: torch.Tensor  # () float — final objective value (method-specific)
    num_inliers: torch.Tensor  # () int32 — correspondences used in last step


def se3_delta_converged(delta: torch.Tensor, epsilon: float) -> torch.Tensor:
    """fast_gicp::LsqRegistration::is_converged: the update's rotation block
    (scaled by 2) and translation both elementwise below epsilon. delta
    (..., 4, 4) -> (...)."""
    eye = torch.eye(3, dtype=delta.dtype, device=delta.device)
    rot_small = (2.0 * (delta[..., :3, :3] - eye)).abs().amax((-1, -2)) < epsilon
    trans_small = delta[..., :3, 3].abs().amax(-1) < epsilon
    return rot_small & trans_small


class LMState(NamedTuple):
    T: torch.Tensor
    lam: torch.Tensor
    nu: torch.Tensor
    converged: torch.Tensor
    num_inliers: torch.Tensor
    error: torch.Tensor


def _lm_init(associate_all, linearize_at, guess: torch.Tensor, lm_init_lambda_factor: float):
    """The first association and the initial state; every field carries the
    guess's leading batch, if any. Returns (state, corr, lam0)."""
    corr = associate_all(guess)
    H0, _, cost0, n0 = linearize_at(guess, corr)
    lam0 = lm_init_lambda_factor * torch.diagonal(H0, dim1=-2, dim2=-1).abs().amax(-1)
    two = torch.full_like(lam0, 2.0)
    s = LMState(T=guess, lam=lam0, nu=two, converged=torch.zeros_like(lam0, dtype=torch.bool),
                num_inliers=n0, error=cost0)
    return s, corr, lam0


def _lm_step(s: LMState, corr, linearize_at, cost_at, epsilon: float):
    """One damped trial with fixed correspondences (Nielsen damping), for one
    problem or a leading batch of them. Returns (state, d, accept)."""
    H, b, cost, ninl = linearize_at(s.T, corr)
    A = H.clone()
    A.diagonal(dim1=-2, dim2=-1).add_(s.lam[..., None])  # H + lam I
    d = -solve_spd(A, b)
    delta = se3.se3_exp(d)
    T_new = se3.compose(delta, s.T)
    cost_new = cost_at(T_new, corr)
    accept = (cost_new < cost) & torch.isfinite(cost_new)
    denom = (d * (s.lam[..., None] * d - b)).sum(-1)
    rho = (cost - cost_new) / torch.where(denom.abs() < 1e-30, 1e-30, denom)
    lam_acc = s.lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    lam = torch.where(accept, lam_acc, s.lam * s.nu)
    nu = torch.where(accept, 2.0, 2.0 * s.nu)
    # A rejected sub-epsilon step also converges: in f32 the trial-cost
    # comparison bottoms out at the rounding floor near the optimum, and
    # an accept-gated test would double lambda to max_iterations.
    conv = se3_delta_converged(delta, epsilon)
    s2 = LMState(T=torch.where(accept[..., None, None], T_new, s.T), lam=lam, nu=nu, converged=conv,
                 num_inliers=ninl, error=torch.where(accept, cost_new, cost))
    return s2, d, accept


def _lm_gate(s: LMState, s2: LMState, d, accept, disp, r_max, budget: float, lam0):
    """The gated re-association's bookkeeping after one trial, batch-agnostic.

    The per-point displacement bound of exp(d) applied to T is
    |exp(d)Tp - Tp| <= |d_v| + |d_w| * (r_max + |t|). Convergence is only
    trusted on a fresh association; a stale one refreshes and re-checks
    next iteration, with the damping re-seeded (stale-trial rejections
    inflated lambda before the refresh fired). Returns (state, refresh,
    displacement accumulated since the last association)."""
    radius = r_max + torch.linalg.norm(s.T[..., :3, 3], dim=-1)
    step_disp = torch.where(accept, torch.linalg.norm(d[..., :3], dim=-1)
                            + torch.linalg.norm(d[..., 3:], dim=-1) * radius, 0.0)
    disp_next = disp + step_disp
    stale = disp > 0.0
    conv_refresh = s2.converged & stale
    refresh = conv_refresh | (disp_next > budget)
    s2 = s2._replace(converged=s2.converged & ~stale, lam=torch.where(conv_refresh, lam0, s2.lam),
                     nu=torch.where(conv_refresh, 2.0, s2.nu))
    return s2, refresh, torch.where(refresh, 0.0, disp_next)


def lm_loop(
    associate,
    linearize_at,
    cost_at,
    guess: torch.Tensor,
    max_iterations: int,
    transformation_epsilon: float,
    lm_init_lambda_factor: float = 1e-9,
    reassoc_displacement: float = 0.0,
    r_max: Optional[torch.Tensor] = None,
) -> AlignResult:
    """Levenberg-Marquardt over SE(3) with Nielsen damping (fast_gicp
    LsqRegistration::step_lm structure).

    - ``associate(T) -> corr``: correspondences + fixed Mahalanobis weights;
    - ``linearize_at(T, corr) -> (H, b, cost, num_inliers)``;
    - ``cost_at(T, corr) -> cost`` evaluates a trial with the SAME
      correspondences (the gated sum-cost is not monotone under
      re-association).

    The increment is applied on the left, T <- exp(d) T, one trial per
    iteration; a rejected trial keeps the pose. Convergence is the damped
    step being below epsilon, accepted or not.

    reassoc_displacement > 0 (requires ``r_max``, the farthest source point's
    radius) carries the correspondences until the accumulated per-point
    displacement bound exceeds that many meters, or until the loop would
    declare convergence on a stale association, which refreshes and
    re-checks instead. The terminal pose satisfies the same fixed-point
    condition as per-iteration re-association.
    """
    gated = bool(reassoc_displacement)
    if gated and r_max is None:
        raise ValueError("reassoc_displacement > 0 requires r_max")
    s, corr, lam0 = _lm_init(associate, linearize_at, guess, lm_init_lambda_factor)
    it = 0
    converged = False
    if not gated:
        while it < max_iterations and not converged:
            s, _, _ = _lm_step(s, associate(s.T), linearize_at, cost_at, transformation_epsilon)
            it += 1
            converged = bool(s.converged)  # host sync: one per iteration
    else:
        disp = torch.zeros_like(lam0)
        while it < max_iterations and not converged:
            s2, d, accept = _lm_step(s, corr, linearize_at, cost_at, transformation_epsilon)
            it += 1
            s, refresh, disp = _lm_gate(s, s2, d, accept, disp, r_max, reassoc_displacement, lam0)
            converged, do_refresh = torch.stack([s.converged, refresh]).tolist()  # host sync
            if do_refresh:
                corr = associate(s.T)
        if not converged:
            # honest error on a max-iterations exit: the last cost may have
            # been evaluated under a stale association
            s = s._replace(error=cost_at(s.T, associate(s.T)))
    return AlignResult(
        transformation=s.T,
        converged=s.converged,
        iterations=torch.tensor(it, dtype=torch.int32, device=guess.device),
        error=s.error,
        num_inliers=s.num_inliers,
    )


def _select_rows(cond: torch.Tensor, new: tuple, old: tuple) -> tuple:
    """Per field, rows of ``new`` where the (B,) ``cond`` holds, else ``old``."""
    return type(new)(*[torch.where(cond.reshape(cond.shape + (1,) * (a.ndim - 1)), a, b)
                       for a, b in zip(new, old)])


def _put_rows(corr: tuple, rows: torch.Tensor, part: tuple) -> tuple:
    return type(corr)(*[c.index_put((rows,), p) for c, p in zip(corr, part)])


def lm_loop_batched(
    associate,
    linearize_at,
    cost_at,
    guess: torch.Tensor,
    max_iterations: int,
    transformation_epsilon: float,
    lm_init_lambda_factor: float = 1e-9,
    reassoc_displacement: float = 0.0,
    r_max: Optional[torch.Tensor] = None,
) -> AlignResult:
    """``lm_loop`` over B problems with guesses (B, 4, 4), the same trial
    and gate on every row.

    - ``associate(T, rows) -> corr`` for the problems ``rows`` (int64) at
      their poses T (len(rows), 4, 4); every field of ``corr`` has the batch
      as its leading dimension;
    - ``linearize_at(T, corr) -> (H, b, cost, num_inliers)`` and
      ``cost_at(T, corr) -> cost`` over the whole batch.

    A problem is live while it has not converged and has run fewer than
    max_iterations; the step is computed for the whole batch and kept only
    where live, so a finished problem's state (and its iteration count) is
    frozen as under jax.vmap. ``r_max`` is (B,) when gated.
    """
    gated = bool(reassoc_displacement)
    if gated and r_max is None:
        raise ValueError("reassoc_displacement > 0 requires r_max")
    dev = guess.device
    all_rows = torch.arange(guess.shape[0], device=dev)
    s, corr, lam0 = _lm_init(lambda T: associate(T, all_rows), linearize_at, guess, lm_init_lambda_factor)
    it = torch.zeros_like(lam0, dtype=torch.int32)
    live = torch.ones_like(lam0, dtype=torch.bool)
    disp = torch.zeros_like(lam0)
    for _ in range(max_iterations):
        s2, d, accept = _lm_step(s, corr, linearize_at, cost_at, transformation_epsilon)
        if gated:
            s2, refresh, disp_next = _lm_gate(s, s2, d, accept, disp, r_max, reassoc_displacement, lam0)
            disp = torch.where(live, disp_next, disp)
            do_refresh = live & refresh
        s = _select_rows(live, s2, s)
        it = it + live.to(it.dtype)
        live = ~s.converged & (it < max_iterations)
        # host sync: one flag vector per iteration. Gated, the problems whose
        # own refresh fired re-associate; otherwise every live one does.
        flags = torch.stack([live, do_refresh] if gated else [live, live]).cpu()
        if not bool(flags[0].any()):
            break
        rows = torch.nonzero(flags[1])[:, 0].to(dev)
        if rows.numel():
            corr = _put_rows(corr, rows, associate(s.T[rows], rows))
    if gated and not bool(s.converged.all()):
        # honest error on a max-iterations exit, per problem
        fresh = cost_at(s.T, associate(s.T, all_rows))
        s = s._replace(error=torch.where(s.converged, s.error, fresh))
    return AlignResult(transformation=s.T, converged=s.converged, iterations=it, error=s.error,
                       num_inliers=s.num_inliers)
