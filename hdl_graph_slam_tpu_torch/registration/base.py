"""Registration interface and the shared LM loop
(port of hdl_graph_slam_tpu/registration/base.py).

The JAX ``lax.while_loop`` becomes a Python loop. All LM state stays on the
device; the loop reads back two flags per iteration (``converged`` and, in
the gated branch, ``refresh``) with one host sync, to decide whether to stop
and whether to re-associate. A device-side loop or CUDA graph that removes
that sync is ROADMAP work.
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
    (scaled by 2) and translation both elementwise below epsilon."""
    eye = torch.eye(3, dtype=delta.dtype, device=delta.device)
    rot_small = (2.0 * (delta[:3, :3] - eye)).abs().amax() < epsilon
    trans_small = delta[:3, 3].abs().amax() < epsilon
    return rot_small & trans_small


class LMState(NamedTuple):
    T: torch.Tensor
    lam: torch.Tensor
    nu: torch.Tensor
    converged: torch.Tensor
    num_inliers: torch.Tensor
    error: torch.Tensor


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
    dtype, dev = guess.dtype, guess.device
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    corr0 = associate(guess)
    H0, _, cost0, n0 = linearize_at(guess, corr0)
    lam0 = lm_init_lambda_factor * torch.diagonal(H0).abs().amax()
    two = torch.tensor(2.0, dtype=dtype, device=dev)
    gated = bool(reassoc_displacement)
    if gated and r_max is None:
        raise ValueError("reassoc_displacement > 0 requires r_max")

    def lm_step(s: LMState, corr):
        """One damped trial with fixed correspondences."""
        H, b, cost, ninl = linearize_at(s.T, corr)
        d = -solve_spd(H + s.lam * eye6, b)
        delta = se3.se3_exp(d)
        T_new = se3.compose(delta, s.T)
        cost_new = cost_at(T_new, corr)
        accept = (cost_new < cost) & torch.isfinite(cost_new)
        denom = torch.dot(d, s.lam * d - b)
        rho = (cost - cost_new) / torch.where(denom.abs() < 1e-30, 1e-30, denom)
        lam_acc = s.lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam = torch.where(accept, lam_acc, s.lam * s.nu)
        nu = torch.where(accept, two, 2.0 * s.nu)
        # A rejected sub-epsilon step also converges: in f32 the trial-cost
        # comparison bottoms out at the rounding floor near the optimum, and
        # an accept-gated test would double lambda to max_iterations.
        conv = se3_delta_converged(delta, transformation_epsilon)
        s2 = LMState(T=torch.where(accept, T_new, s.T), lam=lam, nu=nu, converged=conv,
                     num_inliers=ninl, error=torch.where(accept, cost_new, cost))
        return s2, d, accept

    s = LMState(T=guess, lam=lam0, nu=two, converged=torch.zeros((), dtype=torch.bool, device=dev),
                num_inliers=n0, error=cost0)
    it = 0
    converged = False
    if not gated:
        while it < max_iterations and not converged:
            s, _, _ = lm_step(s, associate(s.T))
            it += 1
            converged = bool(s.converged)  # host sync: one per iteration
    else:
        budget = float(reassoc_displacement)
        corr, disp = corr0, torch.zeros((), dtype=dtype, device=dev)
        while it < max_iterations and not converged:
            s2, d, accept = lm_step(s, corr)
            it += 1
            # per-point displacement bound of exp(d) applied to T:
            # |exp(d)Tp - Tp| <= |d_v| + |d_w| * (r_max + |t|)
            radius = r_max + torch.linalg.norm(s.T[:3, 3])
            step_disp = torch.where(accept, torch.linalg.norm(d[:3]) + torch.linalg.norm(d[3:]) * radius, 0.0)
            disp_next = disp + step_disp
            stale = disp > 0.0
            # only trust convergence on a fresh association; a stale one
            # refreshes and re-checks next iteration
            conv_refresh = s2.converged & stale
            conv = s2.converged & ~stale
            refresh = conv_refresh | (disp_next > budget)
            converged, do_refresh = torch.stack([conv, refresh]).tolist()  # host sync
            if do_refresh:
                corr, disp = associate(s2.T), torch.zeros_like(disp)
            else:
                disp = disp_next
            # re-seed the damping for the fresh re-check: stale-trial
            # rejections inflated lambda before the refresh fired
            s = s2._replace(
                converged=conv,
                lam=torch.where(conv_refresh, lam0, s2.lam),
                nu=torch.where(conv_refresh, two, s2.nu),
            )
        if not converged:
            # honest error on a max-iterations exit: the last cost may have
            # been evaluated under a stale association
            s = s._replace(error=cost_at(s.T, associate(s.T)))
    return AlignResult(
        transformation=s.T,
        converged=s.converged,
        iterations=torch.tensor(it, dtype=torch.int32, device=dev),
        error=s.error,
        num_inliers=s.num_inliers,
    )
