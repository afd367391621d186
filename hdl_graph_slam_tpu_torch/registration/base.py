"""Registration interface and the shared LM loop
(port of hdl_graph_slam_tpu/registration/base.py).

The JAX ``lax.while_loop`` becomes a Python loop. All LM state stays on the
device; the loop reads back two flags per iteration (``converged`` and, in
the gated branch, ``refresh``) with one host sync, to decide whether to stop
and whether to re-associate. A device-side loop or CUDA graph that removes
that sync is ROADMAP work.

The loop computes JAX's function with fewer calls: an association is
always followed by the linearization at its pose (``associate_linearize``,
one launch of the fused GICP form), the first step reuses the initial
association and linearization instead of repeating them, and with carried
correspondences (gated) the trial is linearized in full, so an accepted
trial's H, b and cost are the next step's and a rejected one keeps the
state's (chosen on the device). Every call is deterministic, so the result
has the bits of the loop that repeats those calls as JAX's does: each
association and linearization of a pose and correspondence set is
computed once.

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
from ..utils.metrics import GLOBAL_TIMER


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


def _lm_init(associate_linearize, guess: torch.Tensor, lm_init_lambda_factor: float):
    """The first association and linearization and the initial state; every
    field carries the guess's leading batch, if any. Returns (state, corr,
    lin, lam0), lin = (H, b, cost, num_inliers) at the guess."""
    corr, lin = associate_linearize(guess)
    H0, _, cost0, n0 = lin[:4]
    lam0 = lm_init_lambda_factor * torch.diagonal(H0, dim1=-2, dim2=-1).abs().amax(-1)
    two = torch.full_like(lam0, 2.0)
    s = LMState(T=guess, lam=lam0, nu=two, converged=torch.zeros_like(lam0, dtype=torch.bool),
                num_inliers=n0, error=cost0)
    return s, corr, lin, lam0


def _lm_step(s: LMState, lin: tuple, corr, trial_at, epsilon: float):
    """One damped trial with fixed correspondences (Nielsen damping), for one
    problem or a leading batch of them, from ``lin`` = (H, b, cost,
    num_inliers) at s.T under ``corr``. ``trial_at(T_new, corr)`` is the
    trial: its cost alone, or its full linearization (H, b, cost,
    num_inliers). Returns (state, d, accept, trial)."""
    H, b, cost, ninl = lin[:4]
    A = H.clone()
    A.diagonal(dim1=-2, dim2=-1).add_(s.lam[..., None])  # H + lam I
    d = -solve_spd(A, b)
    delta = se3.se3_exp(d)
    T_new = se3.compose(delta, s.T)
    trial = trial_at(T_new, corr)
    cost_new = trial[2] if isinstance(trial, tuple) else trial
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
    return s2, d, accept, trial


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
    associate_linearize=None,
    select=None,
) -> AlignResult:
    """Levenberg-Marquardt over SE(3) with Nielsen damping (fast_gicp
    LsqRegistration::step_lm structure).

    - ``associate(T) -> corr``: correspondences + fixed Mahalanobis weights;
    - ``linearize_at(T, corr) -> (H, b, cost, num_inliers)``, the four
      fields a linearization starts with (it may carry more, which only
      ``select`` reads);
    - ``cost_at(T, corr) -> cost`` evaluates a trial with the SAME
      correspondences (the gated sum-cost is not monotone under
      re-association);
    - ``associate_linearize(T) -> (corr, (H, b, cost, num_inliers))``, both
      at T in one call (required; ``associate`` then ``linearize_at`` in
      effect);
    - ``select(cond, new, old)``: per field of two linearizations, ``new``
      where the () or (B,) ``cond`` holds, else ``old`` (by default a
      torch.where a field).

    The increment is applied on the left, T <- exp(d) T, one trial per
    iteration; a rejected trial keeps the pose. Convergence is the damped
    step being below epsilon, accepted or not.

    reassoc_displacement > 0 (requires ``r_max``, the farthest source point's
    radius) carries the correspondences until the accumulated per-point
    displacement bound exceeds that many meters, or until the loop would
    declare convergence on a stale association, which refreshes and
    re-checks instead. The terminal pose satisfies the same fixed-point
    condition as per-iteration re-association. The trial is then linearized
    in full, and the state's H, b and cost follow its pose.

    Calls an align: ungated, 1 + (iterations - 1) ``associate_linearize``
    and ``iterations`` ``cost_at``; gated, 1 + refreshes
    ``associate_linearize`` and ``iterations`` ``linearize_at``, and on a
    max-iterations exit one ``associate`` and one ``cost_at``.
    """
    gated = bool(reassoc_displacement)
    if gated and r_max is None:
        raise ValueError("reassoc_displacement > 0 requires r_max")
    if associate_linearize is None:
        raise ValueError("lm_loop requires associate_linearize")
    with GLOBAL_TIMER.span("align"):
        select = select or _select_rows
        s, corr, lin, lam0 = _lm_init(associate_linearize, guess, lm_init_lambda_factor)
        it = refreshes = 0
        converged = False
        if not gated:
            while it < max_iterations and not converged:
                if it:  # the first step's association is _lm_init's, at the same pose
                    corr, lin = associate_linearize(s.T)
                s, _, _, _ = _lm_step(s, lin, corr, cost_at, transformation_epsilon)
                it += 1
                converged = bool(s.converged)  # host sync: one per iteration
        else:
            disp = torch.zeros_like(lam0)
            while it < max_iterations and not converged:
                s2, d, accept, trial = _lm_step(s, lin, corr, linearize_at, transformation_epsilon)
                lin = select(accept, trial, lin)  # the linearization at s2.T
                it += 1
                s, refresh, disp = _lm_gate(s, s2, d, accept, disp, r_max, reassoc_displacement, lam0)
                converged, do_refresh = torch.stack([s.converged, refresh]).tolist()  # host sync
                if do_refresh:
                    refreshes += 1
                    corr, lin = associate_linearize(s.T)
            if not converged:
                # honest error on a max-iterations exit: the last cost may have
                # been evaluated under a stale association
                s = s._replace(error=cost_at(s.T, associate(s.T)))
        GLOBAL_TIMER.count("lm_iterations", it)
        GLOBAL_TIMER.count("lm_reassociations", refreshes)
        GLOBAL_TIMER.count("host_sync.lm_loop", it)
        GLOBAL_TIMER.count_copies("lm_iteration_count", guess.device)
        return AlignResult(
            transformation=s.T,
            converged=s.converged,
            iterations=torch.tensor(it, dtype=torch.int32, device=guess.device),
            error=s.error,
            num_inliers=s.num_inliers,
        )


def _like(proto: tuple, fields: list) -> tuple:
    """``fields`` as a tuple of proto's type (a NamedTuple, or a plain tuple)."""
    return type(proto)(*fields) if hasattr(proto, "_fields") else tuple(fields)


def _select_rows(cond: torch.Tensor, new: tuple, old: tuple) -> tuple:
    """Per field, rows of ``new`` where the (B,) or () ``cond`` holds, else
    ``old``."""
    return _like(new, [torch.where(cond.reshape(cond.shape + (1,) * (a.ndim - cond.ndim)), a, b)
                       for a, b in zip(new, old)])



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
    associate_linearize=None,
    select=None,
) -> AlignResult:
    """``lm_loop`` over B problems with guesses (B, 4, 4), the same trial
    and gate on every row.

    - ``associate(T) -> corr``, ``associate_linearize(T) -> (corr, (H, b,
      cost, num_inliers))``, ``linearize_at(T, corr) -> (H, b, cost,
      num_inliers)`` and ``cost_at(T, corr) -> cost`` over the whole batch,
      every field with the batch as its leading dimension; ``select`` as
      in ``lm_loop``.

    A problem is live while it has not converged and has run fewer than
    max_iterations; the step is computed for the whole batch and kept only
    where live, so a finished problem's state (and its iteration count) is
    frozen as under jax.vmap. ``r_max`` is (B,) when gated. A re-association
    runs on the whole batch, and the problems that re-associate take their
    correspondences, H, b and cost from it (the other rows' are carried):
    every linearization has the batch's shape, so a row's bits do not depend
    on which rows refreshed.
    """
    gated = bool(reassoc_displacement)
    if gated and r_max is None:
        raise ValueError("reassoc_displacement > 0 requires r_max")
    if associate_linearize is None:
        raise ValueError("lm_loop_batched requires associate_linearize")
    with GLOBAL_TIMER.span("align_batched"):
        select = select or _select_rows
        dev = guess.device
        s, corr, lin, lam0 = _lm_init(associate_linearize, guess, lm_init_lambda_factor)
        it = torch.zeros_like(lam0, dtype=torch.int32)
        live = torch.ones_like(lam0, dtype=torch.bool)
        disp = torch.zeros_like(lam0)
        passes = 0
        for _ in range(max_iterations):
            passes += 1
            s2, d, accept, trial = _lm_step(s, lin, corr, linearize_at if gated else cost_at, transformation_epsilon)
            if gated:
                s2, refresh, disp_next = _lm_gate(s, s2, d, accept, disp, r_max, reassoc_displacement, lam0)
                disp = torch.where(live, disp_next, disp)
                do_refresh = live & refresh
                lin = select(live & accept, trial, lin)  # the linearization at each row's s.T
            s = _select_rows(live, s2, s)
            it = it + live.to(it.dtype)
            live = ~s.converged & (it < max_iterations)
            # host sync: one flag vector per iteration. Gated, the problems whose
            # own refresh fired re-associate; otherwise every live one does.
            flags = torch.stack([live, do_refresh] if gated else [live, live]).cpu()
            if not bool(flags[0].any()):
                break
            if bool(flags[1].any()):
                GLOBAL_TIMER.count_copies("lm_loop_batched_rows", dev)
                rows = flags[1].to(dev)
                fresh, fresh_lin = associate_linearize(s.T)
                corr, lin = _select_rows(rows, fresh, corr), select(rows, fresh_lin, lin)
        GLOBAL_TIMER.count("lm_iterations_batched", passes)
        GLOBAL_TIMER.count("host_sync.lm_loop_batched", passes)
        if gated:
            GLOBAL_TIMER.count("host_sync.lm_loop_batched_exit")
        if gated and not bool(s.converged.all()):
            # honest error on a max-iterations exit, per problem
            fresh = cost_at(s.T, associate(s.T))
            s = s._replace(error=torch.where(s.converged, s.error, fresh))
        return AlignResult(transformation=s.T, converged=s.converged, iterations=it, error=s.error,
                           num_inliers=s.num_inliers)
