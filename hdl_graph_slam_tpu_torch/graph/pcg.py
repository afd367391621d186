"""Matrix-free Jacobi-preconditioned conjugate gradient for the LM step
(port of hdl_graph_slam_tpu/graph/pcg.py).

The Gauss-Newton product

    H x = sum_e J_e^T (w_e Omega_e) J_e x_e

never forms H: each CG iteration gathers the edges' dof blocks, multiplies
through the stored (J, w Omega) blocks and scatter-adds them back
(``index_put_`` with accumulation, as graph/linearize.py assembles H).
The preconditioner is the diagonal of H plus the damping. The blocks come
from the linearization pass of linearize.py (``_edge_terms``).

The JAX ``lax.while_loop`` becomes a Python loop: the host reads ||r|| every
``CHECK_EVERY`` iterations, and the state is frozen once the loop's
condition fails, so the iterations between two reads change nothing and
the result is the JAX loop's.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..utils.metrics import GLOBAL_TIMER
from .linearize import _DOF, _edge_terms, _offsets
from .types import EDGE_SPECS, GraphData

CHECK_EVERY = 8  # CG iterations between two host reads of the residual norm


class EdgeBlocks(NamedTuple):
    J1: torch.Tensor  # (E, d, dof1)
    J2: Optional[torch.Tensor]  # (E, d, dof2) or None
    wOmega: torch.Tensor  # (E, d, d) robust-weighted information
    rows1: torch.Tensor  # (E, dof1) global dof indices
    rows2: Optional[torch.Tensor]


class LinearizedSystem(NamedTuple):
    blocks: Dict[str, EdgeBlocks]
    b: torch.Tensor  # (D,) gradient (J^T w Omega r)
    diag_blocks: torch.Tensor  # (D,) diagonal of H (for the preconditioner)
    chi2_robust: torch.Tensor


def linearize_blocks(data: GraphData) -> LinearizedSystem:
    """One linearization pass keeping the per-edge blocks (no dense H)."""
    D = data.num_dof
    dtype, dev = data.poses.dtype, data.poses.device
    off = _offsets(data)
    b = torch.zeros((D,), dtype=dtype, device=dev)
    diag = torch.zeros((D,), dtype=dtype, device=dev)
    chi2_rob = torch.zeros((), dtype=dtype, device=dev)
    blocks: Dict[str, EdgeBlocks] = {}
    for etype, table in data.edges.items():
        if table.vi.shape[0] == 0:
            continue
        kinds = EDGE_SPECS[etype][0]
        r, J1, J2, _, rho0, w = _edge_terms(etype, table, data)
        chi2_rob = chi2_rob + rho0.sum()
        wi = table.info * w[:, None, None]
        d1 = _DOF[kinds[0]]
        rows1 = off[kinds[0]] + d1 * table.vi[:, None] + torch.arange(d1, device=dev)[None, :]
        b.index_put_((rows1,), torch.einsum("eia,eij,ej->ea", J1, wi, r), accumulate=True)
        diag.index_put_((rows1,), torch.einsum("eia,eij,eja->ea", J1, wi, J1), accumulate=True)
        rows2 = None
        if J2 is not None:
            d2 = _DOF[kinds[1]]
            rows2 = off[kinds[1]] + d2 * table.vj[:, None] + torch.arange(d2, device=dev)[None, :]
            b.index_put_((rows2,), torch.einsum("eia,eij,ej->ea", J2, wi, r), accumulate=True)
            diag.index_put_((rows2,), torch.einsum("eia,eij,eja->ea", J2, wi, J2), accumulate=True)
        blocks[etype] = EdgeBlocks(J1=J1, J2=J2, wOmega=wi, rows1=rows1, rows2=rows2)
    return LinearizedSystem(blocks=blocks, b=b, diag_blocks=diag, chi2_robust=chi2_rob)


def hv(sys: LinearizedSystem, x: torch.Tensor, lam: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    """(H + lam I) x restricted to the free dofs (``free`` as 0/1 floats),
    matrix-free."""
    xf = x * free
    y = torch.zeros_like(x)
    for blk in sys.blocks.values():
        u = torch.einsum("eia,ea->ei", blk.J1, xf[blk.rows1])
        if blk.J2 is not None:
            u = u + torch.einsum("eia,ea->ei", blk.J2, xf[blk.rows2])
        wu = torch.einsum("eij,ej->ei", blk.wOmega, u)
        y.index_put_((blk.rows1,), torch.einsum("eia,ei->ea", blk.J1, wu), accumulate=True)
        if blk.J2 is not None:
            y.index_put_((blk.rows2,), torch.einsum("eia,ei->ea", blk.J2, wu), accumulate=True)
    return (y + lam * xf) * free


def _safe(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() < 1e-30, 1e-30, x)


def solve_pcg(sys: LinearizedSystem, lam: torch.Tensor, free: torch.Tensor, max_cg_iters: int = 250,
              tol: float = 1e-8) -> torch.Tensor:
    """Solve (H + lam I) dx = -b over the free dofs (bool ``free``) with
    Jacobi preconditioning, from dx = 0, until ||r|| <= tol max(||b||, 1e-12)
    or ``max_cg_iters`` iterations."""
    freef = free.to(sys.b.dtype)
    b = -sys.b * freef
    Minv = freef / torch.clamp(sys.diag_blocks + lam, min=1e-12)
    x = torch.zeros_like(b)
    r = b
    z = Minv * r
    p = z
    rz = torch.dot(r, z)
    thresh = tol * torch.clamp(torch.linalg.norm(b), min=1e-12)
    live = torch.linalg.norm(r) > thresh
    for i in range(max_cg_iters):
        Ap = hv(sys, p, lam, freef)
        alpha = rz / _safe(torch.dot(p, Ap))
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z_n = Minv * r_n
        rz_n = torch.dot(r_n, z_n)
        p_n = z_n + rz_n / _safe(rz) * p
        # frozen once the loop's condition fails, as the while_loop stops
        x, r, z, p, rz = (torch.where(live, a, c) for a, c in ((x_n, x), (r_n, r), (z_n, z), (p_n, p), (rz_n, rz)))
        live = live & (torch.linalg.norm(r) > thresh)
        if (i + 1) % CHECK_EVERY == 0:
            GLOBAL_TIMER.count("host_sync.pcg_live")
            if not bool(live):  # host sync
                break
    return x
