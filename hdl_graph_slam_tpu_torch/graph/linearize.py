"""Batched linearization of all edge tables into a dense (H, b) system
(port of hdl_graph_slam_tpu/graph/linearize.py).

Per edge type: the residual and its manifold Jacobians (torch.func.jacfwd
through each vertex's local increment at zero, under torch.func.vmap over
the edges, as the JAX package takes jax.jacfwd under jax.vmap), robust
reweighting (rho1 scaling of H and b), then scatter-adds of the dof blocks
into a dense H (``index_put_`` with accumulation).

State layout: [poses: 6 dof each | planes: 3 | points: 3].

The LM loop reads the edges through a ``Linearizer``: this module's
``build_system`` and ``chi2_only`` over every edge table in one place, or
(``parallel/``) the same over edge shards, their partial (H, b, chi2) summed
as the JAX package's ``axis_name`` psum sums them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.func import jacfwd, vmap

from ..core import plane as planelib
from ..core import se3
from . import edges as E
from .robust import rho_and_weight
from .types import EDGE_SPECS, EdgeTable, GraphData

# residual dispatch: fn(V1, V2_or_None, meas) -> r
_RES = {
    "se3_se3": lambda a, b, m: E.se3_se3(a, b, m),
    "se3_plane": lambda a, b, m: E.se3_plane(a, b, m),
    "se3_prior_xy": lambda a, b, m: E.se3_prior_xy(a, m),
    "se3_prior_xyz": lambda a, b, m: E.se3_prior_xyz(a, m),
    "se3_prior_vec": lambda a, b, m: E.se3_prior_vec(a, m),
    "se3_prior_quat": lambda a, b, m: E.se3_prior_quat(a, m),
    "plane_prior_normal": lambda a, b, m: E.plane_prior_normal(a, m),
    "plane_prior_distance": lambda a, b, m: E.plane_prior_distance(a, m),
    "plane_identity": lambda a, b, m: E.plane_identity(a, b, m),
    "plane_parallel": lambda a, b, m: E.plane_parallel(a, b, m),
    "plane_perpendicular": lambda a, b, m: E.plane_perpendicular(a, b),
    "se3_point_xyz": lambda a, b, m: E.se3_point_xyz(a, b, m),
}

_DOF = {"pose": 6, "plane": 3, "point": 3}


def _vertices(kind: str, data: GraphData) -> torch.Tensor:
    return {"pose": data.poses, "plane": data.planes, "point": data.points}[kind]


def _oplus(kind: str, value, delta):
    if kind == "pose":
        return se3.se3_oplus(value, delta)
    if kind == "plane":
        return planelib.oplus(value, delta)
    return value + delta


def _offsets(data: GraphData) -> Dict[str, int]:
    np_ = data.poses.shape[0]
    nl = data.planes.shape[0]
    return {"pose": 0, "plane": 6 * np_, "point": 6 * np_ + 3 * nl}


def _residuals(etype: str, table: EdgeTable, data: GraphData) -> torch.Tensor:
    """Residuals of a whole edge table at the current estimates (E, d)."""
    kinds = EDGE_SPECS[etype][0]
    V1 = _vertices(kinds[0], data)[table.vi]
    V2 = _vertices(kinds[1], data)[table.vj] if len(kinds) == 2 else None
    return _RES[etype](V1, V2, table.meas)


def _robust(r, table: EdgeTable):
    chi2 = torch.einsum("ei,eij,ej->e", r, table.info, r)
    rho0, w = rho_and_weight(chi2, table.kernel_id, table.kernel_delta)
    zero = torch.zeros((), dtype=chi2.dtype, device=chi2.device)
    return (torch.where(table.mask, chi2, zero), torch.where(table.mask, rho0, zero),
            torch.where(table.mask, w, zero))


def _edge_terms(etype: str, table: EdgeTable, data: GraphData):
    """Residual/Jacobian blocks for one edge table.

    Returns r (E,d), J1 (E,d,dof1), J2 (E,d,dof2) or None, chi2 (E,),
    rho0 (E,), w (E,) with padding-edge weights zeroed.
    """
    kinds = EDGE_SPECS[etype][0]
    rfn = _RES[etype]
    dtype, dev = data.poses.dtype, data.poses.device
    V1 = _vertices(kinds[0], data)[table.vi]
    z1 = torch.zeros(table.vi.shape[0], _DOF[kinds[0]], dtype=dtype, device=dev)

    if len(kinds) == 1:

        def one(v1, d1, meas):
            def r_of(d):
                r = rfn(_oplus(kinds[0], v1, d), None, meas)
                return r, r

            return jacfwd(r_of, has_aux=True)(d1)

        J1, r = vmap(one)(V1, z1, table.meas)
        J2 = None
    else:
        V2 = _vertices(kinds[1], data)[table.vj]
        z2 = torch.zeros(table.vj.shape[0], _DOF[kinds[1]], dtype=dtype, device=dev)

        def one(v1, v2, d1, d2, meas):
            def r_of(a, b):
                r = rfn(_oplus(kinds[0], v1, a), _oplus(kinds[1], v2, b), meas)
                return r, r

            return jacfwd(r_of, argnums=(0, 1), has_aux=True)(d1, d2)

        (J1, J2), r = vmap(one)(V1, V2, z1, z2, table.meas)

    chi2, rho0, w = _robust(r, table)
    return r, J1, J2, chi2, rho0, w


def build_system(data: GraphData) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Assemble the dense H, b over all edge tables.

    Returns (H, b, chi2_raw, chi2_robust) where b = sum w J^T info r (the
    gradient half; solve (H + lam I) dx = -b). Over a shard of the edge
    tables these are the shard's partial sums, which a ``Linearizer`` of
    ``parallel/`` adds up (the JAX package's ``axis_name`` psum).
    """
    D = data.num_dof
    dtype, dev = data.poses.dtype, data.poses.device
    H = torch.zeros((D, D), dtype=dtype, device=dev)
    b = torch.zeros((D,), dtype=dtype, device=dev)
    chi2_raw = torch.zeros((), dtype=dtype, device=dev)
    chi2_rob = torch.zeros((), dtype=dtype, device=dev)
    off = _offsets(data)

    for etype, table in data.edges.items():
        if table.vi.shape[0] == 0:
            continue
        kinds = EDGE_SPECS[etype][0]
        r, J1, J2, chi2, rho0, w = _edge_terms(etype, table, data)
        chi2_raw = chi2_raw + chi2.sum()
        chi2_rob = chi2_rob + rho0.sum()

        wi = table.info * w[:, None, None]
        d1 = _DOF[kinds[0]]
        rows1 = off[kinds[0]] + d1 * table.vi[:, None] + torch.arange(d1, device=dev)[None, :]
        blocks = [(rows1, rows1, torch.einsum("eia,eij,ejb->eab", J1, wi, J1))]
        b.index_put_((rows1,), torch.einsum("eia,eij,ej->ea", J1, wi, r), accumulate=True)
        if J2 is not None:
            d2 = _DOF[kinds[1]]
            rows2 = off[kinds[1]] + d2 * table.vj[:, None] + torch.arange(d2, device=dev)[None, :]
            H12 = torch.einsum("eia,eij,ejb->eab", J1, wi, J2)
            blocks += [(rows2, rows2, torch.einsum("eia,eij,ejb->eab", J2, wi, J2)),
                       (rows1, rows2, H12), (rows2, rows1, H12.transpose(1, 2))]
            b.index_put_((rows2,), torch.einsum("eia,eij,ej->ea", J2, wi, r), accumulate=True)
        for ra, rb, blk in blocks:
            H.index_put_((ra[:, :, None].expand_as(blk), rb[:, None, :].expand_as(blk)), blk, accumulate=True)
    return H, b, chi2_raw, chi2_rob


def chi2_only(data: GraphData) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw and robustified total chi2 without Jacobians (LM trial scoring)."""
    dtype, dev = data.poses.dtype, data.poses.device
    chi2_raw = torch.zeros((), dtype=dtype, device=dev)
    chi2_rob = torch.zeros((), dtype=dtype, device=dev)
    for etype, table in data.edges.items():
        if table.vi.shape[0] == 0:
            continue
        chi2, rho0, _ = _robust(_residuals(etype, table, data), table)
        chi2_raw = chi2_raw + chi2.sum()
        chi2_rob = chi2_rob + rho0.sum()
    return chi2_raw, chi2_rob


def free_dof_mask(data: GraphData) -> torch.Tensor:
    """(D,) bool — dofs that participate in the solve (allocated, not fixed)."""
    pf = data.pose_mask & ~data.pose_fixed
    lf = data.plane_mask & ~data.plane_fixed
    mf = data.point_mask & ~data.point_fixed
    return torch.cat([pf.repeat_interleave(6), lf.repeat_interleave(3), mf.repeat_interleave(3)])


def apply_delta(data: GraphData, dx: torch.Tensor) -> GraphData:
    """Manifold update of all vertices by the (masked) solution vector."""
    np_, nl, nm = data.poses.shape[0], data.planes.shape[0], data.points.shape[0]
    dx = torch.where(free_dof_mask(data), dx, torch.zeros((), dtype=dx.dtype, device=dx.device))
    dp = dx[: 6 * np_].reshape(np_, 6)
    dl = dx[6 * np_: 6 * np_ + 3 * nl].reshape(nl, 3)
    dm = dx[6 * np_ + 3 * nl:].reshape(nm, 3)
    return data.replace(poses=se3.se3_oplus(data.poses, dp), planes=planelib.oplus(data.planes, dl),
                        points=data.points + dm)


class Linearizer:
    """The two reads an LM iteration makes of the edges: the whole system
    and the chi2 alone. This one linearizes every edge table of the graph it
    is given, on the graph's device. ``parallel/dist.py::ShardedLinearizer``
    splits the tables into shards and returns the shards' summed (H, b,
    chi2), the same on every shard and process, so that every replica of
    the LM loop takes the same branch.

    ``capturable``: whether an LM pass through this linearizer makes only
    device work on the graph's device, with no host sync, so that
    graph/solver.py can capture it in a CUDA graph."""

    capturable = True

    def system(self, data: GraphData) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        return build_system(data)

    def chi2(self, data: GraphData) -> Tuple[torch.Tensor, torch.Tensor]:
        return chi2_only(data)
