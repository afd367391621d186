"""GICP (plane-to-plane ICP) with fast_gicp::FastGICP semantics
(port of hdl_graph_slam_tpu/registration/gicp.py).

Reference usage: src/hdl_graph_slam/registrations.cpp:27-35 (FAST_GICP is
the launch default).

- Per-point covariances from the k=20 nearest neighbours (the knn_select
  kernel on the card), eigenvalues regularized to (1e-3, 1, 1);
- per iteration: 1-NN correspondences of the transformed source in the
  target (the nn1 kernel on the card), gated by max_correspondence_distance;
  Mahalanobis weight M_i = (C_b + R C_a R^T)^-1; residual e_i = b - T a;
- Levenberg-Marquardt on SE(3) with Nielsen damping (base.lm_loop).

The association's Mahalanobis and the linearization are one hand-written
Hopper kernel in four forms (csrc/gicp.cu ``gicp_step_kernel``), each with
its plain PyTorch twin here:

- ``associate``: after the correspondence search, the gate and
  M = inv3x3(C_tgt[idx] + R C_src R^T) per source row, and the valid count
  (VGICP's voxel association ends here too);
- ``linearize``: H = sum J^T M J, b = sum J^T M e and the cost at a pose
  under carried correspondences, J never formed;
- ``associate_linearize``: both at one pose in one launch, the two calls'
  bits (Mw written once, never read back): every association of the LM
  loop;
- ``cost``: the cost alone, the full call's bits: the LM trial without
  carried correspondences.

A wrapper runs its plain twin only for CPU tensors; on CUDA tensors it
checks its inputs and launches its kernel or raises. ``align`` checks once
and launches through a ``Prepared`` call. Each form counts its launches in
``<wrapper>.launches``.

Every function takes a leading batch on the source as well: that is the loop
detector's form, B candidate sources (each its own k=20 query, one
``knn_select_batched`` launch) aligned against one shared target (the B
sources' 1-NN queries go to one ``nn1`` launch), with the LM semantics of
``jax.vmap`` over ``align`` (base.lm_loop_batched).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional, Union

import torch

from .. import kernels
from ..core import se3
from ..core.cloud import PointCloud
from ..ops import knn
from ..ops.eig3 import plane_regularize
from .base import AlignResult, _select_rows, lm_loop, lm_loop_batched


@dataclasses.dataclass(frozen=True)
class GicpCloud:
    """A cloud preprocessed for GICP: points + regularized covariances."""

    xyz: torch.Tensor  # (N, 3)
    mask: torch.Tensor  # (N,)
    covs: torch.Tensor  # (N, 3, 3)


def _regularize_covs_plane(covs: torch.Tensor) -> torch.Tensor:
    """fast_gicp RegularizationMethod::PLANE: eigenvalues -> (1e-3, 1, 1)."""
    return plane_regularize(covs + 1e-9 * torch.eye(3, dtype=covs.dtype, device=covs.device))


def preprocess(cloud: PointCloud, k: int = 20) -> GicpCloud:
    """Per-point regularized covariances from the k nearest neighbours
    (fast_gicp calculate_covariances; k = correspondence_randomness).
    cloud.xyz is (N, 3), or (B, N, 3) for B clouds in one launch.

    The neighbour set is exact (knn_select). The JAX package's default uses
    the 0.85-recall knn_approx, of which the exact set is a superset; its
    exact=True path and its CPU runs select the same sets."""
    xyz = cloud.valid_xyz()
    # each cloud is its own query, in voxel-key order: the kernel's fast case
    if xyz.ndim == 2:
        idx, _ = knn.knn_select(xyz, xyz, k)
        nbrs = xyz[idx]  # (N, k, 3)
    else:
        idx, _ = knn.knn_select_batched(xyz, xyz, k)
        nbrs = xyz[torch.arange(xyz.shape[0], device=xyz.device)[:, None, None], idx.long()]  # (B, N, k, 3)
    centered = nbrs - nbrs.mean(dim=-2, keepdim=True)
    covs = torch.einsum("...ki,...kj->...ij", centered, centered) / k
    covs = _regularize_covs_plane(covs)
    eye = torch.eye(3, dtype=covs.dtype, device=covs.device)
    covs = torch.where(cloud.mask[..., None, None], covs, eye)
    return GicpCloud(xyz=cloud.xyz, mask=cloud.mask, covs=covs)


def _inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate/determinant), |det| clamped
    at 1e-20."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(det.abs() < 1e-20, 1e-20, det)
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), (b * f - c * e)], dim=-1),
            torch.stack([B, (a * i - c * g), -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), (a * e - b * d)], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


class GicpCorr(NamedTuple):
    """Fixed correspondence state for one linearization (fast_gicp
    update_correspondences): target indices, gated Mahalanobis, count."""

    idx: torch.Tensor  # (N,) int32 target index per source point
    Mw: torch.Tensor  # (N, 3, 3) gated mahalanobis (zeroed for invalid)
    num: torch.Tensor  # () int32 valid count


class DistanceGate(NamedTuple):
    """GICP's correspondence gate: src.mask & tgt_mask[idx] & (d2 <
    max_corr_dist^2), from the 1-NN search's squared distances d2."""

    d2: torch.Tensor  # (N,) float32
    tgt_mask: torch.Tensor  # (M,) bool
    max_corr_dist: float


def _moved(T: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """T (..., 4, 4) applied to the points xyz (..., N, 3)."""
    return xyz @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def _rotate_covs(R: torch.Tensor, covs: torch.Tensor) -> torch.Tensor:
    """R C R^T for R (..., 3, 3) and covariances C (..., N, 3, 3): each
    entry of R C, then of (R C) R^T, a left-to-right sum of three products,
    the order the association kernel rounds in."""
    Rb = R[..., None, :, :]
    RC = Rb[..., :, 0:1] * covs[..., 0:1, :] + Rb[..., :, 1:2] * covs[..., 1:2, :] + Rb[..., :, 2:3] * covs[..., 2:3, :]
    Rt = Rb[..., None, :, :]  # R[l, k] at [..., 0, l] of Rt[..., k]
    return (RC[..., :, 0:1] * Rt[..., :, 0] + RC[..., :, 1:2] * Rt[..., :, 1]
            + RC[..., :, 2:3] * Rt[..., :, 2])


def associate_plain(T: torch.Tensor, src: GicpCloud, tgt_covs: torch.Tensor, idx: torch.Tensor,
                    gate: Union[DistanceGate, torch.Tensor]) -> GicpCorr:
    """Plain twin of ``associate``."""
    if isinstance(gate, DistanceGate):
        valid = src.mask & gate.tgt_mask[idx] & (gate.d2 < gate.max_corr_dist * gate.max_corr_dist)
    else:
        valid = gate
    Mw = _inv3x3(tgt_covs[idx] + _rotate_covs(T[..., :3, :3], src.covs)) * valid.to(T.dtype)[..., None, None]
    return GicpCorr(idx=idx, Mw=Mw, num=valid.sum(-1, dtype=torch.int32))


def linearize_plain(T: torch.Tensor, corr: GicpCorr, src: GicpCloud, tgt_xyz: torch.Tensor):
    """Plain twin of ``linearize``; its cost is ``cost_plain``'s arithmetic."""
    moved = _moved(T, src.xyz)
    e = tgt_xyz[corr.idx] - moved  # (..., N, 3)
    # J_i = d e / d [v, w] for the left-multiplied increment exp([v,w]) T:
    # e(delta) ~= e - v - w x (T a)  =>  J = [-I | skew(moved)]
    skew = se3.hat(moved)  # (..., N, 3, 3)
    J = torch.cat([-torch.eye(3, dtype=T.dtype, device=T.device).expand(skew.shape), skew], dim=-1)
    MJ = corr.Mw @ J  # (..., N, 3, 6)
    H = torch.einsum("...nji,...njk->...ik", J, MJ)
    Me = (corr.Mw @ e[..., None])[..., 0]  # (..., N, 3)
    b = torch.einsum("...nji,...nj->...i", J, Me)
    cost = (e * Me).sum((-1, -2))
    return H, b, cost, corr.num


def cost_plain(T: torch.Tensor, corr: GicpCorr, src: GicpCloud, tgt_xyz: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``cost``."""
    e = tgt_xyz[corr.idx] - _moved(T, src.xyz)
    return (e * (corr.Mw @ e[..., None])[..., 0]).sum((-1, -2))


def associate_linearize_plain(T: torch.Tensor, src: GicpCloud, tgt_covs: torch.Tensor, tgt_xyz: torch.Tensor,
                              idx: torch.Tensor, gate: Union[DistanceGate, torch.Tensor]):
    """Plain twin of ``associate_linearize``: associate_plain, then
    linearize_plain at the same poses."""
    corr = associate_plain(T, src, tgt_covs, idx, gate)
    return corr, linearize_plain(T, corr, src, tgt_xyz)


# -- the launches (csrc/gicp.cu) ---------------------------------------------------------

# gicp.cu's forms (enum Form), its threads a block (a row each) and the
# doubles of a block's row in the scratch
ASSOCIATE, FUSED, LINEARIZE, COST = range(4)
_THREADS = 128
_ROW = 32


def _layout(n: int) -> tuple:
    """gicp.cu layout_for: (blocks a problem, rows a block) over n rows."""
    blocks = max(-(-n // _THREADS), 1)
    return blocks, max((-(-n // blocks) + 3) // 4 * 4, 4)


class GicpArgs(ctypes.Structure):
    """gicp.cu's struct GicpArgs, field for field."""

    _fields_ = ([(f, ctypes.c_void_p) for f in ("T", "xyz", "covs", "idx", "d2", "smask", "tmask", "found",
                                                 "tgt_covs", "tgt_xyz", "Mw", "num", "out", "tickets", "partial")]
                + [("max_d2", ctypes.c_float)]
                + [(f, ctypes.c_int) for f in ("batch", "n", "form", "blocks", "span")])


def _check(name: str, T: torch.Tensor, *tensors: torch.Tensor) -> None:
    """What the kernels take: float32 poses (4, 4) or (B <= 65535, 4, 4) and
    every tensor on their device."""
    if T.dtype != torch.float32 or T.shape[-2:] != (4, 4) or T.ndim not in (2, 3):
        raise ValueError(f"{name}: poses must be (4, 4) or (B, 4, 4) float32, got {tuple(T.shape)} {T.dtype}")
    if T.ndim == 3 and not 0 < T.shape[0] <= 65535:
        raise ValueError(f"{name}: batch {T.shape[0]} outside 1..65535")
    devices = {x.device for x in tensors}
    if devices != {T.device}:
        raise ValueError(f"{name}: tensors on {sorted(map(str, devices))}, poses on {T.device}")


class Prepared:
    """The GICP launches of one align: B problems of n source rows ``src``
    ((N, ...) for one problem, (B, N, ...) for a batch) against one target:
    its covariances ``tgt_covs`` (M, 3, 3) for the associating forms, its
    points ``tgt_xyz`` (M, 3) for the linearizing ones, GICP's
    ``tgt_mask`` (M,) and ``max_corr_dist``, or VGICP's found flags when
    ``tgt_mask`` is None. Shapes, dtypes and devices are checked here, once.
    The calls take poses T shaped as the sources' batch (contiguous float32)
    and the search's idx (int32) and gate flags (GICP's d2, VGICP's found)
    shaped as src.mask, contiguous, and launch with no check: one ctypes
    call of ``hgs_gicp_step`` on arguments set up here, on the stream and
    scratch of the construction, into outputs in rings of two slots made at
    first use.

    A linearization on the card is (H, b, cost, num_inliers, rows): H, b and
    cost are views of the (B, 43) ``rows`` the kernel writes, which only
    ``select`` reads. A result stays valid until the second later call of
    its kind: H / b / cost of ``associate_linearize`` and ``linearize``;
    the cost alone; Mw / num of ``associate_linearize``; Mw / num of
    ``associate``, whose ring is its own so that the honest error of a
    max-iterations exit leaves the last step's count in place. That is all
    the LM loop holds. On the CPU every call is its plain twin. Each launch
    counts on its public wrapper (``associate_linearize``, ``associate``,
    ``linearize``, ``cost``)."""

    def __init__(self, src: GicpCloud, tgt_covs: Optional[torch.Tensor], tgt_xyz: Optional[torch.Tensor],
                 tgt_mask: Optional[torch.Tensor] = None, max_corr_dist: float = 0.0):
        self.src, self.tgt_covs, self.tgt_xyz = src, tgt_covs, tgt_xyz
        self.tgt_mask, self.max_corr_dist = tgt_mask, max_corr_dist
        self.one = src.xyz.ndim == 2
        self.cpu = src.xyz.device.type == "cpu"
        self.b, self.n = (1,) * self.one + tuple(src.mask.shape)
        self.device = src.xyz.device
        self._rings: dict = {}
        if self.cpu:
            return
        xyz, mask, covs = ((x[None] if self.one else x).contiguous() for x in (src.xyz, src.mask, src.covs))
        tgt = [x.contiguous() if x is not None else None for x in (tgt_covs, tgt_xyz, tgt_mask)]
        b, n = mask.shape
        m = tgt_covs.shape[0] if tgt_covs is not None else tgt_xyz.shape[0]
        given = [x for x in [xyz, mask, covs] + tgt if x is not None]
        devices = {x.device for x in given}
        if (len(devices) != 1 or xyz.shape != (b, n, 3) or covs.shape != (b, n, 3, 3) or xyz.dtype != torch.float32
                or covs.dtype != torch.float32 or mask.dtype != torch.bool or not 0 < b <= 65535 or n == 0
                or (tgt_covs is not None and (tgt_covs.dtype != torch.float32 or tgt_covs.shape != (m, 3, 3)))
                or (tgt_xyz is not None and (tgt_xyz.dtype != torch.float32 or tgt_xyz.shape != (m, 3)))
                or (tgt_mask is not None and (tgt_mask.dtype != torch.bool or tgt_mask.shape != (m,)))):
            raise ValueError(f"gicp prepared: source xyz {tuple(xyz.shape)} {xyz.dtype}, mask {tuple(mask.shape)} "
                             f"{mask.dtype}, covariances {tuple(covs.shape)} {covs.dtype}; target "
                             + ", ".join(f"{tuple(x.shape)} {x.dtype}" for x in tgt if x is not None)
                             + f"; devices {sorted(map(str, devices))}")
        blocks, span = _layout(n)
        self.stream = kernels.stream(xyz)
        tickets, scratch = kernels.workspace(xyz, self.stream, "gicp", b, 2 * b * blocks * _ROW)
        self._keep = (xyz, mask, covs, *tgt, tickets, scratch)  # what the pointers below name
        a = self.args = GicpArgs()
        a.xyz, a.smask, a.covs = xyz.data_ptr(), mask.data_ptr(), covs.data_ptr()
        a.tgt_covs, a.tgt_xyz, a.tmask = (None if x is None else x.data_ptr() for x in tgt)
        a.max_d2 = max_corr_dist * max_corr_dist
        a.tickets, a.partial = tickets.data_ptr(), scratch.data_ptr()
        a.batch, a.n, a.blocks, a.span = b, n, blocks, span
        self._ref = ctypes.byref(a)
        self._step = kernels.load("gicp").hgs_gicp_step

    # -- outputs: rings of two slots, each made at its first use
    def _next(self, kind: str) -> tuple:
        ring = self._rings.get(kind)
        if ring is None:
            ring = self._rings[kind] = [[None, None], 1]
        ring[1] ^= 1
        slot = ring[0][ring[1]]
        if slot is None:
            slot = ring[0][ring[1]] = self._make(kind)
        return slot

    def _make(self, kind: str) -> tuple:
        """A slot: the tensors the kernel writes, then the views a call returns."""
        b, n, dev, one = self.b, self.n, self.device, self.one
        if kind == "lin":
            out = torch.empty((b, 43), dtype=torch.float32, device=dev)
            return (out,) + self._views(out)
        if kind == "cost":
            out = torch.empty((b,), dtype=torch.float32, device=dev)
            return out, (out[0] if one else out)
        Mw = torch.empty((b, n, 3, 3), dtype=torch.float32, device=dev)
        num = torch.empty((b,), dtype=torch.int32, device=dev)
        return Mw, num, (Mw[0] if one else Mw), (num[0] if one else num)

    def _views(self, rows: torch.Tensor) -> tuple:
        """(H, b, cost) of the kernel's (B, 43) rows, shaped as the problems."""
        H, bb, c = rows[:, 6:42].view(self.b, 6, 6), rows[:, :6], rows[:, 42]
        return (H[0], bb[0], c[0]) if self.one else (H, bb, c)

    def _launch(self, form: int, T: torch.Tensor, idx: torch.Tensor, flags: Optional[torch.Tensor],
                Mw: torch.Tensor, num: Optional[torch.Tensor], out: Optional[torch.Tensor], name: str) -> None:
        """One launch of ``form``: it reads ``flags`` (associating forms) or
        ``Mw`` (the others) and writes Mw and num (associating forms) and
        ``out`` (the others)."""
        a = self.args
        a.form, a.T, a.idx, a.Mw = form, T.data_ptr(), idx.data_ptr(), Mw.data_ptr()
        if flags is not None:
            if self.tgt_mask is None:
                a.found, a.d2 = flags.data_ptr(), None
            else:
                a.found, a.d2 = None, flags.data_ptr()
            a.num = num.data_ptr()
        if out is not None:
            a.out = out.data_ptr()
        kernels.check(self._step(self._ref, self.stream), name)

    def _plain_gate(self, flags: torch.Tensor):
        return flags if self.tgt_mask is None else DistanceGate(flags, self.tgt_mask, self.max_corr_dist)

    def associate_linearize(self, T: torch.Tensor, idx: torch.Tensor, flags: torch.Tensor):
        """(corr, (H, b, cost, num_inliers[, rows])) at T: the fused form."""
        if self.cpu:
            return associate_linearize_plain(T, self.src, self.tgt_covs, self.tgt_xyz, idx, self._plain_gate(flags))
        Mw_all, num_all, Mw, num = self._next("mw")
        out, H, bb, c = self._next("lin")
        self._launch(FUSED, T, idx, flags, Mw_all, num_all, out, "gicp associate_linearize")
        associate_linearize.launches += 1
        return GicpCorr(idx, Mw, num), (H, bb, c, num, out)

    def associate(self, T: torch.Tensor, idx: torch.Tensor, flags: torch.Tensor) -> GicpCorr:
        """The correspondence state at T: the associate-only form."""
        if self.cpu:
            return associate_plain(T, self.src, self.tgt_covs, idx, self._plain_gate(flags))
        Mw_all, num_all, Mw, num = self._next("assoc")
        self._launch(ASSOCIATE, T, idx, flags, Mw_all, num_all, None, "gicp associate")
        associate.launches += 1
        return GicpCorr(idx, Mw, num)

    def linearize(self, T: torch.Tensor, corr: GicpCorr):
        """(H, b, cost, num_inliers[, rows]) at T under the carried corr (its
        Mw contiguous, shaped as the ring's)."""
        if self.cpu:
            return linearize_plain(T, corr, self.src, self.tgt_xyz)
        out, H, bb, c = self._next("lin")
        self._launch(LINEARIZE, T, corr.idx, None, corr.Mw, None, out, "gicp linearize")
        linearize.launches += 1
        return H, bb, c, corr.num, out

    def select(self, cond: torch.Tensor, new: tuple, old: tuple) -> tuple:
        """Per field of two linearizations (H, b, cost, num_inliers[, rows])
        of these problems, ``new`` where the () or (B,) ``cond`` holds, else
        ``old`` (the LM loop's carried linearization). On the card one
        torch.where over the kernel's rows, and none for the counts when both
        are one tensor (the carried correspondences')."""
        if self.cpu:
            return _select_rows(cond, new, old)
        rows = torch.where(cond.reshape(-1, 1), new[4], old[4])
        num = new[3] if new[3] is old[3] else torch.where(cond, new[3], old[3])
        return self._views(rows) + (num, rows)

    def cost(self, T: torch.Tensor, corr: GicpCorr) -> torch.Tensor:
        """The cost of ``linearize`` alone, its bits."""
        if self.cpu:
            return cost_plain(T, corr, self.src, self.tgt_xyz)
        out, c = self._next("cost")
        self._launch(COST, T, corr.idx, None, corr.Mw, None, out, "gicp cost")
        cost.launches += 1
        return c


def _gate_parts(name: str, T: torch.Tensor, src: GicpCloud, idx: torch.Tensor,
                gate: Union[DistanceGate, torch.Tensor]):
    """The per-call checks of an associating wrapper: (tgt_mask,
    max_corr_dist, flags) of the gate."""
    dist = isinstance(gate, DistanceGate)
    flags = gate.d2 if dist else gate
    if (idx.dtype != torch.int32 or idx.shape != src.mask.shape or flags.shape != src.mask.shape
            or flags.dtype != (torch.float32 if dist else torch.bool) or T.shape[:-2] != src.mask.shape[:-1]):
        raise ValueError(f"{name}: idx {tuple(idx.shape)} {idx.dtype}, gate {tuple(flags.shape)} {flags.dtype}, "
                         f"source mask {tuple(src.mask.shape)}, poses {tuple(T.shape)}")
    return (gate.tgt_mask, gate.max_corr_dist, flags) if dist else (None, 0.0, flags)


def associate(T: torch.Tensor, src: GicpCloud, tgt_covs: torch.Tensor, idx: torch.Tensor,
              gate: Union[DistanceGate, torch.Tensor]) -> GicpCorr:
    """The correspondence state at the poses T (4, 4) or (B, 4, 4) of the
    sources (N, ...) or (B, N, ...), after the search named idx (int32) in
    the target: the gate (a DistanceGate for GICP, the voxel lookup's
    ``found`` flags for VGICP), M = inv3x3(tgt_covs[idx] + R C_src R^T)
    zeroed where the gate fails, and the valid count (the associate-only
    form of ``gicp_step_kernel`` on the card: one launch, the plain twin's
    bits)."""
    dist = isinstance(gate, DistanceGate)
    _check("gicp associate", T, src.covs, src.mask, tgt_covs, idx, gate.d2 if dist else gate,
           *([gate.tgt_mask] if dist else []))
    if T.device.type == "cpu":
        return associate_plain(T, src, tgt_covs, idx, gate)
    tgt_mask, max_corr_dist, flags = _gate_parts("gicp associate", T, src, idx, gate)
    prep = Prepared(src, tgt_covs, None, tgt_mask, max_corr_dist)
    return prep.associate(T.contiguous(), idx.contiguous(), flags.contiguous())


associate.launches = 0


def associate_linearize(T: torch.Tensor, src: GicpCloud, tgt_covs: torch.Tensor, tgt_xyz: torch.Tensor,
                        idx: torch.Tensor, gate: Union[DistanceGate, torch.Tensor]):
    """``associate`` then ``linearize`` at the same poses in one launch (the
    fused form): (corr, (H, b, cost, num_inliers)), the two calls' bits."""
    dist = isinstance(gate, DistanceGate)
    _check("gicp associate_linearize", T, src.xyz, src.covs, src.mask, tgt_covs, tgt_xyz, idx,
           gate.d2 if dist else gate, *([gate.tgt_mask] if dist else []))
    if T.device.type == "cpu":
        return associate_linearize_plain(T, src, tgt_covs, tgt_xyz, idx, gate)
    tgt_mask, max_corr_dist, flags = _gate_parts("gicp associate_linearize", T, src, idx, gate)
    prep = Prepared(src, tgt_covs, tgt_xyz, tgt_mask, max_corr_dist)
    corr, lin = prep.associate_linearize(T.contiguous(), idx.contiguous(), flags.contiguous())
    return corr, lin[:4]


associate_linearize.launches = 0


def _carried(name: str, T: torch.Tensor, corr: GicpCorr, src: GicpCloud, tgt_xyz: torch.Tensor) -> Prepared:
    """The per-call checks of a wrapper under carried correspondences, and
    its prepared call."""
    _check(name, T, src.xyz, corr.idx, corr.Mw, tgt_xyz)
    if (corr.idx.dtype != torch.int32 or corr.idx.shape != src.xyz.shape[:-1] or T.shape[:-2] != src.xyz.shape[:-2]
            or corr.Mw.shape != src.xyz.shape[:-1] + (3, 3) or corr.Mw.dtype != torch.float32
            or tgt_xyz.dtype != torch.float32 or tgt_xyz.ndim != 2 or tgt_xyz.shape[-1:] != (3,)):
        raise ValueError(f"{name}: poses {tuple(T.shape)}, xyz {tuple(src.xyz.shape)} {src.xyz.dtype}, idx "
                         f"{tuple(corr.idx.shape)} {corr.idx.dtype}, Mw {tuple(corr.Mw.shape)} {corr.Mw.dtype}, "
                         f"target {tuple(tgt_xyz.shape)} {tgt_xyz.dtype}")
    return Prepared(src, None, tgt_xyz)


def linearize(T: torch.Tensor, corr: GicpCorr, src: GicpCloud, tgt_xyz: torch.Tensor):
    """H (..., 6, 6), b (..., 6), cost (...) and inliers of the carried
    correspondences at the poses T (4, 4) or (B, 4, 4) against the target
    points ``tgt_xyz`` (M, 3) (GICP's cloud, VGICP's voxel means) (the
    linearize form of ``gicp_step_kernel`` on the card: one launch)."""
    if T.device.type == "cpu":
        return linearize_plain(T, corr, src, tgt_xyz)
    prep = _carried("gicp linearize", T, corr, src, tgt_xyz)
    return prep.linearize(T.contiguous(), GicpCorr(corr.idx.contiguous(), corr.Mw.contiguous(), corr.num))[:4]


linearize.launches = 0


def cost(T: torch.Tensor, corr: GicpCorr, src: GicpCloud, tgt_xyz: torch.Tensor) -> torch.Tensor:
    """The cost of ``linearize`` alone (the cost form on the card, the full
    call's bits)."""
    if T.device.type == "cpu":
        return cost_plain(T, corr, src, tgt_xyz)
    prep = _carried("gicp cost", T, corr, src, tgt_xyz)
    return prep.cost(T.contiguous(), GicpCorr(corr.idx.contiguous(), corr.Mw.contiguous(), corr.num))


cost.launches = 0


def _correspond(T: torch.Tensor, src: GicpCloud, tgt: GicpCloud):
    """The 1-NN search at the poses T: (idx, d2) shaped as src.mask, all
    sources' queries in one nn1 launch."""
    moved_q = torch.where(src.mask[..., None], _moved(T, src.xyz), 1.0e6)
    idx, d2 = knn.nn1(moved_q.reshape(-1, 3), torch.where(tgt.mask[:, None], tgt.xyz, 1.0e6))
    return idx.reshape(src.mask.shape), d2.reshape(src.mask.shape)


def _associate(T: torch.Tensor, src: GicpCloud, tgt: GicpCloud, max_corr_dist: float) -> GicpCorr:
    """NN correspondences + Mahalanobis at pose T (fixed through LM trials):
    the search, then ``associate`` with GICP's distance gate."""
    idx, d2 = _correspond(T, src, tgt)
    return associate(T, src, tgt.covs, idx, DistanceGate(d2, tgt.mask, max_corr_dist))


def _linearize_at(T: torch.Tensor, corr: GicpCorr, src: GicpCloud, tgt: GicpCloud):
    return linearize(T, corr, src, tgt.xyz)


def _cost_at(T: torch.Tensor, corr: GicpCorr, src: GicpCloud, tgt: GicpCloud) -> torch.Tensor:
    return cost(T, corr, src, tgt.xyz)


def align(
    tgt: GicpCloud,
    src: GicpCloud,
    guess: torch.Tensor,
    max_corr_dist: float = 2.5,
    transformation_epsilon: float = 0.01,
    max_iterations: int = 64,
    lm_init_lambda_factor: float = 1e-9,
    reassoc_displacement: float = 0.0,
) -> AlignResult:
    """Align source onto target starting from ``guess`` (4x4), following
    fast_gicp's LM loop (base.lm_loop). reassoc_displacement > 0 carries the
    correspondences across iterations within that displacement budget.

    With a leading batch on the source and guess (B, 4, 4), the B sources
    align against the one target (base.lm_loop_batched): an AlignResult with
    a leading batch, whose row b is ``align(tgt, src[b], guess[b])`` up to
    float32 summation order.

    The kernels' inputs are checked once here (``Prepared``); the loop
    launches through the prepared calls."""
    prep = Prepared(src, tgt.covs, tgt.xyz, tgt.mask, max_corr_dist)
    if not prep.cpu:
        _check("gicp align", guess, src.xyz, tgt.xyz)
        guess = guess.contiguous()
    r_max = None
    if reassoc_displacement:
        r_max = torch.sqrt(torch.where(src.mask, (src.xyz * src.xyz).sum(-1), 0.0).amax(-1))
    return (lm_loop if guess.ndim == 2 else lm_loop_batched)(
        associate=lambda T: prep.associate(T, *_correspond(T, src, tgt)),
        linearize_at=prep.linearize,
        cost_at=prep.cost,
        guess=guess,
        max_iterations=max_iterations,
        transformation_epsilon=transformation_epsilon,
        lm_init_lambda_factor=lm_init_lambda_factor,
        reassoc_displacement=reassoc_displacement,
        r_max=r_max,
        associate_linearize=lambda T: prep.associate_linearize(T, *_correspond(T, src, tgt)),
        select=prep.select,
    )
