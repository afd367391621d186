"""The roofline yardstick: the least time the published H100 could take for
a kernel call, from the bytes every implementation must move and, where
the problem fixes them, the operations it must do.

Bytes count each input byte read once and each output byte written once.
The searches (``nn1``, ``knn_select`` and their batched forms) and
``radius_count`` are bounded by bytes alone: how many distance tests a
search needs depends on its algorithm (a grid or a tree tests few of the
pairs a brute-force scan tests), so no pair count enters their bound.
``gicp_step_work`` counts the GICP step's bytes and operations from the
rows it is given and the rows its gate keeps.

Peaks: NVIDIA's H100 SXM data sheet, at its 700 W power limit: 3.35 TB/s of
HBM3 and 67 TFLOP/s of float32 outside the tensor cores. A card set to a
lower power limit (the result line's ``power_limit_w``) runs below them.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# fp32 operations per row: the association (R C, (R C) R^T + C_tgt, the
# adjugate and determinant, the reciprocal and scaling, the gate: 155), a
# valid row's linearization (transform, error, M e, cost, b, M S, S M S, the
# 21 H sums: 142) and its cost alone (transform, error, M e, cost: 46)
GICP_ASSOC_OPS_PER_ROW, GICP_LIN_OPS_PER_ROW, GICP_COST_OPS_PER_ROW = 155, 142, 46
# the forms of the GICP step kernel, in its launch argument's numbering
ASSOCIATE, FUSED, LINEARIZE, COST = range(4)


def search_bytes(n: int, m: int, k: int) -> int:
    """A k-nearest search of n query rows among m target rows (float32 xyz):
    both clouds read once, an int32 index and a float32 distance written
    per neighbour."""
    return 12 * n + 12 * m + 8 * n * k


def radius_count_bytes(n: int, m: int) -> int:
    """Neighbours within a radius: both clouds read once, an int32 count written per query."""
    return 12 * n + 12 * m + 4 * n


def gicp_step_work(form: int, w: dict, found_gate: bool = False) -> tuple:
    """(bytes, fp32 operations) of one GICP step launch on ``w``: batch
    (problems), rows (batch x source rows), valid (rows the gate keeps),
    named (distinct target rows the rows name, summed over problems),
    named_valid (those valid rows name). The association reads each pose
    (64 B) and count slot (4), per row the source covariance (36), the index
    (4), the gate inputs (distance and mask 5, or a found flag 1) and writes
    its weight (36), and reads each named target row's covariance and mask
    (37, or 36). The linearization and the cost read the pose, each row's
    weight (36), each valid row's point and index (16) and each target
    point a valid row names (12), and write 43 floats a problem (the cost
    alone 1). The fused form moves the association's bytes and the
    linearization's points, without reading the weights back."""
    b, rows, valid = w["batch"], w["rows"], w["valid"]
    assoc = (64 + 4) * b + rows * (36 + 4 + (1 if found_gate else 5) + 36) + w["named"] * (36 if found_gate else 37)
    if form == ASSOCIATE:
        return assoc, rows * GICP_ASSOC_OPS_PER_ROW
    if form == FUSED:
        return (assoc + 4 * 43 * b + 12 * valid + 12 * w["named_valid"],
                rows * GICP_ASSOC_OPS_PER_ROW + valid * GICP_LIN_OPS_PER_ROW)
    cost_only = form == COST
    nbytes = (64 + 4 * (1 if cost_only else 43)) * b + 36 * rows + 16 * valid + 12 * w["named_valid"]
    return nbytes, valid * (GICP_COST_OPS_PER_ROW if cost_only else GICP_LIN_OPS_PER_ROW)


def bound_s(nbytes: float, ops: float = 0.0) -> float:
    """The least time at the published peaks: the larger of the two."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS)


def share_pct(bound_seconds: float, device_seconds: float):
    """Bound over measured device time, in %; None where nothing ran."""
    if device_seconds <= 0.0:
        return None
    return 100.0 * bound_seconds / device_seconds
