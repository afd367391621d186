"""The plain reference that decides ``correct``: plain PyTorch and NumPy,
written from the published algorithms. It imports neither JAX, nor the JAX
package, nor the PyTorch port it judges, and takes nothing the program made:
it works the clouds, covariances, correspondences, floors, information
matrices and solves out again from the scans the benchmark cast. It reads
the program's outputs (poses, floor planes) only to judge them, and the
program's state (which keyframe a frame matched, which keyframes the graph
holds) to follow it step by step.
"""

from __future__ import annotations

import contextlib

import torch


_TF32 = [False]  # the products' operands rounded to TF32 (the control)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest even) when the
    control is on, else x: what a tensor-core product in TF32 does to each
    float32 operand before it multiplies (cuBLAS keeps products of very
    few columns, such as the searches' 4, on float32 units, so the
    rounding is made here)."""
    if not _TF32[0] or x.dtype != torch.float32:
        return x
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x0FFF + ((u >> 13) & 1)) & 0xFFFFE000
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32).view(torch.float32)


@contextlib.contextmanager
def precision(tf32: bool = False):
    """float32 products with TF32 off (the configuration's precision), or
    in TF32: the control, the nearest precision below."""
    saved = torch.get_float32_matmul_precision(), _TF32[0]
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    _TF32[0] = tf32
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        _TF32[0] = saved[1]
