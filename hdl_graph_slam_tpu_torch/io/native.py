"""ctypes bindings for the native host-side ingest kernels (native/src/
ingest.cpp): PointCloud2 extraction, hash voxel pre-reduction, distance
filter. Auto-builds with make on first use; every entry point has a pure
NumPy fallback so the framework works without a toolchain.

A copy of hdl_graph_slam_tpu/io/native.py: a host ingest helper that still
builds the repository's own native/ directory; no device path depends on it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_LIB_PATH = os.path.join(_REPO_ROOT, "native", "lib", "libhdl_ingest.so")
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(
                ["make", "-C", os.path.join(_REPO_ROOT, "native")],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.pc2_extract.restype = ctypes.c_int
    lib.pc2_extract.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.voxel_downsample.restype = ctypes.c_int
    lib.voxel_downsample.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_void_p, ctypes.c_int32,
    ]
    lib.distance_filter.restype = ctypes.c_int
    lib.distance_filter.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def pc2_extract(data: bytes, n_points: int, point_step: int, x_off: int, y_off: int, z_off: int,
                i_off: int = -1) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Native PointCloud2 field extraction with NaN filtering."""
    lib = _load()
    buf = np.frombuffer(data, dtype=np.uint8)
    if lib is None:
        # numpy fallback: strided views
        arr = buf[: n_points * point_step].reshape(n_points, point_step)
        x = arr[:, x_off : x_off + 4].copy().view(np.float32).reshape(-1)
        y = arr[:, y_off : y_off + 4].copy().view(np.float32).reshape(-1)
        z = arr[:, z_off : z_off + 4].copy().view(np.float32).reshape(-1)
        xyz = np.stack([x, y, z], axis=1)
        inten = None
        if i_off >= 0:
            inten = arr[:, i_off : i_off + 4].copy().view(np.float32).reshape(-1)
        good = np.isfinite(xyz).all(axis=1)
        return xyz[good], (inten[good] if inten is not None else None)
    out_xyz = np.empty((n_points, 3), dtype=np.float32)
    out_inten = np.empty((n_points,), dtype=np.float32) if i_off >= 0 else None
    m = lib.pc2_extract(
        buf.ctypes.data, n_points, point_step, x_off, y_off, z_off, i_off,
        out_xyz.ctypes.data,
        out_inten.ctypes.data if out_inten is not None else None,
    )
    return out_xyz[:m], (out_inten[:m] if out_inten is not None else None)


def voxel_downsample(xyz: np.ndarray, resolution: float, cap: int = 1 << 18) -> np.ndarray:
    """Host-side voxel-centroid pre-reduction (pcl::VoxelGrid semantics)."""
    xyz = np.ascontiguousarray(xyz, dtype=np.float32).reshape(-1, 3)
    lib = _load()
    if lib is None:
        # numpy fallback via lexsorted keys
        keys = np.floor(xyz / resolution).astype(np.int64)
        _, inv = np.unique(keys, axis=0, return_inverse=True)
        sums = np.zeros((inv.max() + 1, 3), dtype=np.float64)
        np.add.at(sums, inv, xyz)
        counts = np.bincount(inv)
        return (sums / counts[:, None]).astype(np.float32)
    out = np.empty((cap, 3), dtype=np.float32)
    m = lib.voxel_downsample(xyz.ctypes.data, xyz.shape[0], resolution, out.ctypes.data, cap)
    if m < 0:
        raise RuntimeError("voxel_downsample: capacity overflow")
    return out[:m]


def distance_filter(xyz: np.ndarray, near: float, far: float) -> np.ndarray:
    xyz = np.ascontiguousarray(xyz, dtype=np.float32).reshape(-1, 3)
    lib = _load()
    if lib is None:
        d2 = np.sum(xyz * xyz, axis=1)
        return xyz[(d2 > near * near) & (d2 < far * far)]
    out = np.empty_like(xyz)
    m = lib.distance_filter(xyz.ctypes.data, xyz.shape[0], near, far, out.ctypes.data)
    return out[:m]
