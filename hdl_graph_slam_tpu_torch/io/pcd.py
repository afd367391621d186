"""PCD point-cloud file read/write (ascii + binary) (a copy of hdl_graph_slam_tpu/io/pcd.py).

Equivalent of the pcl::io::savePCDFileBinary / loadPCDFile calls the
reference uses for keyframe clouds and map export (keyframe.cpp:50-56,
hdl_graph_slam_nodelet.cpp:1003-1008).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_DTYPES = {("F", 4): np.float32, ("F", 8): np.float64,
           ("I", 1): np.int8, ("I", 2): np.int16, ("I", 4): np.int32,
           ("U", 1): np.uint8, ("U", 2): np.uint16, ("U", 4): np.uint32}


def save_pcd(path: str, xyz: np.ndarray, intensity: Optional[np.ndarray] = None, binary: bool = True) -> None:
    xyz = np.asarray(xyz, dtype=np.float32).reshape(-1, 3)
    n = xyz.shape[0]
    fields = ["x", "y", "z"] + (["intensity"] if intensity is not None else [])
    count = len(fields)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(fields)}\n"
        f"SIZE {' '.join(['4'] * count)}\n"
        f"TYPE {' '.join(['F'] * count)}\n"
        f"COUNT {' '.join(['1'] * count)}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    if intensity is not None:
        data = np.concatenate([xyz, np.asarray(intensity, np.float32).reshape(-1, 1)], axis=1)
    else:
        data = xyz
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(np.ascontiguousarray(data, dtype=np.float32).tobytes())
        else:
            np.savetxt(f, data, fmt="%.6f")


def load_pcd(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """-> (xyz (N,3) float32, intensity (N,) or None)."""
    with open(path, "rb") as f:
        fields, sizes, types, counts = [], [], [], []
        n_points = 0
        data_mode = "ascii"
        while True:
            line = f.readline().decode(errors="replace").strip()
            if line.startswith("#") or not line:
                continue
            key, _, rest = line.partition(" ")
            if key == "FIELDS":
                fields = rest.split()
            elif key == "SIZE":
                sizes = [int(v) for v in rest.split()]
            elif key == "TYPE":
                types = rest.split()
            elif key == "COUNT":
                counts = [int(v) for v in rest.split()]
            elif key == "POINTS":
                n_points = int(rest)
            elif key == "DATA":
                data_mode = rest
                break
        dtype = np.dtype(
            [
                (name, _DTYPES[(t, s)], (c,)) if c > 1 else (name, _DTYPES[(t, s)])
                for name, s, t, c in zip(fields, sizes, types, counts)
            ]
        )
        if data_mode == "binary":
            arr = np.frombuffer(f.read(n_points * dtype.itemsize), dtype=dtype, count=n_points)
        elif data_mode == "ascii":
            arr = np.loadtxt(f, dtype=np.float64, max_rows=n_points)
            arr = np.rec.fromarrays(arr.T[: len(fields)], dtype=np.dtype([(n, np.float64) for n in fields]))
        else:
            raise ValueError(f"unsupported PCD DATA mode: {data_mode}")
    xyz = np.stack([arr["x"], arr["y"], arr["z"]], axis=1).astype(np.float32)
    inten = arr["intensity"].astype(np.float32) if "intensity" in fields else None
    return xyz, inten
