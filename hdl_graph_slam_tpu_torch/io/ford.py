"""Ford IJRR dataset reader (a copy of hdl_graph_slam_tpu/io/ford.py).

Equivalent of src/hdl_graph_slam/ford2bag.py (GPS.log -> NavSatFix stream,
SCANS/Scan*.mat -> point clouds) — but feeding the pipeline directly instead
of writing a rosbag.

Ford .mat layout (ford2bag.py:59-68): struct ``SCAN`` with field
``XYZ`` (3, N) double in the vehicle frame and ``timestamp_laser``
microseconds.

GPS.log is a BINARY record stream (ford2bag.py:20-27): per record
``struct.unpack('qddd')`` (utime microseconds + 3 local doubles), then
``'dddd'`` (lat/lon/el/theta, radians in the raw logs), then 16 doubles of
covariance — 192 bytes per record, no header. Records with |lat| < 0.1 are
skipped like the reference (ford2bag.py:29-30). A whitespace-text export
(one row per line: utime ? ? lat lon [alt]) is also accepted as a fallback;
the format is auto-detected. Radians vs degrees is auto-detected by
magnitude (the reference republishes the raw radian values verbatim; our
pipeline consumes degrees, so radians are converted).
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, Tuple

import numpy as np

_GPS_RECORD = struct.Struct("<qddd dddd 16d")  # 192 bytes


def read_scan_mat(path: str) -> Tuple[float, np.ndarray]:
    """-> (stamp_sec, xyz (N,3) float32)."""
    from scipy import io as sio

    mat = sio.loadmat(path, squeeze_me=True, struct_as_record=False)
    scan = mat["SCAN"]
    xyz = np.atleast_2d(np.asarray(scan.XYZ, dtype=np.float32))
    if xyz.shape[0] == 3 and xyz.shape[1] != 3:
        xyz = xyz.T
    stamp = float(np.asarray(scan.timestamp_laser).reshape(-1)[0]) * 1e-6
    return stamp, xyz


def _gps_log_is_binary(path: str) -> bool:
    """Heuristic format sniff: the raw GPS.log is a headerless 192-byte
    binary record stream; text exports are printable ASCII rows."""
    with open(path, "rb") as f:
        head = f.read(_GPS_RECORD.size)
    if not head:
        return False
    # any non-numeric-text byte in the first record's worth => binary (the
    # packed int64 utime alone guarantees NUL/high bytes); file length is NOT
    # checked — the reference tolerates a truncated trailing record
    return any(b not in b"0123456789.+-eE \t\r\n" for b in head)


def _latlon_to_deg(lat: float, lon: float) -> Tuple[float, float]:
    if abs(lat) <= np.pi and abs(lon) <= np.pi:  # radians in raw logs
        return float(np.degrees(lat)), float(np.degrees(lon))
    return float(lat), float(lon)


def read_gps_log_binary(path: str) -> Iterator[Tuple[float, float, float, float]]:
    """Raw Ford GPS.log -> (stamp_sec, lat_deg, lon_deg, alt).

    Record layout per ford2bag.py:20-27: int64 utime + 3 local-pose doubles,
    then lat/lon/el/theta (radians), then a 4x4 covariance (16 doubles).
    Records with |lat_rad| < 0.1 (no fix) are skipped (ford2bag.py:29-30);
    trailing partial records are ignored like the reference's EOF except.
    """
    with open(path, "rb") as f:
        while True:
            buf = f.read(_GPS_RECORD.size)
            if len(buf) < _GPS_RECORD.size:
                return
            rec = _GPS_RECORD.unpack(buf)
            utime = rec[0]
            lat, lon, alt = rec[4], rec[5], rec[6]  # el = altitude; rec[7] = theta
            if abs(lat) < 1e-1:
                continue
            lat, lon = _latlon_to_deg(lat, lon)
            yield utime * 1e-6, lat, lon, float(alt)


def read_gps_log(path: str) -> Iterator[Tuple[float, float, float, float]]:
    """GPS.log -> (stamp_sec, lat_deg, lon_deg, alt). Auto-detects the raw
    binary record stream (the real dataset format) vs a text export."""
    if _gps_log_is_binary(path):
        yield from read_gps_log_binary(path)
        return
    data = np.loadtxt(path)
    for row in np.atleast_2d(data):
        stamp = row[0] * 1e-6
        lat, lon = _latlon_to_deg(row[3], row[4])
        alt = row[5] if row.shape[0] > 5 else float("nan")
        yield stamp, float(lat), float(lon), float(alt)


class FordDataset:
    """IJRR dataset-2 directory: SCANS/Scan####.mat + GPS.log."""

    def __init__(self, root: str):
        self.root = root
        scans_dir = os.path.join(root, "SCANS")
        self.scan_files = (
            sorted(os.path.join(scans_dir, f) for f in os.listdir(scans_dir) if f.endswith(".mat"))
            if os.path.isdir(scans_dir)
            else []
        )
        self.gps_log = os.path.join(root, "GPS.log")

    def frames(self) -> Iterator[Tuple[float, np.ndarray, None]]:
        for path in self.scan_files:
            stamp, xyz = read_scan_mat(path)
            yield stamp, xyz, None

    def gps(self) -> Iterator[Tuple[float, float, float, float]]:
        if os.path.exists(self.gps_log):
            yield from read_gps_log(self.gps_log)
