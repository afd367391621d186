"""Pure-Python rosbag (v2.0) reader — no ROS dependency (a copy of hdl_graph_slam_tpu/io/rosbag.py).

Replaces the reference's bag_player.py + rosbag stack for offline ingestion
of the evaluation bags (hdl_501/hdl_400, README.md:113-150). Implements the
rosbag 2.0 on-disk format: record headers, chunk decompression (none/bz2),
connection records, and message deserialization for the message types the
pipeline consumes:

- sensor_msgs/PointCloud2 -> (stamp, Nx3 float32 xyz [+ intensity])
- sensor_msgs/Imu         -> (stamp, orientation wxyz, ang_vel, lin_acc)
- sensor_msgs/NavSatFix   -> (stamp, lat, lon, alt)
- geographic_msgs/GeoPointStamped -> (stamp, lat, lon, alt)
- nmea_msgs/Sentence      -> (stamp, sentence)

Format reference: http://wiki.ros.org/Bags/Format/2.0 (public spec).
"""

from __future__ import annotations

import bz2
import dataclasses
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


def _read_header(data: bytes) -> Dict[bytes, bytes]:
    fields = {}
    off = 0
    while off < len(data):
        (flen,) = struct.unpack_from("<I", data, off)
        off += 4
        field = data[off : off + flen]
        off += flen
        eq = field.index(b"=")
        fields[field[:eq]] = field[eq + 1 :]
    return fields


@dataclasses.dataclass
class BagMessage:
    topic: str
    msg_type: str
    stamp: float  # receive time (sec)
    raw: bytes


class BagReader:
    """Sequential reader over all messages in time order (per chunk order,
    which rosbag guarantees to be monotone in record time for recorded
    bags)."""

    def __init__(self, path: str):
        self.path = path
        self._connections: Dict[int, Tuple[str, str]] = {}  # conn id -> (topic, type)

    def messages(self, topics: Optional[List[str]] = None) -> Iterator[BagMessage]:
        with open(self.path, "rb") as f:
            magic = f.readline()
            if not magic.startswith(b"#ROSBAG V2.0"):
                raise ValueError(f"not a rosbag 2.0 file: {self.path} ({magic[:20]!r})")
            while True:
                rec = self._read_record(f)
                if rec is None:
                    break
                header, data = rec
                op = header.get(b"op", b"")
                if op == b"\x07":  # connection
                    conn = struct.unpack("<I", header[b"conn"])[0]
                    topic = header[b"topic"].decode()
                    conn_fields = _read_header(data)
                    msg_type = conn_fields.get(b"type", b"").decode()
                    self._connections[conn] = (topic, msg_type)
                elif op == b"\x05":  # chunk
                    compression = header.get(b"compression", b"none")
                    if compression == b"bz2":
                        payload = bz2.decompress(data)
                    elif compression == b"none":
                        payload = data
                    else:
                        raise ValueError(f"unsupported chunk compression: {compression}")
                    yield from self._parse_chunk(payload, topics)
                # op 0x03 bag header, 0x04 index, 0x06 chunk info: skip

    def _parse_chunk(self, payload: bytes, topics) -> Iterator[BagMessage]:
        off = 0
        n = len(payload)
        while off < n:
            (hlen,) = struct.unpack_from("<I", payload, off)
            off += 4
            header = _read_header(payload[off : off + hlen])
            off += hlen
            (dlen,) = struct.unpack_from("<I", payload, off)
            off += 4
            data = payload[off : off + dlen]
            off += dlen
            op = header.get(b"op", b"")
            if op == b"\x07":
                conn = struct.unpack("<I", header[b"conn"])[0]
                topic = header[b"topic"].decode()
                conn_fields = _read_header(data)
                self._connections[conn] = (topic, conn_fields.get(b"type", b"").decode())
            elif op == b"\x02":  # message data
                conn = struct.unpack("<I", header[b"conn"])[0]
                secs, nsecs = struct.unpack("<II", header[b"time"])
                topic, msg_type = self._connections.get(conn, ("?", "?"))
                if topics is None or topic in topics:
                    yield BagMessage(topic=topic, msg_type=msg_type, stamp=secs + nsecs * 1e-9, raw=data)

    def _read_record(self, f):
        head = f.read(4)
        if len(head) < 4:
            return None
        (hlen,) = struct.unpack("<I", head)
        header = _read_header(f.read(hlen))
        (dlen,) = struct.unpack("<I", f.read(4))
        data = f.read(dlen)
        return header, data


# ---------------------------------------------------------------------------
# message deserialization (ROS serialization: little-endian, packed)
# ---------------------------------------------------------------------------


def _read_ros_header(raw: bytes, off: int) -> Tuple[float, str, int]:
    """std_msgs/Header: uint32 seq, time stamp, string frame_id."""
    seq, secs, nsecs = struct.unpack_from("<III", raw, off)
    off += 12
    (slen,) = struct.unpack_from("<I", raw, off)
    off += 4
    frame_id = raw[off : off + slen].decode(errors="replace")
    off += slen
    return secs + nsecs * 1e-9, frame_id, off


def parse_pointcloud2(raw: bytes):
    """-> (stamp, frame_id, xyz float32 (N,3), intensity (N,) or None)."""
    stamp, frame_id, off = _read_ros_header(raw, 0)
    height, width = struct.unpack_from("<II", raw, off)
    off += 8
    (nfields,) = struct.unpack_from("<I", raw, off)
    off += 4
    fields = []
    for _ in range(nfields):
        (slen,) = struct.unpack_from("<I", raw, off)
        off += 4
        name = raw[off : off + slen].decode()
        off += slen
        foffset, datatype, count = struct.unpack_from("<IBI", raw, off)
        off += 9
        fields.append((name, foffset, datatype, count))
    is_bigendian = raw[off]
    off += 1
    point_step, row_step = struct.unpack_from("<II", raw, off)
    off += 8
    (dlen,) = struct.unpack_from("<I", raw, off)
    off += 4
    data = np.frombuffer(raw, dtype=np.uint8, count=dlen, offset=off)
    off += dlen
    # is_dense: uint8 at the end (ignored)

    n = (height * width) if point_step == 0 else dlen // point_step
    data = data[: n * point_step].reshape(n, point_step)

    def extract(name, np_dtype, size):
        for fname, foff, dtype, count in fields:
            if fname == name:
                return data[:, foff : foff + size].copy().view(np_dtype).reshape(n)
        return None

    x = extract("x", np.float32, 4)
    y = extract("y", np.float32, 4)
    z = extract("z", np.float32, 4)
    if x is None:
        raise ValueError("PointCloud2 without x/y/z float32 fields")
    xyz = np.stack([x, y, z], axis=1)
    intensity = extract("intensity", np.float32, 4)
    good = np.isfinite(xyz).all(axis=1)
    if not good.all():
        xyz = xyz[good]
        intensity = intensity[good] if intensity is not None else None
    return stamp, frame_id, xyz, intensity


def parse_imu(raw: bytes):
    """-> (stamp, frame_id, orientation wxyz, angular_velocity, linear_acceleration)."""
    stamp, frame_id, off = _read_ros_header(raw, 0)
    qx, qy, qz, qw = struct.unpack_from("<4d", raw, off)
    off += 32 + 72  # orientation + covariance
    wx, wy, wz = struct.unpack_from("<3d", raw, off)
    off += 24 + 72
    ax, ay, az = struct.unpack_from("<3d", raw, off)
    return stamp, frame_id, np.array([qw, qx, qy, qz]), np.array([wx, wy, wz]), np.array([ax, ay, az])


def parse_navsatfix(raw: bytes):
    """-> (stamp, lat, lon, alt)."""
    stamp, frame_id, off = _read_ros_header(raw, 0)
    off += 3  # NavSatStatus: int8 status + uint16 service (packed)
    lat, lon, alt = struct.unpack_from("<3d", raw, off)
    return stamp, lat, lon, alt


def parse_geopoint(raw: bytes):
    """geographic_msgs/GeoPointStamped -> (stamp, lat, lon, alt)."""
    stamp, frame_id, off = _read_ros_header(raw, 0)
    lat, lon, alt = struct.unpack_from("<3d", raw, off)
    return stamp, lat, lon, alt


def parse_nmea_sentence(raw: bytes):
    """nmea_msgs/Sentence -> (stamp, sentence)."""
    stamp, frame_id, off = _read_ros_header(raw, 0)
    (slen,) = struct.unpack_from("<I", raw, off)
    off += 4
    return stamp, raw[off : off + slen].decode(errors="replace")
