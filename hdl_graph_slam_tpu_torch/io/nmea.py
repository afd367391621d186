"""$GPRMC NMEA sentence parsing (a copy of hdl_graph_slam_tpu/io/nmea.py, pure Python).

Equivalent of hdl_graph_slam::NmeaSentenceParser
(include/hdl_graph_slam/nmea_sentence_parser.hpp:14-104): XOR checksum
validation between '$' and '*', GPRMC field extraction, ddmm.mmmm ->
decimal-degree conversion with N/S/E/W signs, status gate handled by the
caller (status must be 'A', hdl_graph_slam_nodelet.cpp:254).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class GPRMC:
    status: str = "V"
    latitude: float = float("nan")
    longitude: float = float("nan")
    speed_knots: float = float("nan")
    track_angle_deg: float = float("nan")


def checksum_ok(sentence: str) -> bool:
    s = sentence.strip()
    star = s.rfind("*")
    if not s.startswith("$") or star < 0:
        return False
    body = s[1:star]
    try:
        expect = int(s[star + 1 : star + 3], 16)
    except ValueError:
        return False
    acc = 0
    for ch in body:
        acc ^= ord(ch)
    return acc == expect


def degmin_to_deg(val: str) -> float:
    """ddmm.mmmm -> dd + mm.mmmm/60 (nmea_sentence_parser.hpp:99-103)."""
    if not val:
        return float("nan")
    v = float(val)
    deg = int(v / 100.0)
    minutes = v - deg * 100.0
    return deg + minutes / 60.0


def parse(sentence: str) -> GPRMC:
    out = GPRMC()
    if not checksum_ok(sentence):
        return out
    s = sentence.strip()
    body = s[1 : s.rfind("*")]
    fields = body.split(",")
    if not fields or fields[0] not in ("GPRMC", "GNRMC"):
        return out
    if len(fields) < 9:
        return out
    out.status = fields[2] or "V"
    lat = degmin_to_deg(fields[3])
    if fields[4] == "S":
        lat = -lat
    lon = degmin_to_deg(fields[5])
    if fields[6] == "W":
        lon = -lon
    out.latitude = lat
    out.longitude = lon
    try:
        out.speed_knots = float(fields[7]) if fields[7] else float("nan")
        out.track_angle_deg = float(fields[8]) if fields[8] else float("nan")
    except ValueError:
        pass
    return out
