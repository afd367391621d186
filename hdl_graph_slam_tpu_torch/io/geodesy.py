"""WGS84 lat/lon -> UTM conversion.

Equivalent of geodesy::fromMsg -> UTMPoint used for GPS constraints
(apps/hdl_graph_slam_nodelet.cpp:326-341). Standard Karney/Snyder series
(the same Transverse Mercator expansion geodesy/proj use, sub-millimeter
agreement within a zone).

A copy of hdl_graph_slam_tpu/io/geodesy.py (pure Python): the port never
imports the JAX package.
"""

from __future__ import annotations

import math
from typing import Tuple

# WGS84
_A = 6378137.0
_F = 1.0 / 298.257223563
_K0 = 0.9996
_E2 = _F * (2.0 - _F)
_EP2 = _E2 / (1.0 - _E2)


def utm_zone(lat: float, lon: float) -> int:
    zone = int((lon + 180.0) / 6.0) + 1
    # Norway/Svalbard exceptions (geodesy does the same)
    if 56.0 <= lat < 64.0 and 3.0 <= lon < 12.0:
        zone = 32
    if 72.0 <= lat < 84.0:
        if 0.0 <= lon < 9.0:
            zone = 31
        elif 9.0 <= lon < 21.0:
            zone = 33
        elif 21.0 <= lon < 33.0:
            zone = 35
        elif 33.0 <= lon < 42.0:
            zone = 37
    return zone


def wgs84_to_utm(lat: float, lon: float) -> Tuple[float, float, int]:
    """Returns (easting, northing, zone). Southern-hemisphere northing gets
    the 10,000,000 m false northing like geodesy::UTMPoint."""
    zone = utm_zone(lat, lon)
    lon0 = math.radians((zone - 1) * 6 - 180 + 3)
    phi = math.radians(lat)
    lam = math.radians(lon) - lon0

    sin_phi = math.sin(phi)
    cos_phi = math.cos(phi)
    tan_phi = math.tan(phi)

    N = _A / math.sqrt(1.0 - _E2 * sin_phi * sin_phi)
    T = tan_phi * tan_phi
    C = _EP2 * cos_phi * cos_phi
    A = cos_phi * lam

    # meridional arc
    M = _A * (
        (1 - _E2 / 4 - 3 * _E2**2 / 64 - 5 * _E2**3 / 256) * phi
        - (3 * _E2 / 8 + 3 * _E2**2 / 32 + 45 * _E2**3 / 1024) * math.sin(2 * phi)
        + (15 * _E2**2 / 256 + 45 * _E2**3 / 1024) * math.sin(4 * phi)
        - (35 * _E2**3 / 3072) * math.sin(6 * phi)
    )

    easting = _K0 * N * (
        A + (1 - T + C) * A**3 / 6 + (5 - 18 * T + T * T + 72 * C - 58 * _EP2) * A**5 / 120
    ) + 500000.0

    northing = _K0 * (
        M
        + N
        * tan_phi
        * (
            A * A / 2
            + (5 - T + 9 * C + 4 * C * C) * A**4 / 24
            + (61 - 58 * T + T * T + 600 * C - 330 * _EP2) * A**6 / 720
        )
    )
    if lat < 0:
        northing += 10000000.0
    return easting, northing, zone
