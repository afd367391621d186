from .floor import FloorDetector
from .odometry import ScanMatchingOdometry
from .odometry_device import DeviceOdometry
from .prefilter import Prefilter
from .window import OdometryWindow, stack_scans

__all__ = ["DeviceOdometry", "FloorDetector", "OdometryWindow", "Prefilter", "ScanMatchingOdometry", "stack_scans"]
