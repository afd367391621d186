from .odometry_device import DeviceOdometry
from .prefilter import Prefilter
from .window import OdometryWindow

__all__ = ["DeviceOdometry", "OdometryWindow", "Prefilter"]
