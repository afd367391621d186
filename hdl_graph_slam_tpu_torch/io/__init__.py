from . import geodesy, nmea, pcd, kitti, trajectory, rosbag, ford, native
