from . import information_matrix, keyframe, loop_detector, slam
from .information_matrix import InformationMatrixCalculator
from .keyframe import KeyFrame, KeyFrameSnapshot, KeyframeUpdater
from .loop_detector import Loop, LoopDetector
from .slam import FloorMeasurement, GpsMeasurement, HdlGraphSlam, ImuMeasurement
