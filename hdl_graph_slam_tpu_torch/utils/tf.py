"""map->odom correction stream (a copy of hdl_graph_slam_tpu/utils/tf.py).

Equivalent of src/hdl_graph_slam/map2odom_publisher.py: the backend
publishes its latest odom->map correction; a small rebroadcaster makes the
current map->odom transform available to consumers at a fixed rate. Without
ROS tf this is a thread-safe holder + optional callback pump.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

import numpy as np


class Map2OdomPublisher:
    """Holds the latest odom2map correction; optionally pumps subscribers at
    ``rate_hz`` like the reference's 10 Hz tf broadcast loop
    (map2odom_publisher.py:15-30)."""

    def __init__(self, rate_hz: float = 10.0):
        self.rate_hz = rate_hz
        self._lock = threading.Lock()
        self._odom2map = np.eye(4)
        self._subscribers: List[Callable[[np.ndarray], None]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def update(self, odom2map: np.ndarray) -> None:
        with self._lock:
            self._odom2map = np.asarray(odom2map, dtype=np.float64).copy()

    def map_to_odom(self) -> np.ndarray:
        """The map->odom transform (inverse of the stored correction)."""
        with self._lock:
            return np.linalg.inv(self._odom2map)

    def odom_to_map(self) -> np.ndarray:
        with self._lock:
            return self._odom2map.copy()

    def subscribe(self, fn: Callable[[np.ndarray], None]) -> None:
        self._subscribers.append(fn)

    def start(self) -> "Map2OdomPublisher":
        self._thread = threading.Thread(target=self._spin, daemon=True)
        self._thread.start()
        return self

    def _spin(self):
        period = 1.0 / self.rate_hz
        while not self._stop.wait(period):
            T = self.map_to_odom()
            for fn in self._subscribers:
                fn(T)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
