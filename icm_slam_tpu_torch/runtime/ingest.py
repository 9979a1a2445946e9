"""Live sensor ingestion: ROS-bridge message adapter + time-sync pairing
(NumPy and threading only).

A copy of ``icm_slam_tpu.runtime.ingest``.  It replaces the reference's
L1/L2 stack (ROS class ICM_SLAM.py:267-341, Sensor base ICM_SLAM.py:343-449,
Lidar/Odometria sensors_definitions.py) with an explicit, race-free design:

* message PARSERS are pure functions on rosbridge JSON dicts (schema
  identical to the reference: sensor_msgs/LaserScan, nav_msgs/Odometry);
* a ``FrameSynchronizer`` pairs lidar+odometry by timestamp on a fixed
  deltat grid — the reference's Sensor.sort search (ICM_SLAM.py:372-426)
  without its bugs (busy-wait race; odom message count used for the laser
  queue, ICM_SLAM.py:307);
* ``RosBridgeSource`` is an optional roslibpy websocket client (the
  reference's transport); it raises a clear ImportError when roslibpy
  isn't installed — the rest of the engine never imports it.
"""
from __future__ import annotations

import bisect
import logging
import math
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

log = logging.getLogger("icm_slam_tpu_torch.ingest")


# ---------------------------------------------------------------------------
# message parsing (schemas per the reference's callbacks)
# ---------------------------------------------------------------------------

def stamp_of(msg: dict) -> float:
    """header.stamp -> seconds (Sensor.header_process, ICM_SLAM.py:428-440)."""
    s = msg["header"]["stamp"]
    return s["secs"] + s["nsecs"] * 1e-9


def parse_laser_scan(msg: dict, max_range: float, radio: float,
                     n_beams: int = 181) -> np.ndarray:
    """sensor_msgs/LaserScan -> (n_beams,) ranges.

    NaN -> max range, +tree radius, clip (Lidar.callback,
    sensors_definitions.py:20-29); scans on a different angular grid are
    resampled to 1-degree beams starting at -pi/2.
    """
    z = np.asarray(msg["ranges"], dtype=float)
    z[~np.isfinite(z)] = max_range
    z = np.minimum(z + radio, max_range)
    if z.shape[0] != n_beams:
        angle_min = float(msg["angle_min"])
        inc = float(msg["angle_increment"])
        s0 = int((-math.pi / 2 - angle_min) / inc)
        step = max(1, round((math.pi / 180.0) / inc))
        # gather by index, not by slice: a scan whose field of view starts
        # after -pi/2 gives s0 < 0, and a negative Python slice start would
        # silently wrap to the END of the array (beams from the wrong side
        # presented as the left sector).  Sectors the scan doesn't cover
        # pad with max_range on BOTH sides.
        idx = s0 + step * np.arange(n_beams)
        out = np.full(n_beams, max_range, dtype=z.dtype)
        ok = (idx >= 0) & (idx < z.shape[0])
        out[ok] = z[idx[ok]]
        z = out
    return z


def quat_to_yaw(qx: float, qy: float, qz: float, qw: float) -> float:
    """Quaternion -> yaw (Odometria.callback, sensors_definitions.py:58-62)."""
    t3 = 2.0 * (qw * qz + qx * qy)
    t4 = 1.0 - 2.0 * (qy * qy + qz * qz)
    return math.atan2(t3, t4)


def parse_odometry(msg: dict) -> Tuple[np.ndarray, np.ndarray]:
    """nav_msgs/Odometry -> (pose [x,y,yaw], control [v,w])."""
    p = msg["pose"]["pose"]
    o = p["orientation"]
    pose = np.array([p["position"]["x"], p["position"]["y"],
                     quat_to_yaw(o["x"], o["y"], o["z"], o["w"])])
    tw = msg["twist"]["twist"]
    u = np.array([tw["linear"]["x"], tw["angular"]["z"]])
    return pose, u


# ---------------------------------------------------------------------------
# time synchronization
# ---------------------------------------------------------------------------

class FrameSynchronizer:
    """Pairs lidar + odometry messages onto a fixed deltat grid.

    Thread-safe: feed_* may be called from a network thread; ``drain()``
    from the consumer.  A frame k is emitted when both sensors have a
    message within deltat of t0 + k*deltat (same tolerance as Sensor.sort,
    ICM_SLAM.py:397).  Frames missing either sensor are dropped WITH a
    warning and a counter, like the reference's desync diagnostics
    (ICM_SLAM.py:403-426 "Warning 0/1"); consumed history is pruned after
    every drain, so memory and per-drain cost stay bounded over an
    arbitrarily long live session.
    """

    def __init__(self, deltat: float):
        self.deltat = deltat
        self._lock = threading.Lock()
        self._laser: List[Tuple[float, np.ndarray]] = []
        self._odo: List[Tuple[float, np.ndarray, np.ndarray]] = []
        self._t0: Optional[float] = None
        self._k = 0
        # observability counters (reference parity: Sensor.sort warnings)
        self.paired = 0          # frames emitted
        self.dropped = 0         # grid points missing a synchronized pair
        self.pruned = 0          # consumed messages discarded

    def feed_laser(self, stamp: float, ranges: np.ndarray):
        with self._lock:
            self._laser.append((stamp, ranges))

    def feed_odometry(self, stamp: float, pose: np.ndarray, u: np.ndarray):
        with self._lock:
            self._odo.append((stamp, pose, u))

    @property
    def stats(self) -> dict:
        """Snapshot of sync health: paired/dropped/pruned + buffer sizes."""
        with self._lock:
            return {"paired": self.paired, "dropped": self.dropped,
                    "pruned": self.pruned,
                    "laser_buffered": len(self._laser),
                    "odo_buffered": len(self._odo)}

    def _nearest(self, series, target):
        keys = [s[0] for s in series]
        i = bisect.bisect_left(keys, target)
        best, best_d = None, float("inf")
        for j in (i - 1, i):
            if 0 <= j < len(series):
                d = abs(keys[j] - target)
                if d < best_d:
                    best, best_d = j, d
        return best, best_d

    def drain(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield all currently pairable frames (ranges, pose, u)."""
        pairs = []
        with self._lock:
            laser, odo = self._laser, self._odo
            if not laser or not odo:
                return iter(())
            if self._t0 is None:
                self._t0 = max(laser[0][0], odo[0][0])
            while True:
                target = self._t0 + self._k * self.deltat
                # stop when the buffers haven't reached this grid point yet
                if laser[-1][0] < target + self.deltat or \
                        odo[-1][0] < target + self.deltat:
                    break
                li, ld = self._nearest(laser, target)
                oi, od = self._nearest(odo, target)
                self._k += 1
                if ld < self.deltat and od < self.deltat:
                    pairs.append((laser[li][1], odo[oi][1], odo[oi][2]))
                    self.paired += 1
                else:
                    # desynchronized grid point -> dropped, loudly
                    # (reference: ICM_SLAM.py:417-426 "Warning 1")
                    self.dropped += 1
                    if self.dropped <= 10 or self.dropped % 100 == 0:
                        log.warning(
                            "desynchronized frame %d at t=%.3f dropped "
                            "(laser off by %.3fs, odometry by %.3fs; "
                            "%d dropped so far)", self._k - 1, target,
                            ld, od, self.dropped)
            # prune consumed history: nothing before the next grid point
            # minus one tolerance window can ever pair again
            cutoff = self._t0 + self._k * self.deltat - self.deltat
            for series in (laser, odo):
                keys = [m[0] for m in series]
                i = bisect.bisect_left(keys, cutoff)
                if i > 0:
                    del series[:i]
                    self.pruned += i
        return iter(pairs)


# ---------------------------------------------------------------------------
# optional websocket transport (the reference's rosbridge contract)
# ---------------------------------------------------------------------------

class RosBridgeSource:
    """Subscribe to the reference's topics over rosbridge and emit frames.

    Requires ``roslibpy`` (not bundled).  Advertises the same
    /icm_slam/iterative_flag SetBool service as the reference
    (ICM_SLAM.py:285-286) to trigger refinement.
    """

    def __init__(self, config, host: str = "localhost", port: int = 9090):
        try:
            import roslibpy  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "RosBridgeSource needs roslibpy (pip install roslibpy); "
                "offline replay (icm_slam_tpu_torch.runtime.replay) has no "
                "such dependency") from e
        self._roslibpy = roslibpy
        self.config = config
        self.sync = FrameSynchronizer(config.deltat)
        self.iterations_flag = False
        self._client = roslibpy.Ros(host=host, port=port)

    def _on_laser(self, msg):
        # radio=0: the engine (preprocess_ranges, via OnlineSLAM._filter /
        # prepare) adds the tree radius exactly once at compute time —
        # parsing with config.radio here would add it TWICE on this path.
        # (The reference adds it in Lidar.callback because its engine
        # consumes pre-compensated ranges; ours consumes raw.)
        self.sync.feed_laser(
            stamp_of(msg),
            parse_laser_scan(msg, self.config.rango_laser_max,
                             0.0, self.config.n_beams))

    def _on_odom(self, msg):
        pose, u = parse_odometry(msg)
        self.sync.feed_odometry(stamp_of(msg), pose, u)

    def _on_flag(self, request, response):
        response["success"] = True
        response["message"] = "Working..."
        self.iterations_flag = True
        return True

    def connect(self):
        roslibpy = self._roslibpy
        self._client.run()
        roslibpy.Topic(self._client, self.config.topic_laser,
                       self.config.topic_laser_msg).subscribe(self._on_laser)
        roslibpy.Topic(self._client, self.config.topic_odometry,
                       self.config.topic_odometry_msg).subscribe(self._on_odom)
        service = roslibpy.Service(self._client, "/icm_slam/iterative_flag",
                                   "std_srvs/SetBool")
        service.advertise(self._on_flag)

    def disconnect(self):
        self._client.terminate()

    def frames(self, duration: float):
        """Generator over paired frames for ``duration`` seconds (the
        reference's config.time capture window, ICM_ROS.py:73)."""
        import time
        t_end = time.time() + duration
        while time.time() < t_end:
            yielded = False
            for frame in self.sync.drain():
                yielded = True
                yield frame
            if self.iterations_flag and not yielded:
                return
            if not yielded:
                time.sleep(0.01)
