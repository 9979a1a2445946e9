"""Dataset replay feeder (NumPy only): yields (ranges, odom, u) frames,
optionally rate-limited (the reference replays at 10 Hz, createbag.py:144),
or publishes them over rosbridge as the reference's matlab2ros/createbag.py
does.

A copy of ``stream_dataset`` and ``publish_to_rosbridge`` from
``icm_slam_tpu.runtime.replay``.
"""
from __future__ import annotations

import time
from typing import Iterator, Tuple

import numpy as np

from icm_slam_tpu_torch.data.datasets import Dataset


def stream_dataset(ds: Dataset, hz: float = 0.0
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield per-frame tuples; hz > 0 paces wall-clock like a live sensor."""
    period = 1.0 / hz if hz > 0 else 0.0
    next_t = time.monotonic()
    for t in range(ds.T):
        if period:
            now = time.monotonic()
            if now < next_t:
                time.sleep(next_t - now)
            next_t += period
        yield ds.scans[t], ds.odom[t], ds.u[t]


def publish_to_rosbridge(ds: Dataset, config, hz: float = 10.0,
                         host: str = "localhost", port: int = 9090,
                         speedup: float = 1.0):
    """Publish a dataset as live LaserScan/Odometry topics over rosbridge —
    the reference's matlab2ros/createbag.py feeder.  Requires roslibpy
    (or the in-process loopback, ``runtime.fake_rosbridge.client_module()``
    installed as ``sys.modules["roslibpy"]``).

    ``speedup > 1`` replays in sim time: header stamps keep the 1/hz grid
    (so downstream time-sync behaves identically) while wall-clock sleeps
    shrink by the factor — rosbag play's --rate, for tests/backfill."""
    import math

    try:
        import roslibpy
    except ImportError as e:
        raise ImportError("publish_to_rosbridge needs roslibpy; use "
                          "stream_dataset for a ROS-free replay") from e

    client = roslibpy.Ros(host=host, port=port)
    client.run()
    laser = roslibpy.Topic(client, config.topic_laser, config.topic_laser_msg)
    odom = roslibpy.Topic(client, config.topic_odometry,
                          config.topic_odometry_msg)

    def header(seq, t):
        secs = int(t)
        return {"seq": seq, "frame_id": "map",
                "stamp": {"secs": secs, "nsecs": int((t - secs) * 1e9)}}

    t0 = time.time()
    try:
        for k in range(ds.T):
            t = t0 + k / hz
            laser.publish(roslibpy.Message({
                "header": header(k, t),
                "angle_min": -math.pi / 2, "angle_max": math.pi / 2,
                "angle_increment": math.pi / 180.0,
                "range_min": 0.0, "range_max": config.rango_laser_max,
                "ranges": [float(r) for r in ds.scans[k]],
                "intensities": []}))
            yaw = float(ds.odom[k, 2])
            odom.publish(roslibpy.Message({
                "header": header(k, t),
                "pose": {"pose": {
                    "position": {"x": float(ds.odom[k, 0]),
                                 "y": float(ds.odom[k, 1]), "z": 0.0},
                    "orientation": {"x": 0.0, "y": 0.0,
                                    "z": math.sin(yaw / 2),
                                    "w": math.cos(yaw / 2)}},
                    "covariance": [0.0] * 36},
                "twist": {"twist": {
                    "linear": {"x": float(ds.u[k, 0]), "y": 0.0, "z": 0.0},
                    "angular": {"x": 0.0, "y": 0.0,
                                "z": float(ds.u[k, 1])}},
                    "covariance": [0.0] * 36}}))
            time.sleep(1.0 / (hz * max(speedup, 1e-9)))
    finally:
        client.terminate()
