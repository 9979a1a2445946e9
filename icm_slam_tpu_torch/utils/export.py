"""Result export: occupancy-grid PGM map + TUM-format trajectory (NumPy
only).

A copy of ``icm_slam_tpu.utils.export``; the port's tests hold it bitwise
against the original.

The reference's architecture diagram (esquema_general.png) advertises
``map.pgm`` and ``trajectory.bag`` outputs that its code never writes
(SURVEY.md §5).  Implemented here: PGM occupancy grid of the landmark map
(ROS map_server-compatible, with YAML metadata) and the TUM trajectory text
format (timestamp tx ty tz qx qy qz qw) consumed by standard SLAM evaluation
tools (evo, rpg_trajectory_evaluation).
"""
from __future__ import annotations

import math
import os

import numpy as np


def save_map_pgm(path: str, landmarks: np.ndarray, resolution: float = 0.05,
                 tree_radius: float = 0.137, margin: float = 2.0,
                 trajectory: np.ndarray = None):
    """Write an occupancy grid (PGM P5 + map_server YAML sidecar).

    Landmarks are stamped as occupied discs of ``tree_radius``; free space is
    white; unknown border gray.  trajectory (T,3), if given, extends the
    bounds and is drawn faintly.
    """
    landmarks = np.asarray(landmarks).reshape(-1, 2)
    pts = [landmarks] if landmarks.size else []
    if trajectory is not None:
        pts.append(np.asarray(trajectory)[:, :2])
    all_pts = np.concatenate(pts, axis=0) if pts else np.zeros((1, 2))
    lo = all_pts.min(0) - margin
    hi = all_pts.max(0) + margin
    w = int(math.ceil((hi[0] - lo[0]) / resolution))
    h = int(math.ceil((hi[1] - lo[1]) / resolution))
    grid = np.full((h, w), 254, np.uint8)  # free

    def to_px(xy):
        c = ((xy - lo) / resolution).astype(int)
        return c[..., 0], (h - 1) - c[..., 1]  # y axis flips in image space

    if trajectory is not None:
        cx, cy = to_px(np.asarray(trajectory)[:, :2])
        ok = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
        grid[cy[ok], cx[ok]] = 200
    r_px = max(1, int(round(tree_radius / resolution)))
    yy, xx = np.mgrid[-r_px:r_px + 1, -r_px:r_px + 1]
    disc = (xx ** 2 + yy ** 2) <= r_px ** 2
    for lm in landmarks:
        cx, cy = to_px(lm)
        ys, xs = np.nonzero(disc)
        ys = ys + cy - r_px
        xs = xs + cx - r_px
        ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        grid[ys[ok], xs[ok]] = 0  # occupied

    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(grid.tobytes())
    yaml_path = os.path.splitext(path)[0] + ".yaml"
    with open(yaml_path, "w") as f:
        f.write(f"image: {os.path.basename(path)}\n"
                f"resolution: {resolution}\n"
                f"origin: [{lo[0]:.6f}, {lo[1]:.6f}, 0.0]\n"
                "negate: 0\noccupied_thresh: 0.65\nfree_thresh: 0.196\n")
    return path, yaml_path


def save_trajectory_tum(path: str, x: np.ndarray, deltat: float = 0.1,
                        t0: float = 0.0):
    """TUM format: ``timestamp tx ty tz qx qy qz qw`` per line; SE(2) poses
    get z=0 and a yaw-only quaternion."""
    x = np.asarray(x)
    with open(path, "w") as f:
        for k, (px, py, th) in enumerate(x):
            qz, qw = math.sin(th / 2.0), math.cos(th / 2.0)
            f.write(f"{t0 + k * deltat:.6f} {px:.6f} {py:.6f} 0.000000 "
                    f"0.000000 0.000000 {qz:.6f} {qw:.6f}\n")
    return path


def load_trajectory_tum(path: str) -> np.ndarray:
    """Inverse of save_trajectory_tum -> (T, 3) [x, y, yaw]."""
    rows = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            v = [float(t) for t in line.split()]
            yaw = 2.0 * math.atan2(v[6], v[7])
            rows.append([v[1], v[2], yaw])
    return np.asarray(rows)
