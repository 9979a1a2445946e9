"""Metrics and structured logging (NumPy only).

A copy of ``icm_slam_tpu.utils.metrics``; the port's tests hold it
bitwise against the original.

Keeps the reference's convergence-monitoring semantics (map-change
min/max/mean, calc_cambio ICM_SLAM.py:490-495; total pose-correction norm,
ICM_ROS.py:303) and adds proper trajectory metrics (ATE/RPE) plus JSON-lines
logging — the reference's only observability was matplotlib windows and
prints (SURVEY.md §5).
"""
from __future__ import annotations

import json
import sys
import time
from typing import Optional

import numpy as np


def ate(x: np.ndarray, x_ref: np.ndarray, align: bool = False) -> dict:
    """Absolute trajectory error between (T,3) pose arrays.

    align=True applies the usual SE(2) Umeyama-style alignment before
    comparing (useful against ground truth with a different origin).
    """
    a, b = np.asarray(x)[:, :2], np.asarray(x_ref)[:, :2]
    if align:
        ca, cb = a.mean(0), b.mean(0)
        A, B = a - ca, b - cb
        u, _, vt = np.linalg.svd(A.T @ B)
        d = np.sign(np.linalg.det(u @ vt))
        R = (u @ np.diag([1, d]) @ vt)
        a = (a - ca) @ R + cb
    err = np.sqrt(((a - b) ** 2).sum(1))
    return {"rmse": float(np.sqrt((err ** 2).mean())),
            "mean": float(err.mean()), "max": float(err.max())}


def rpe(x: np.ndarray, x_ref: np.ndarray, delta: int = 10) -> dict:
    """Relative pose error over windows of ``delta`` frames."""
    a, b = np.asarray(x)[:, :2], np.asarray(x_ref)[:, :2]
    da = a[delta:] - a[:-delta]
    db = b[delta:] - b[:-delta]
    err = np.sqrt(((da - db) ** 2).sum(1))
    return {"rmse": float(np.sqrt((err ** 2).mean())),
            "mean": float(err.mean()), "max": float(err.max())}


class JsonlLogger:
    """One JSON object per line; stdout or file. The engine's per-iteration
    metrics stream (replaces the reference's print statements)."""

    def __init__(self, path: Optional[str] = None):
        self._fh = open(path, "a") if path else sys.stdout
        self._owns = path is not None
        self._t0 = time.time()

    def log(self, event: str, **fields):
        rec = {"event": event, "t": round(time.time() - self._t0, 3)}
        rec.update(fields)
        self._fh.write(json.dumps(rec, default=_np_default) + "\n")
        self._fh.flush()

    def close(self):
        if self._owns:
            self._fh.close()


def _np_default(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(type(o))
