"""Trajectory / map / convergence plotting (NumPy and matplotlib only).

A copy of ``icm_slam_tpu.utils.viz``; the port's tests hold the plotted
data equal to the original's.  Every function takes NumPy arrays (the
callers in ``api`` and ``cli`` copy tensors to the host first), and
matplotlib is imported only when something is plotted, so importing this
module, ``api`` or ``cli`` needs no matplotlib.

Equivalents of the reference's graficar (ICM_SLAM.py:497-504), graficar2
live-update class (:506-521), and graficar_cambio convergence curves
(:523-528), with the same visual conventions: trajectory blue, odometry
green, landmarks blue stars; map-change min/max dashed with the mean solid.

Headless-safe: uses the Agg backend unless a display is configured.
"""
from __future__ import annotations

import os


def _plt():
    import matplotlib
    if not os.environ.get("DISPLAY"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_slam(x, landmarks, odom=None, path=None, title=None, figure=0):
    """Trajectory (blue), odometry (green), landmarks (b*). x: (T,3);
    landmarks: (K,2); odom: (T,3). Saves to ``path`` if given."""
    plt = _plt()
    fig = plt.figure(figure)
    plt.clf()
    plt.plot(x[:, 0], x[:, 1], "b", label="trajectory")
    if odom is not None:
        plt.plot(odom[:, 0], odom[:, 1], "g", label="odometry")
    if landmarks is not None and len(landmarks):
        plt.plot(landmarks[:, 0], landmarks[:, 1], "b*", label="landmarks")
    plt.axis("equal")
    plt.legend(loc="best")
    if title:
        plt.title(title)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig


def plot_convergence(changes, path=None, figure=100):
    """Map-change curves per ICM iteration: (N,3) [min,max,mean]."""
    import numpy as np
    plt = _plt()
    changes = np.asarray(changes)
    fig = plt.figure(figure)
    plt.clf()
    if changes.size:
        plt.plot(changes[:, 0], "b--", label="min")
        plt.plot(changes[:, 1], "b--", label="max")
        plt.plot(changes[:, 2], "b", label="mean")
    plt.xlabel("ICM iteration")
    plt.ylabel("landmark displacement [m]")
    plt.legend(loc="best")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig


class LivePlot:
    """Incremental re-plot during a run (graficar2, ICM_SLAM.py:506-521)."""

    def __init__(self, figure=11, pause=0.01):
        self.figure = figure
        self.pause = pause

    def update(self, x, landmarks, odom=None):
        plt = _plt()
        plot_slam(x, landmarks, odom, figure=self.figure)
        try:
            plt.pause(self.pause)
        except Exception:
            pass  # headless backends cannot pause

    def show(self):
        _plt().show()
