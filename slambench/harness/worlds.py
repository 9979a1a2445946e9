"""The worlds a run serves, made from its seed.

``synthetic_world`` is a frozen copy of the program's seeded NumPy
generator (``icm_slam_tpu_torch.data.datasets.synthetic_world``, bitwise
equal for the same arguments on the same machine): a robot drives a smooth
loop among tree trunks, a 181-beam lidar at 1 degree sees them, and the
odometry drifts as a random walk.  The benchmark keeps its own copy so
that a change to the program's generator cannot change what is measured.
A configuration that names another generator finds it in
``slambench/worlds/<name>.py`` (``Registry.world_generator``).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class World:
    scans: np.ndarray   # (T, B) raw ranges
    odom: np.ndarray    # (T, 3)
    u: np.ndarray       # (T, 2)
    x0: np.ndarray      # (3,)

    @property
    def T(self):
        return self.scans.shape[0]


def synthetic_world(T=600, n_landmarks=40, n_beams=181, max_range=10.0,
                    world_size=30.0, seed=0, loop=True, odo_drift=1e-4,
                    return_truth=False, laps=1):
    """Synthetic DDMR + 2D lidar world for tests and loop-closure benchmarks.

    The robot drives a smooth loop among random point landmarks; scans are
    rendered with the reference's beam convention (beam i at i degrees, the
    -pi/2 body offset) so the full pipeline runs on it unchanged.

    ``odo_drift``: per-step std of the cumulative odometry random walk.
    ``return_truth``: also return the true trajectory (T,3) and landmark
    positions (n,2) — the ground truth for solver ATE experiments.
    """
    rng = np.random.default_rng(seed)
    landmarks = (rng.uniform(-0.5, 0.5, size=(n_landmarks, 2)) * world_size)
    dt = 0.1
    # control: constant forward speed, smooth yaw-rate -> loop trajectory
    v = 1.0 + 0.1 * np.sin(np.linspace(0, 4 * np.pi, T))
    # ``laps``: how many times the robot drives the full circle — laps >= 2
    # makes every frame of later laps a revisit (loop-closure benchmarks)
    w = (laps * 2 * np.pi / (T * dt)) * np.ones(T) if loop else \
        0.3 * np.sin(np.linspace(0, 2 * np.pi, T))
    x = np.zeros((T, 3))
    for t in range(1, T):
        th = x[t - 1, 2]
        x[t] = x[t - 1] + dt * np.array(
            [v[t - 1] * np.cos(th), v[t - 1] * np.sin(th), w[t - 1]])
    scans = np.full((T, n_beams), max_range)
    tree_radius = 0.137  # landmarks are rendered as discs (tree trunks), so
    # each subtends several beams — single-beam returns would be discarded
    # by the isolation filter, as in the real sensor model
    beam_angles = np.arange(n_beams) * np.pi / 180.0
    for t in range(T):
        rel = landmarks - x[t, :2]
        r = np.linalg.norm(rel, axis=1)
        bearing = np.arctan2(rel[:, 1], rel[:, 0]) - (x[t, 2] - np.pi / 2)
        bearing = np.mod(bearing + np.pi, 2 * np.pi) - np.pi
        for k in np.argsort(-r):  # nearer landmarks overwrite farther ones
            if r[k] >= max_range * 0.95 or r[k] < tree_radius:
                continue
            half = np.arcsin(min(tree_radius / r[k], 1.0))
            sel = np.abs(beam_angles - bearing[k]) <= half
            if not sel.any():
                continue
            # range to the disc surface along each beam (approx: chord depth)
            da = beam_angles[sel] - bearing[k]
            depth = np.sqrt(np.maximum(tree_radius ** 2
                                       - (r[k] * np.sin(da)) ** 2, 0.0))
            scans[t, sel] = np.minimum(scans[t, sel],
                                       r[k] * np.cos(da) - depth)
    noise = rng.normal(0, 0.01, size=scans.shape)
    scans = np.where(scans < max_range, scans + noise, scans)
    u = np.stack([v, w], axis=1)
    odo_noise = np.cumsum(rng.normal(0, odo_drift, size=(T, 3)), axis=0)
    ds = World(scans, x + odo_noise, u, x[0].copy())
    if return_truth:
        return ds, x, landmarks
    return ds


def world_seeds(seed: int, n: int) -> list:
    """``n`` generator seeds drawn from a run's ``--seed`` (any whole
    number)."""
    return [int(s) for s in np.random.SeedSequence(
        int(seed) % (1 << 64)).generate_state(n, dtype=np.uint32)]


def make_worlds(spec: dict, seed: int, n: int, find) -> list:
    """``n`` worlds of a configuration's ``world`` spec from ``--seed``:
    the generator that ``spec["generator"]`` names (``find(name)``, the
    registry's ``world_generator``), called with the spec's other keys and
    each of the ``world_seeds`` that every generator shares."""
    kw = dict(spec)
    generate = find(kw.pop("generator"))
    return [generate(seed=s, **kw) for s in world_seeds(seed, n)]
