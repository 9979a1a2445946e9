"""Dataset loading (NumPy only; no JAX, no torch).

A copy of ``icm_slam_tpu.data.datasets`` with the same generators and
loaders, so the port runs where JAX is not installed.  For the same
arguments, on the same machine, every output is bitwise equal to the JAX
package's (tests/test_torch_frontend_data.py).

Loaders for the two reference datasets plus a synthetic world generator:

* ``data_IJAC2018.mat`` — flat arrays: observations (181,T), odometry (3,T),
  velocities (2,T).
* ``datos_palomar1.mat`` — MATLAB struct ``datos`` with fields observaciones /
  odometria / control / inicio.x0; this loader also reimplements the
  scripts/filtrar_obs.m preprocessing (range clip, noise-burst capping via
  valid-beam-count interpolation, NaN fill) in NumPy.

All loaders return time-major float arrays: scans (T,B), odom (T,3), u (T,2),
plus an initial pose x0 (3,).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class Dataset:
    scans: np.ndarray   # (T, B) raw ranges (pre radio/clip)
    odom: np.ndarray    # (T, 3)
    u: np.ndarray       # (T, 2)
    x0: np.ndarray      # (3,)
    name: str = ""

    @property
    def T(self):
        return self.scans.shape[0]

    @property
    def n_beams(self):
        return self.scans.shape[1]

    def slice(self, frames):
        return Dataset(self.scans[:frames], self.odom[:frames],
                       self.u[:frames], self.x0, self.name)


def load_ijac2018(path: str) -> Dataset:
    import scipy.io as sio
    m = sio.loadmat(path)
    scans = np.ascontiguousarray(m["observations"].T, dtype=np.float64)
    odom = np.ascontiguousarray(m["odometry"].T, dtype=np.float64)
    u = np.ascontiguousarray(m["velocities"].T, dtype=np.float64)
    return Dataset(scans, odom, u, odom[0].copy(), name="ijac2018")


def _palomar_noise_cap(scans: np.ndarray, max_range: float,
                       max_beams: int = 15) -> np.ndarray:
    """Reimplementation of scripts/filtrar_obs.m noise-burst suppression.

    Scans whose valid-beam count spikes above a linear interpolation of the
    count series (capped at ``max_beams``) are treated as noise bursts: their
    excess beams are NaN-filled (-> max range downstream).
    """
    scans = np.minimum(scans, max_range)
    valid = scans < max_range
    counts = valid.sum(axis=1).astype(float)
    capped = np.minimum(counts, max_beams)
    # smooth the count envelope by linear interpolation through capped values
    t = np.arange(len(counts))
    envelope = np.interp(t, t[capped > 0], capped[capped > 0]) \
        if (capped > 0).any() else capped
    out = scans.copy()
    for i in np.where(counts > np.maximum(envelope, max_beams))[0]:
        # burst: keep only the max_beams closest returns, drop the rest
        idx = np.where(valid[i])[0]
        order = np.argsort(scans[i, idx])
        drop = idx[order[max_beams:]]
        out[i, drop] = np.nan
    return out


def load_palomar(path: str, max_range: float = 10.0,
                 apply_noise_cap: bool = True) -> Dataset:
    import scipy.io as sio
    m = sio.loadmat(path, squeeze_me=False)
    d = m["datos"][0, 0]
    scans = np.ascontiguousarray(d["observaciones"].T, dtype=np.float64)
    odom = np.ascontiguousarray(d["odometria"].T, dtype=np.float64)
    u = np.ascontiguousarray(d["control"].T, dtype=np.float64)
    try:
        x0 = np.asarray(d["inicio"][0, 0]["x0"]).reshape(-1)[:3].astype(float)
    except Exception:
        x0 = odom[0].copy()
    if x0.size < 3:
        x0 = odom[0].copy()
    if apply_noise_cap:
        scans = _palomar_noise_cap(scans, max_range)
    return Dataset(scans, odom, u, x0, name="palomar1")


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
    ds = Dataset(scans, x + odo_noise, u, x[0].copy(), name="synthetic")
    if return_truth:
        return ds, x, landmarks
    return ds


def drifted_world(T=2000, n_landmarks=150, world_size=50.0, seed=3,
                  v_noise=0.03, w_noise=0.004, w_bias=0.001, laps=2):
    """Ground-truth world + odometry integrated from corrupted controls.

    Unlike ``synthetic_world``'s additive random walk, the drift here is
    generated the way real wheel odometry drifts: white noise plus a
    constant yaw-rate bias on the CONTROLS, Euler-integrated into the
    published odometry — so heading error compounds into unbounded position
    drift.  Returns (drifted Dataset, true trajectory (T,3), landmarks).
    Used by benchmarks/loop_closure_eval.py and tests/test_loop_closure.py.
    """
    ds, x_true, landmarks = synthetic_world(
        T=T, n_landmarks=n_landmarks, world_size=world_size, seed=seed,
        loop=True, odo_drift=0.0, return_truth=True, laps=laps)
    rng = np.random.default_rng(seed + 1)
    u_noisy = ds.u + np.stack(
        [rng.normal(0, v_noise, T),
         rng.normal(0, w_noise, T) + w_bias], axis=1)
    dt = 0.1
    odo = np.zeros((T, 3))
    odo[0] = x_true[0]
    for t in range(1, T):
        th = odo[t - 1, 2]
        odo[t] = odo[t - 1] + dt * np.array(
            [u_noisy[t - 1, 0] * np.cos(th),
             u_noisy[t - 1, 0] * np.sin(th),
             u_noisy[t - 1, 1]])
    drifted = Dataset(ds.scans, odo, u_noisy, x_true[0].copy(),
                      name="synthetic-drift")
    return drifted, x_true, landmarks


# The environment variable naming the directory that holds the reference
# project's data files (data_IJAC2018.mat, datos_palomar1.mat).
REFERENCE_DIR_ENV = "ICM_REFERENCE_DIR"


def _reference_file(name: str) -> str:
    ref_dir = os.environ.get(REFERENCE_DIR_ENV)
    if not ref_dir:
        raise FileNotFoundError(
            f"{name}: pass the .mat path, or set {REFERENCE_DIR_ENV} to the "
            f"directory that holds it")
    return os.path.join(ref_dir, name)


def load(name_or_path: str, **kw) -> Dataset:
    """A dataset by name ("ijac2018", "palomar", "synthetic") or by the
    path of a reference .mat file.  A name reads its file from the
    directory in ``$ICM_REFERENCE_DIR``; a missing file or an unset
    variable raises FileNotFoundError."""
    if name_or_path.endswith("data_IJAC2018.mat") or name_or_path == "ijac2018":
        path = name_or_path if name_or_path.endswith(".mat") else \
            _reference_file("data_IJAC2018.mat")
        return load_ijac2018(path)
    if "palomar" in name_or_path:
        path = name_or_path if name_or_path.endswith(".mat") else \
            _reference_file("datos_palomar1.mat")
        return load_palomar(path, **kw)
    if name_or_path == "synthetic":
        return synthetic_world(**kw)
    raise ValueError(f"unknown dataset {name_or_path!r}")


def world_checksum(ds: Dataset) -> str:
    """SHA-256 over a dataset's scans, odometry, controls and x0 (float64).

    NumPy's transcendental functions may round differently on another
    machine or NumPy build; a golden file made elsewhere records this
    checksum so that a run on a different world fails loudly instead of
    comparing unlike results.
    """
    import hashlib
    h = hashlib.sha256()
    for a in (ds.scans, ds.odom, ds.u, ds.x0):
        h.update(np.ascontiguousarray(a, np.float64).tobytes())
    return h.hexdigest()

