"""Loop-closure detection + pose-graph correction.

Port of ``icm_slam_tpu.models.loop_closure``:

  1. candidate pairs (host, NumPy, as in JAX): frames far apart in time
     whose estimated poses are near in space;
  2. scan registration (device, every candidate in one batch): 3-dof ICP,
     fixed-iteration nearest-point association + batched LM on the SE(2)
     relative pose, masked fixed shapes throughout;
  3. gating: closures with enough inlier beams and a low residual;
  4. pose-graph optimization: odometry chain edges + accepted closure
     edges (``models.pose_graph``).

ICP's nearest-point search is plain torch, as it is plain ``jnp`` in JAX:
each candidate pair has a table of its own (the nearest-landmark kernel
takes one table per launch).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from icm_slam_tpu_torch.models.pose_graph import (from_trajectory, optimize,
                                                  relative_se2)
from icm_slam_tpu_torch.solver.gauss_newton import lm_minimize
from icm_slam_tpu_torch.solver.sweeps import SweepData


class LoopClosures(NamedTuple):
    pairs: np.ndarray     # (K, 2) frame indices (i, j)
    rel: np.ndarray       # (K, 3) estimated pose of j in i's frame
    inliers: np.ndarray   # (K,) inlier beam fraction
    rms: np.ndarray       # (K,) inlier residual RMS [m]


def gate_schedule(gate: float, coarse_gate: Optional[float],
                  icp_iters: int) -> np.ndarray:
    """The ICP association gates (icp_iters,) float32: geometric from
    ``coarse_gate`` down to ``gate``, computed on the host in float64 and
    rounded to float32, as ``jnp.geomspace`` computes it with 64-bit
    types enabled (JAX without them computes it in float32 with XLA's own
    log and pow, which can differ by an ulp)."""
    if coarse_gate is None:
        coarse_gate = gate
    return np.geomspace(coarse_gate, gate, icp_iters).astype(np.float32)


def _body_points(dist, ang):
    """(..., B, 2) body-frame points of scans (beam convention incl. -pi/2)."""
    a = ang - math.pi / 2.0
    return dist[..., None] * torch.stack([torch.cos(a), torch.sin(a)], dim=-1)


def _transform(rel, p):
    """Points p (K, B, 2) moved by the relative poses rel (K, 3)."""
    c = torch.cos(rel[:, 2:3])
    s = torch.sin(rel[:, 2:3])
    return torch.stack([rel[:, 0:1] + c * p[..., 0] - s * p[..., 1],
                        rel[:, 1:2] + s * p[..., 0] + c * p[..., 1]], dim=-1)


def _nearest(q, pts_i, mask_i):
    """For each point of q (K, B, 2): index and distance of the nearest
    valid point of pts_i (K, B, 2) by the explicit difference norm (+inf
    where none is valid; the first minimum wins)."""
    dx = q[:, :, None, 0] - pts_i[:, None, :, 0]
    dy = q[:, :, None, 1] - pts_i[:, None, :, 1]
    d = torch.sqrt(dx * dx + dy * dy)
    d = torch.where(mask_i[:, None, :], d, float("inf"))
    dmin, idx = d.min(dim=2)
    return idx, dmin


def icp_register(pts_i, mask_i, pts_j, mask_j, rel0, icp_iters=8,
                 lm_iters=6, gate=1.0, coarse_gate=None):
    """Register scans j onto scans i, K pairs at once.  pts_* (K, B, 2),
    mask_* (K, B), rel0 (K, 3) initial relative poses of j in i's frame.
    Returns (rel (K, 3), inlier_fraction (K,), inlier_rms (K,)).

    The association gate anneals geometrically from ``coarse_gate`` to
    ``gate`` across the ICP iterations (``gate_schedule``); the inlier
    verdict uses ``gate``.
    """
    rel = rel0
    px, py = pts_j[..., 0], pts_j[..., 1]
    one, zero = torch.ones_like(px), torch.zeros_like(px)
    for g in gate_schedule(gate, coarse_gate, icp_iters).tolist():
        idx, dmin = _nearest(_transform(rel, pts_j), pts_i, mask_i)
        ok = (mask_j & (dmin < g) & torch.isfinite(dmin))[..., None]
        target = torch.gather(pts_i, 1, idx[..., None].expand(-1, -1, 2))

        def resid(r, target=target, ok=ok):
            d = (_transform(r, pts_j) - target) * ok
            return d.reshape(d.shape[0], -1)

        def jac(r, ok=ok):
            """d resid / d rel: [1, 0, -s px - c py] and [0, 1, c px - s py]
            per beam, interleaved as the residual."""
            c, s = torch.cos(r[:, 2:3]), torch.sin(r[:, 2:3])
            j = torch.stack([torch.stack([one, zero, -s * px - c * py], -1),
                             torch.stack([zero, one, c * px - s * py], -1)],
                            dim=2) * ok[..., None]
            return j.reshape(j.shape[0], -1, 3)

        rel = lm_minimize(resid, jac, rel, iters=lm_iters)
    _, dmin = _nearest(_transform(rel, pts_j), pts_i, mask_i)
    ok = mask_j & (dmin < gate) & torch.isfinite(dmin)
    n_ok = ok.sum(dim=1)
    frac = n_ok / torch.clamp(mask_j.sum(dim=1), min=1)
    rms = torch.sqrt(torch.where(ok, dmin * dmin, 0.0).sum(dim=1)
                     / torch.clamp(n_ok, min=1))
    return rel, frac, rms


def detect(data: SweepData, x, min_gap: int = 150, radius: float = 2.0,
           max_pairs: int = 64, min_inliers: float = 0.5,
           max_rms: float = 0.25, min_beams: int = 5,
           icp_gate: float = 1.0,
           icp_coarse_gate: Optional[float] = None) -> LoopClosures:
    """Find and verify loop closures on the trajectory estimate x (T, 3)."""
    xs = x.cpu().numpy()
    mask = data.mask.cpu().numpy()
    n_valid = mask.sum(1)
    T = xs.shape[0]

    # --- host-side candidate selection (greedy, spatially thinned) ---------
    cands = []
    taken = np.zeros(T, bool)
    order = np.arange(0, T, 5)
    for i in order:
        if n_valid[i] < min_beams:
            continue
        d = np.linalg.norm(xs[:, :2] - xs[i, :2], axis=1)
        js = np.where((np.arange(T) > i + min_gap) & (d < radius)
                      & (n_valid >= min_beams))[0]
        if js.size and not taken[i]:
            j = int(js[np.argmin(d[js])])
            cands.append((i, j))
            taken[max(0, i - 20):i + 20] = True
        if len(cands) >= max_pairs:
            break
    if not cands:
        empty = np.zeros((0,))
        return LoopClosures(np.zeros((0, 2), int), np.zeros((0, 3)),
                            empty, empty)

    pairs = np.asarray(cands, np.int32)

    # --- device-side batched ICP -------------------------------------------
    ii = torch.as_tensor(pairs[:, 0], device=x.device).long()
    jj = torch.as_tensor(pairs[:, 1], device=x.device).long()
    ang = data.ang if data.ang.dim() == 2 else data.ang.expand(
        data.dist.shape)
    rel, frac, rms = icp_register(
        _body_points(data.dist[ii], ang[ii]), data.mask[ii],
        _body_points(data.dist[jj], ang[jj]), data.mask[jj],
        relative_se2(x[ii], x[jj]), gate=icp_gate,
        coarse_gate=icp_coarse_gate)
    rel, frac, rms = (a.cpu().numpy() for a in (rel, frac, rms))
    keep = (frac >= min_inliers) & (rms <= max_rms)
    return LoopClosures(pairs[keep], rel[keep], frac[keep], rms[keep])


def estimate_correctable_drift(x, odom, closures: LoopClosures
                               ) -> Tuple[float, float]:
    """Two revisit-disagreement signals [m], medians over the closures
    (``icm_slam_tpu.models.loop_closure.estimate_correctable_drift``):
    ``d_x``, the estimate's own relative pose against the ICP-measured one,
    and ``d_odo``, the odometry chain's relative pose against it (the
    drift the pose-graph solve corrects)."""
    ii = torch.as_tensor(closures.pairs[:, 0], device=x.device).long()
    jj = torch.as_tensor(closures.pairs[:, 1], device=x.device).long()
    rel = np.asarray(closures.rel)[:, :2]
    pred_x = relative_se2(x[ii], x[jj]).cpu().numpy()[:, :2]
    pred_o = relative_se2(odom[ii], odom[jj]).cpu().numpy()[:, :2]
    d_x = float(np.median(np.linalg.norm(pred_x - rel, axis=1)))
    d_odo = float(np.median(np.linalg.norm(pred_o - rel, axis=1)))
    return d_x, d_odo


def close_loops(data: SweepData, x, config, closures: Optional[LoopClosures]
                = None, odo_weight: float = 5.0, loop_weight: float = 20.0,
                gn_iters: int = 10, cg_iters: int = 200, rounds: int = 1,
                min_drift: float = 0.15, drift_gate_rms: float = 3.5,
                odo_drift_frac: float = 0.3,
                report: Optional[dict] = None,
                **detect_kw) -> Tuple[torch.Tensor, LoopClosures]:
    """Detect closures (unless given) and pose-graph-correct the trajectory.

    As ``icm_slam_tpu.models.loop_closure.close_loops``: chain edges
    measure the raw odometry's relative motions, closure edges the ICP
    relatives; returns (x_corrected, closures of the final round).  The
    regime guard applies a round only when the correctable drift
    ``max(d_x, odo_drift_frac * d_odo)`` reaches ``max(min_drift,
    drift_gate_rms * median closure RMS)`` (``min_drift <= 0``: no guard),
    and guards round 1 only; below it ``x`` comes back unchanged (the same
    tensor).  ``rounds > 1`` iterates detect -> correct.  A dict passed as
    ``report`` receives the per-round rows under ``"rounds"``.
    """
    odo = data.odom
    odom_rel = relative_se2(odo[:-1], odo[1:])
    last = None
    rows = [] if report is None else report.setdefault("rounds", [])
    for _ in range(max(rounds, 1)):
        if closures is None:
            closures = detect(data, x, **detect_kw)
        if closures.pairs.shape[0] == 0:
            # a dry later round returns the closures that were applied
            return x, (closures if last is None else last)
        noise = float(np.median(closures.rms))
        gate = 0.0 if min_drift <= 0 else max(min_drift,
                                              drift_gate_rms * noise)
        d_x, d_odo = estimate_correctable_drift(x, odo, closures)
        est_drift = max(d_x, odo_drift_frac * d_odo)
        guarded = last is None
        apply = (not guarded) or est_drift >= gate
        rows.append({"n_closures": int(closures.pairs.shape[0]),
                     "est_drift_m": round(est_drift, 4),
                     "gate_m": round(gate, 4),
                     "d_x_m": round(d_x, 4), "d_odo_m": round(d_odo, 4),
                     "noise_rms_m": round(noise, 4),
                     "guarded": guarded,
                     "applied": apply})
        if not apply:
            return x, closures
        g = from_trajectory(x, odom_rel_noise=odom_rel,
                            loop_pairs=closures.pairs, loop_rel=closures.rel,
                            odo_weight=odo_weight, loop_weight=loop_weight)
        x, _ = optimize(g, gn_iters=gn_iters, cg_iters=cg_iters)
        last = closures
        closures = None
    return x, last
