"""Joint pose + landmark Gauss-Newton with a Schur complement ("full-chain
BA", ``sweep_mode="ba"``).

Port of ``icm_slam_tpu.models.bundle_adjustment``.  It minimizes the
global MRF energy

    E(x, y) = sum_t |x_t - g(x_{t-1}, u)|_R^2 + cte |odo residual_t|^2
            + sum_{t,b} mask |world(x_t, beam) - y_{label(t,b)}|_Q^2

jointly over the poses x (T, 3) and the landmarks y (L, 2):

* associations are frozen per outer iteration (``batched_associate``,
  through the port's kernels on the card);
* the landmark block H_yy is diagonal (Q * count_l), so its inverse is
  elementwise;
* the reduced pose system is solved matrix-free by PCG, each Schur
  product one ``torch.func.jvp`` and one ``vjp`` of the stacked
  residuals, block-Jacobi preconditioned with the exact per-pose 3x3
  blocks of J_x^T J_x from 6 Hessian products (the residual graph is
  banded in t, so poses of one parity share no residual);
* dy back-substitutes in closed form, and a GN step is kept only when it
  lowers the energy.

No host sync: every GN step's accept is a ``torch.where``.  The landmark
sums go through ``landmark_map.add_rows``, so they add in a fixed order
on the card too.  A fleet of W worlds (fleet mode) runs as one batch of W
independent problems on a leading world axis (the JAX package's
``vmap``).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from icm_slam_tpu_torch.core.energy import _odo_residual, _wrap_heading
from icm_slam_tpu_torch.core.geometry import beams_to_world, unicycle_step
from icm_slam_tpu_torch.mapping.landmark_map import MapState, add_rows
from icm_slam_tpu_torch.models.pose_graph import _pcg, apply_blocks
from icm_slam_tpu_torch.solver.sweeps import (SweepData, _per_frame_ang,
                                              batched_associate)


class BAProblem(NamedTuple):
    """Fixed association + beam-compacted observation arrays.

    dist/ang/labels/obs_w are (T, K) with K = obs_cap (or B uncompacted);
    compaction is exact when K >= the max per-frame valid-beam count.  A
    fleet's problems carry a leading world axis W on every field.
    """
    data: SweepData
    dist: torch.Tensor        # (T, K) beam ranges feeding the obs term
    ang: torch.Tensor         # (T, K) beam angles
    labels: torch.Tensor      # (T, K) int32 in [0, L]; L = discard
    obs_w: torch.Tensor       # (T, K) 0/1 observation weights
    counts: torch.Tensor      # (L,) per-landmark observation counts
    live: torch.Tensor        # (L,) live-landmark mask (counts > 0)


def _rows(table, idx):
    """``table[idx]`` for a table (L, c) and indices (T, K), each world of
    a fleet (a leading W on both) in its own table: (..., T, K, c)."""
    lead = idx.shape[:-2]
    if not lead:
        return table[idx]
    flat = idx.reshape(lead + (-1, 1)).expand(lead + (idx[0].numel(),
                                                      table.shape[-1]))
    return torch.gather(table, -2, flat).view(idx.shape + table.shape[-1:])


def _residuals(x, y, p: BAProblem, w):
    """Stacked residuals: (obs (T, K, 2), kin (T-1, 3), odo (T-1, 3)); a
    fleet's (x (W, T, 3), y (W, L, 2)) each with the world axis in front."""
    sqrt_r, sqrt_q, sqrt_odom, deltat = w
    data = p.data
    L = y.shape[-2]

    # observations: world points minus matched landmarks (linear in y)
    pts = beams_to_world(x, p.dist, p.ang)                    # (T, K, 2)
    matched = _rows(y, torch.clamp(p.labels, 0, L - 1).long())
    r_obs = (pts - matched) * sqrt_q * p.obs_w[..., None]

    # kinematic chain (one-sided form: the global MRF energy)
    r_kin = sqrt_r * _wrap_heading(
        x[..., 1:, :] - unicycle_step(x[..., :-1, :], data.u[..., :-1, :],
                                      deltat))

    # odometry relative-displacement residuals
    r_odo = _odo_residual(x[..., :-1, 2], data.odom[..., :-1, :],
                          data.odom[..., 1:, :],
                          x[..., 1:, :2] - x[..., :-1, :2],
                          x[..., 1:, 2] - x[..., :-1, 2]) * sqrt_odom
    return r_obs, r_kin, r_odo


def _sqsum(tree, lead=()):
    """The sum of squares of every residual: () for one world, (W,) per
    world for a fleet (``lead`` its world axes)."""
    if not lead:
        return sum((t * t).sum() for t in tree)
    return sum((t * t).flatten(len(lead)).sum(-1) for t in tree)


def _dot(a, b, lead=()):
    """Inner product of two pose-space vectors, per world for a fleet:
    () or (W, 1, 1), so that it scales each world's (T, 3) on its own."""
    if not lead:
        return (a * b).sum()
    return (a * b).flatten(len(lead)).sum(-1)[..., None, None]


def energy(x, y, p: BAProblem, w):
    """The BA energy at (x, y): (), or (W,) for a fleet's problems."""
    return _sqsum(_residuals(x, y, p, w), x.shape[:-2])


def ba_problem(data: SweepData, old_map: MapState, x, config):
    """Batched association at ``x`` and the beam-compacted BAProblem.

    Returns (problem, the map of the association: its running-mean
    positions are the exact minimizer of the observation term given x).
    A fleet (``x`` (W, T, 3), ``data`` and ``old_map`` with the world
    axis) is one association for all W worlds.
    """
    L = old_map.pos.shape[-2]
    data2 = _per_frame_ang(data)
    labels, assoc_map, _ = batched_associate(data2, old_map, x, config)

    # beam compaction (exact: see solver.sweeps.compact_data)
    valid = (labels < L) & data.mask
    cap = config.obs_cap if config.obs_cap else data.dist.shape[-1]
    order = torch.argsort((~valid).to(torch.int8), dim=-1,
                          stable=True)[..., :cap]
    prob = BAProblem(data2, torch.gather(data.dist, -1, order),
                     torch.gather(data2.ang, -1, order),
                     torch.gather(labels, -1, order),
                     torch.gather(valid, -1, order).to(x.dtype),
                     assoc_map.counts, assoc_map.counts > 0)
    return prob, assoc_map


def _frame_first(x) -> bool:
    """Whether the landmark sums take each frame's beams first (bins L + 1
    apart per frame), then the frames: on the card, where ``add_rows``
    adds the rows of one index in turn, so a landmark's run over all T * K
    beams took ~14 ms a call at T=1833 (NVIDIA H100 80GB HBM3, 700 W); the
    CPU adds them all in one pass, in the order of the rows."""
    return x.is_cuda


class Linearization(NamedTuple):
    """One Gauss-Newton step's linear system at (x, y), matrix-free."""
    r: tuple                  # the residuals at (x, y)
    gy: torch.Tensor          # (L, 2) J_y^T r_obs, zero off the live rows
    jx: Callable              # v (T, 3) -> J_x (gauge v), residual space
    hyy_inv: Callable         # (L, 2) -> H_yy^-1 applied, zero off live
    obs_vjp_y: Callable       # r_obs (T, K, 2) -> J_y^T r_obs (L, 2)
    schur_mv: Callable        # v (T, 3) -> S v, the reduced pose system
    rhs: torch.Tensor         # (T, 3) its right-hand side
    blocks: torch.Tensor      # (T, 3, 3) block-Jacobi blocks of J_x^T J_x
                              # (+ damping; pose 0's is the identity)


def linearize(prob: BAProblem, x, y, w, damping: float = 1e-5
              ) -> Linearization:
    """The Schur-reduced GN system of ``prob`` at (x, y): pose 0 is
    gauge-anchored, the landmark block H_yy = Q * count is diagonal.  A
    fleet's system (a leading world axis W on ``prob``, x and y, and on
    every vector below) is W independent systems: each world's pose 0 is
    anchored, and its landmark sums land in its own rows of one flat
    table, each world's L + 1 rows apart."""
    sqrt_q = w[1]
    L = y.shape[-2]
    T = x.shape[-2]
    lead = x.shape[:-2]
    n = math.prod(lead)
    lab_clip = torch.clamp(prob.labels, 0, L - 1).long()
    lab_seg = torch.clamp(prob.labels, max=L).long()
    frame_first = _frame_first(x)
    if frame_first:
        lab_seg = lab_seg + torch.arange(0, n * T * (L + 1), L + 1,
                                         device=x.device).view(
                                             lead + (T, 1))
    elif lead:
        lab_seg = lab_seg + torch.arange(0, n * (L + 1), L + 1,
                                         device=x.device).view(
                                             lead + (1, 1))
    lab_seg = lab_seg.reshape(-1)
    qw = sqrt_q * prob.obs_w[..., None]                      # (T, K, 2)
    live = prob.live[..., None]
    gauge = torch.ones((T, 3), dtype=x.dtype, device=x.device)
    gauge[0] = 0.0                                           # anchor pose 0
    eye = torch.eye(3, dtype=x.dtype, device=x.device)

    def obs_vjp_y(r_obs):
        frames = T if frame_first else 1
        out = torch.zeros((n * frames * (L + 1), 2), dtype=x.dtype,
                          device=x.device)
        add_rows(out, lab_seg, (-(r_obs * qw)).reshape(-1, 2))
        if frame_first:
            return out.view(lead + (T, L + 1, 2)).sum(dim=-3)[..., :L, :]
        return out.view(lead + (L + 1, 2))[..., :L, :]

    def obs_jvp_y(dy):
        return -_rows(dy, lab_clip) * qw

    def hyy_inv(gy):
        denom = prob.counts[..., None] * (sqrt_q * sqrt_q) + damping
        return torch.where(live, gy / denom, 0.0)

    def rx(xx):
        return _residuals(xx, y, prob, w)

    r, vjp_x = torch.func.vjp(rx, x)
    gy = torch.where(live, obs_vjp_y(r[0]), 0.0)

    def jx(v):
        return torch.func.jvp(rx, (x,), (v * gauge,))[1]

    def jxt(rt):
        return vjp_x(rt)[0] * gauge

    def schur_mv(v):
        jv = jx(v)
        corr = obs_jvp_y(hyy_inv(obs_vjp_y(jv[0])))
        return jxt((jv[0] - corr, jv[1], jv[2])) + damping * v * gauge

    rhs = -(vjp_x(r)[0] * gauge
            - jxt((obs_jvp_y(hyy_inv(gy)), torch.zeros_like(r[1]),
                   torch.zeros_like(r[2]))))
    # poses of one parity share no residual, so J_x^T J_x e_i on one
    # parity gives those poses' exact diagonal blocks (2 colours x 3)
    parity = torch.arange(T, device=x.device) % 2
    cols = []
    for i in range(3):
        acc = torch.zeros_like(x)
        for p_ in range(2):
            sel = (parity == p_).to(x.dtype)[:, None]
            acc = acc + jxt(jx((eye[i] * sel).expand_as(x))) * sel
        cols.append(acc)
    blocks = torch.stack(cols, dim=-1) + damping * eye       # (T, 3, 3)
    blocks[..., 0, :, :] = eye
    return Linearization(r, gy, jx, hyy_inv, obs_vjp_y, schur_mv, rhs,
                         blocks)


def ba_refine(data: SweepData, old_map: MapState, x, config, w,
              gn_iters: int = 6, cg_iters: int = 60, damping: float = 1e-5,
              report: Optional[dict] = None
              ) -> Tuple[MapState, torch.Tensor]:
    """One outer BA iteration: batched association + joint GN-Schur solve.

    Returns (map_state with the optimized landmark positions, optimized
    poses).  A dict passed as ``report`` receives ``"energies"``, the
    energy after each GN step (gn_iters,), on the device.  A fleet (``x``
    (W, T, 3), ``data`` and ``old_map`` with the world axis) solves its W
    problems in one batch: every inner product of the PCG, its step sizes
    and each GN step's accept test are taken per world (``energies``
    (gn_iters, W)), so a world's solve is the solve of that world alone.
    """
    prob, assoc_map = ba_problem(data, old_map, x, config)
    T = x.shape[-2]
    lead = x.shape[:-2]
    gauge = torch.ones((T, 3), dtype=x.dtype, device=x.device)
    gauge[0] = 0.0
    y = assoc_map.pos
    energies = []
    for _ in range(gn_iters):
        lin = linearize(prob, x, y, w, damping)
        Minv = torch.linalg.inv_ex(lin.blocks).inverse     # no sync
        dx = _pcg(lin.schur_mv, lin.rhs,
                  lambda rr: apply_blocks(Minv, rr) * gauge, cg_iters,
                  dot=lambda a, b: _dot(a, b, lead))
        # back-substitute landmarks: dy = -H_yy^-1 (gy + J_y^T J_x dx)
        dy = -lin.hyy_inv(lin.gy + lin.obs_vjp_y(lin.jx(dx)[0]))
        x_new, y_new = x + dx, y + dy
        e_old = _sqsum(lin.r, lead)
        e_new = energy(x_new, y_new, prob, w)
        ok = e_new.reshape(e_new.shape + (1, 1)) < e_old.reshape(
            e_old.shape + (1, 1))
        x = torch.where(ok, x_new, x)
        y = torch.where(ok, y_new, y)
        energies.append(torch.minimum(e_new, e_old))
    if report is not None:
        report["energies"] = (torch.stack(energies) if energies
                              else x.new_zeros((0,) + lead))
    final = MapState(torch.where(prob.live[..., None], y, 0.0), prob.counts,
                     assoc_map.nact)
    return final, x
