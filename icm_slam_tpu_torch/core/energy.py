"""Per-pose energy terms as weighted least-squares residuals, batched.

Port of ``icm_slam_tpu.core.energy`` for the default model (unicycle
kinematics, unscaled observation potential, no extra residuals).  Every
function takes a leading problem axis P in place of ``vmap``: ``x`` is
(P, 3) and every ``PoseProblem`` field carries the same leading P.  The
residual stacking is the JAX package's, so energy(x) == sum(r(x)**2):

  one-sided  [r_kin (3), r_obs (2B, interleaved x/y per beam), r_odo (3)]
  two-sided  [r_kinf (3), r_odof (3), one-sided (6 + 2B)]

The analytic Jacobians are the LM solver's Jacobian here (the JAX package
keeps them for tests and differentiates with ``jacfwd``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from icm_slam_tpu_torch.core.geometry import unicycle_step, wrap_angle


class PoseProblem(NamedTuple):
    """Batched data of P pose problems (the one-sided cost ignores *_next)."""
    dist: torch.Tensor      # (P, B) filtered beam ranges
    ang: torch.Tensor       # (P, B) beam angles [rad]
    mask: torch.Tensor      # (P, B) informative-beam mask
    matched: torch.Tensor   # (P, B, 2) associated landmark positions
    x_prev: torch.Tensor    # (P, 3)
    u_prev: torch.Tensor    # (P, 2) control at t-1
    odo_prev: torch.Tensor  # (P, 3) odometry at t-1
    odo_cur: torch.Tensor   # (P, 3) odometry at t
    x_next: torch.Tensor    # (P, 3)
    u_cur: torch.Tensor     # (P, 2) control at t
    odo_next: torch.Tensor  # (P, 3) odometry at t+1


def _odo_residual(th_anchor, odo0, odo1, dxy, dth):
    """Relative-displacement odometry residual (P, 3).

    rot2(odo0_theta) @ (odo1_xy - odo0_xy) - rot2(th_anchor) @ dxy, plus the
    wrapped heading increment mismatch.
    """
    c0, s0 = torch.cos(odo0[:, 2]), torch.sin(odo0[:, 2])
    ca, sa = torch.cos(th_anchor), torch.sin(th_anchor)
    d0 = odo1[:, 0] - odo0[:, 0]
    d1 = odo1[:, 1] - odo0[:, 1]
    rx = (c0 * d0 + s0 * d1) - (ca * dxy[:, 0] + sa * dxy[:, 1])
    ry = (-s0 * d0 + c0 * d1) - (-sa * dxy[:, 0] + ca * dxy[:, 1])
    rth = wrap_angle(odo1[:, 2] - odo0[:, 2] - dth)
    return torch.stack([rx, ry, rth], dim=-1)


def obs_residuals(x, p: PoseProblem, sqrt_q):
    """(P, B, 2) masked observation residuals (the h potential)."""
    a = p.ang + x[:, 2:3] - math.pi / 2.0
    pts = x[:, None, :2] + p.dist[..., None] * torch.stack(
        [torch.cos(a), torch.sin(a)], dim=-1)
    r = (pts - p.matched) * sqrt_q
    return torch.where(p.mask[..., None], r, torch.zeros_like(r))


def _wrap_heading(gg):
    """(P, 3) pose difference with its heading wrapped."""
    return torch.cat([gg[:, :2], wrap_angle(gg[:, 2:3])], dim=1)


def one_sided_residuals(x, p: PoseProblem, w):
    """Residuals of fun_x, (P, 6 + 2B). w = (sqrt_r, sqrt_q, sqrt_odom, deltat)."""
    sqrt_r, sqrt_q, sqrt_odom, deltat = w
    r_kin = sqrt_r * _wrap_heading(
        x - unicycle_step(p.x_prev, p.u_prev, deltat))
    r_obs = obs_residuals(x, p, sqrt_q)
    r_odo = sqrt_odom * _odo_residual(
        p.x_prev[:, 2], p.odo_prev, p.odo_cur, x[:, :2] - p.x_prev[:, :2],
        x[:, 2] - p.x_prev[:, 2])
    return torch.cat([r_kin, r_obs.reshape(x.shape[0], -1), r_odo], dim=1)


def two_sided_residuals(x, p: PoseProblem, w):
    """Residuals of fun_xn, (P, 12 + 2B): forward + backward terms."""
    sqrt_r, sqrt_q, sqrt_odom, deltat = w
    r_kinf = sqrt_r * _wrap_heading(
        unicycle_step(x, p.u_cur, deltat) - p.x_next)
    r_odof = sqrt_odom * _odo_residual(
        x[:, 2], p.odo_cur, p.odo_next, p.x_next[:, :2] - x[:, :2],
        p.x_next[:, 2] - x[:, 2])
    return torch.cat([r_kinf, r_odof, one_sided_residuals(x, p, w)], dim=1)


def one_sided_jacobian(x, p: PoseProblem, w):
    """Analytic Jacobian of one_sided_residuals wrt x, (P, 6 + 2B, 3).

    The kinematic term is identity in x (wrap has unit slope); each
    observation row depends on (x, y) identically and on theta through the
    beam direction; the odometry xy-block is -R(theta_prev), its heading
    row -1.
    """
    sqrt_r, sqrt_q, sqrt_odom, _ = w
    P, B = p.dist.shape
    dtype, dev = x.dtype, x.device

    j_kin = torch.diag(sqrt_r).expand(P, 3, 3)

    a = p.ang + x[:, 2:3] - math.pi / 2.0
    dsin = p.dist * torch.sin(a)
    dcos = p.dist * torch.cos(a)
    zeros = torch.zeros((P, B), dtype=dtype, device=dev)
    ones = torch.ones((P, B), dtype=dtype, device=dev)
    m = p.mask.to(dtype)
    jx = torch.stack([ones, zeros, -dsin], dim=-1) * (sqrt_q[0] * m)[..., None]
    jy = torch.stack([zeros, ones, dcos], dim=-1) * (sqrt_q[1] * m)[..., None]
    j_obs = torch.stack([jx, jy], dim=2).reshape(P, 2 * B, 3)

    c, s = torch.cos(p.x_prev[:, 2]), torch.sin(p.x_prev[:, 2])
    z = torch.zeros_like(c)
    j_odo = sqrt_odom * torch.stack([
        torch.stack([-c, -s, z], dim=-1),
        torch.stack([s, -c, z], dim=-1),
        torch.stack([z, z, z - 1.0], dim=-1)], dim=1)
    return torch.cat([j_kin, j_obs, j_odo], dim=1)


def two_sided_jacobian(x, p: PoseProblem, w):
    """Analytic Jacobian of two_sided_residuals, (P, 12 + 2B, 3)."""
    sqrt_r, sqrt_q, sqrt_odom, deltat = w
    v = p.u_cur[:, 0]
    c, s = torch.cos(x[:, 2]), torch.sin(x[:, 2])
    z = torch.zeros_like(c)
    one = z + 1.0

    # forward kinematic: d g(x,u)/dx = I + dt*[[0,0,-v s],[0,0,v c],[0,0,0]]
    j_kinf = sqrt_r[:, None] * torch.stack([
        torch.stack([one, z, -deltat * v * s], dim=-1),
        torch.stack([z, one, deltat * v * c], dim=-1),
        torch.stack([z, z, one], dim=-1)], dim=1)

    # forward odometry: rxy = meas - R(th)(xn - x); R = [[c,s],[-s,c]]
    dx = p.x_next[:, 0] - x[:, 0]
    dy = p.x_next[:, 1] - x[:, 1]
    dRd0 = -s * dx + c * dy
    dRd1 = -c * dx - s * dy
    j_odof = sqrt_odom * torch.stack([
        torch.stack([c, s, -dRd0], dim=-1),
        torch.stack([-s, c, -dRd1], dim=-1),
        torch.stack([z, z, one], dim=-1)], dim=1)

    j_back = one_sided_jacobian(x, p, w)
    return torch.cat([j_kinf, j_odof, j_back], dim=1)


def weights(config, device=None):
    """sqrt weights (sqrt_r (3,), sqrt_q (2,), sqrt_odom (), deltat)."""
    dtype = getattr(torch, config.dtype)
    sqrt_r = torch.sqrt(torch.tensor(config.R, dtype=dtype, device=device))
    sqrt_q = torch.sqrt(torch.tensor(config.Q, dtype=dtype, device=device))
    sqrt_odom = torch.sqrt(torch.tensor(config.cte_odom, dtype=dtype,
                                        device=device))
    return sqrt_r, sqrt_q, sqrt_odom, config.deltat
