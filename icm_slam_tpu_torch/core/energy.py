"""Per-pose energy terms as weighted least-squares residuals, batched.

Port of ``icm_slam_tpu.core.energy``.  Every function takes a leading
problem axis P in place of ``vmap``: ``x`` is (P, 3) and every
``PoseProblem`` field carries the same leading P.  The residual stacking
is the JAX package's, so energy(x) == sum(r(x)**2); for the default model

  one-sided  [r_kin (3), r_obs (2B, interleaved x/y per beam), r_odo (3)]
  two-sided  [r_kinf (3), r_odof (3), one-sided (6 + 2B)]

and an ``EnergyModel``'s hooks replace or extend these terms exactly as
in the JAX package.  The Jacobians are analytic for the default terms and
forward mode for a hook's own terms only (``hook_jacobian``), where the
JAX package takes ``jacfwd`` of the whole residual: on an H100, forward
mode over the whole residual made a hooks sweep 2.3-2.6x slower
(``tools/time_jacobian_routes.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.autograd.forward_ad as fwAD

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


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    """User-extensible energy definition (``icm_slam_tpu.core.energy.
    EnergyModel``, the reference's subclass hooks g/h/fun_x/fun_xn).

    Every hook is torch code in the port's batched convention: ``x`` is
    (P, 3), every ``PoseProblem`` field has a leading P, and a hook returns
    one row per problem.  **A hook must treat the rows of P independently**
    (row p of its output may depend on row p of its inputs only): the LM
    solver takes the Jacobian of all P problems from one forward-mode pass
    over the problems stacked three times (``hook_jacobian``), which is
    exact only then.  Hooks are differentiated by forward mode, so they
    must be functional (``torch.cat`` / ``torch.where`` in place of
    in-place writes).

    Elementwise tweaks (compose with the default terms):
      kinematics(x, u, deltat) -> (P, 3)      replaces g
      obs_scale(dist, ang) -> (P, B)           per-beam residual scaling
      extra_one_sided(x, prob) -> (P, k)       residuals appended to fun_x
      extra_two_sided(x, prob) -> (P, k)       residuals appended to fun_xn

    Full replacements:
      obs_model(x, prob, sqrt_q) -> (P, ...)   the whole observation term;
                                               masks invalid beams itself
      one_sided(x, prob, w) -> (P, k)          replaces fun_x
      two_sided(x, prob, w) -> (P, k)          replaces fun_xn

    ``w`` is the ``weights()`` tuple (sqrt_r, sqrt_q, sqrt_odom, deltat).
    A replacement may call the default builders with ``DEFAULT_MODEL``.
    """
    kinematics: Callable = unicycle_step
    obs_scale: Optional[Callable] = None
    extra_one_sided: Optional[Callable] = None
    extra_two_sided: Optional[Callable] = None
    obs_model: Optional[Callable] = None
    one_sided: Optional[Callable] = None
    two_sided: Optional[Callable] = None


DEFAULT_MODEL = EnergyModel()


def _odo_residual(th_anchor, odo0, odo1, dxy, dth):
    """Relative-displacement odometry residual (..., 3).

    rot2(odo0_theta) @ (odo1_xy - odo0_xy) - rot2(th_anchor) @ dxy, plus the
    wrapped heading increment mismatch.
    """
    c0, s0 = torch.cos(odo0[..., 2]), torch.sin(odo0[..., 2])
    ca, sa = torch.cos(th_anchor), torch.sin(th_anchor)
    d0 = odo1[..., 0] - odo0[..., 0]
    d1 = odo1[..., 1] - odo0[..., 1]
    rx = (c0 * d0 + s0 * d1) - (ca * dxy[..., 0] + sa * dxy[..., 1])
    ry = (-s0 * d0 + c0 * d1) - (-sa * dxy[..., 0] + ca * dxy[..., 1])
    rth = wrap_angle(odo1[..., 2] - odo0[..., 2] - dth)
    return torch.stack([rx, ry, rth], dim=-1)


def obs_residuals(x, p: PoseProblem, sqrt_q,
                  model: EnergyModel = DEFAULT_MODEL):
    """(P, B, 2) masked observation residuals (the h potential), or what
    ``model.obs_model`` returns; ``obs_scale`` scales before the mask."""
    if model.obs_model is not None:
        return model.obs_model(x, p, sqrt_q)
    a = p.ang + x[:, 2:3] - math.pi / 2.0
    pts = x[:, None, :2] + p.dist[..., None] * torch.stack(
        [torch.cos(a), torch.sin(a)], dim=-1)
    r = (pts - p.matched) * sqrt_q
    if model.obs_scale is not None:
        r = r * model.obs_scale(p.dist, p.ang)[..., None]
    return torch.where(p.mask[..., None], r, torch.zeros_like(r))


def _wrap_heading(gg):
    """(..., 3) pose difference with its heading wrapped."""
    return torch.cat([gg[..., :2], wrap_angle(gg[..., 2:3])], dim=-1)


def one_sided_residuals(x, p: PoseProblem, w,
                        model: EnergyModel = DEFAULT_MODEL):
    """Residuals of fun_x, (P, 6 + 2B) for the default model:
    [r_kin, r_obs, r_odo, extra_one_sided]. w = (sqrt_r, sqrt_q,
    sqrt_odom, deltat)."""
    if model.one_sided is not None:
        return model.one_sided(x, p, w)
    sqrt_r, sqrt_q, sqrt_odom, deltat = w
    r_kin = sqrt_r * _wrap_heading(
        x - model.kinematics(p.x_prev, p.u_prev, deltat))
    r_obs = obs_residuals(x, p, sqrt_q, model)
    r_odo = sqrt_odom * _odo_residual(
        p.x_prev[:, 2], p.odo_prev, p.odo_cur, x[:, :2] - p.x_prev[:, :2],
        x[:, 2] - p.x_prev[:, 2])
    parts = [r_kin, r_obs.reshape(x.shape[0], -1), r_odo]
    if model.extra_one_sided is not None:
        parts.append(model.extra_one_sided(x, p))
    return torch.cat(parts, dim=1)


def two_sided_residuals(x, p: PoseProblem, w,
                        model: EnergyModel = DEFAULT_MODEL):
    """Residuals of fun_xn, (P, 12 + 2B) for the default model: [r_kinf,
    r_odof, one-sided, extra_two_sided]."""
    if model.two_sided is not None:
        return model.two_sided(x, p, w)
    sqrt_r, sqrt_q, sqrt_odom, deltat = w
    r_kinf = sqrt_r * _wrap_heading(
        model.kinematics(x, p.u_cur, deltat) - p.x_next)
    r_odof = sqrt_odom * _odo_residual(
        x[:, 2], p.odo_cur, p.odo_next, p.x_next[:, :2] - x[:, :2],
        p.x_next[:, 2] - x[:, 2])
    parts = [r_kinf, r_odof, one_sided_residuals(x, p, w, model)]
    if model.extra_two_sided is not None:
        parts.append(model.extra_two_sided(x, p))
    return torch.cat(parts, dim=1)


def hook_jacobian(fn, x, p: PoseProblem):
    """(P, m, 3) Jacobian in x of a hook ``fn(x, p) -> (P, m)``: one
    forward-mode pass over x and ``p`` stacked three times, the k-th copy
    carrying the tangent e_k.  Exact because a hook treats the rows of P
    independently; a hook that does not read x gives zeros."""
    P = x.shape[0]
    tiled = PoseProblem(*[f.repeat(3, *([1] * (f.dim() - 1))) for f in p])
    tangent = torch.eye(3, dtype=x.dtype, device=x.device).repeat_interleave(
        P, dim=0)
    with fwAD.dual_level():
        out = fn(fwAD.make_dual(x.repeat(3, 1), tangent), tiled)
        primal, jac = fwAD.unpack_dual(out)
    if jac is None:
        jac = torch.zeros_like(primal)
    return jac.reshape(3, P, -1).permute(1, 2, 0)


def one_sided_jacobian(x, p: PoseProblem, w,
                       model: EnergyModel = DEFAULT_MODEL):
    """Jacobian of one_sided_residuals wrt x, (P, 6 + 2B, 3) for the
    default model.

    The kinematic term is identity in x (wrap has unit slope, and the
    prediction reads only x_prev); each observation row depends on (x, y)
    identically and on theta through the beam direction, scaled by
    ``obs_scale``, which reads no pose; the odometry xy-block is
    -R(theta_prev), its heading row -1.  A replacing hook and the extra
    residuals are differentiated by ``hook_jacobian``.
    """
    if model.one_sided is not None:
        return hook_jacobian(lambda xx, pp: model.one_sided(xx, pp, w), x, p)
    sqrt_r, sqrt_q, sqrt_odom, _ = w
    P, B = p.dist.shape
    dtype, dev = x.dtype, x.device

    j_kin = torch.diag(sqrt_r).expand(P, 3, 3)

    if model.obs_model is not None:
        j_obs = hook_jacobian(
            lambda xx, pp: model.obs_model(xx, pp, sqrt_q).reshape(
                xx.shape[0], -1), x, p)
    else:
        a = p.ang + x[:, 2:3] - math.pi / 2.0
        dsin = p.dist * torch.sin(a)
        dcos = p.dist * torch.cos(a)
        zeros = torch.zeros((P, B), dtype=dtype, device=dev)
        ones = torch.ones((P, B), dtype=dtype, device=dev)
        m = p.mask.to(dtype)
        if model.obs_scale is not None:
            m = torch.where(p.mask, model.obs_scale(p.dist, p.ang), 0.0)
        jx = torch.stack([ones, zeros, -dsin], dim=-1) * (
            sqrt_q[0] * m)[..., None]
        jy = torch.stack([zeros, ones, dcos], dim=-1) * (
            sqrt_q[1] * m)[..., None]
        j_obs = torch.stack([jx, jy], dim=2).reshape(P, 2 * B, 3)

    c, s = torch.cos(p.x_prev[:, 2]), torch.sin(p.x_prev[:, 2])
    z = torch.zeros_like(c)
    j_odo = sqrt_odom * torch.stack([
        torch.stack([-c, -s, z], dim=-1),
        torch.stack([s, -c, z], dim=-1),
        torch.stack([z, z, z - 1.0], dim=-1)], dim=1)
    parts = [j_kin, j_obs, j_odo]
    if model.extra_one_sided is not None:
        parts.append(hook_jacobian(model.extra_one_sided, x, p))
    return torch.cat(parts, dim=1)


def two_sided_jacobian(x, p: PoseProblem, w,
                       model: EnergyModel = DEFAULT_MODEL):
    """Jacobian of two_sided_residuals, (P, 12 + 2B, 3) for the default
    model; a ``kinematics`` hook's forward term by ``hook_jacobian``."""
    if model.two_sided is not None:
        return hook_jacobian(lambda xx, pp: model.two_sided(xx, pp, w), x, p)
    sqrt_r, sqrt_q, sqrt_odom, deltat = w
    c, s = torch.cos(x[:, 2]), torch.sin(x[:, 2])
    z = torch.zeros_like(c)
    one = z + 1.0

    if model.kinematics is unicycle_step:
        # d g(x,u)/dx = I + dt*[[0,0,-v s],[0,0,v c],[0,0,0]]
        v = p.u_cur[:, 0]
        j_kinf = sqrt_r[:, None] * torch.stack([
            torch.stack([one, z, -deltat * v * s], dim=-1),
            torch.stack([z, one, deltat * v * c], dim=-1),
            torch.stack([z, z, one], dim=-1)], dim=1)
    else:
        j_kinf = sqrt_r[:, None] * hook_jacobian(
            lambda xx, pp: model.kinematics(xx, pp.u_cur, deltat), x, p)

    # forward odometry: rxy = meas - R(th)(xn - x); R = [[c,s],[-s,c]]
    dx = p.x_next[:, 0] - x[:, 0]
    dy = p.x_next[:, 1] - x[:, 1]
    dRd0 = -s * dx + c * dy
    dRd1 = -c * dx - s * dy
    j_odof = sqrt_odom * torch.stack([
        torch.stack([c, s, -dRd0], dim=-1),
        torch.stack([-s, c, -dRd1], dim=-1),
        torch.stack([z, z, one], dim=-1)], dim=1)

    parts = [j_kinf, j_odof, one_sided_jacobian(x, p, w, model)]
    if model.extra_two_sided is not None:
        parts.append(hook_jacobian(model.extra_two_sided, x, p))
    return torch.cat(parts, dim=1)


def weights(config, device=None):
    """sqrt weights (sqrt_r (3,), sqrt_q (2,), sqrt_odom (), deltat)."""
    dtype = getattr(torch, config.dtype)
    sqrt_r = torch.sqrt(torch.tensor(config.R, dtype=dtype, device=device))
    sqrt_q = torch.sqrt(torch.tensor(config.Q, dtype=dtype, device=device))
    sqrt_odom = torch.sqrt(torch.tensor(config.cte_odom, dtype=dtype,
                                        device=device))
    return sqrt_r, sqrt_q, sqrt_odom, config.deltat


def energy(residuals):
    """The energy of a residual vector: its sum of squares."""
    return torch.sum(residuals * residuals)
