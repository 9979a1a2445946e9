"""SE(2) / sensor geometry primitives on tensors with any leading axes.

Port of ``icm_slam_tpu.core.geometry``; the reference's -pi/2 beam-frame
offset is kept (beam index 0 points at -90 degrees in the body frame).
"""
from __future__ import annotations

import math

import torch


def wrap_angle(a):
    """Wrap angle(s) to (-pi, pi] (the reference's entrepi).

    ``torch.remainder`` floors like ``jnp.mod``: the result takes the sign
    of the divisor.
    """
    a = torch.remainder(a, 2.0 * math.pi)
    return torch.where(a > math.pi, a - 2.0 * math.pi, a)


def rot2(theta):
    """Reference 2D rotation [[c, s], [-s, c]] for (...,) theta -> (..., 2, 2)."""
    c, s = torch.cos(theta), torch.sin(theta)
    row0 = torch.stack([c, s], dim=-1)
    row1 = torch.stack([-s, c], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def unicycle_step(x, u, deltat):
    """Forward unicycle kinematics g(x, u). x: (..., 3); u: (..., 2)."""
    v = u[..., 0]
    w = u[..., 1]
    th = x[..., 2]
    dx = torch.stack([v * torch.cos(th), v * torch.sin(th), w], dim=-1)
    return x + deltat * dx


def beam_angles(n_beams, step_deg=1.0, start_deg=0.0, dtype=torch.float32,
                device=None):
    """Per-beam scan-frame angles in radians (index * step)."""
    idx = torch.arange(n_beams, dtype=dtype, device=device)
    return (start_deg + idx * step_deg) * math.pi / 180.0


def beams_to_world(pose, dist, ang):
    """World-frame points of beams (dist, ang) seen from ``pose``.

    pose: (..., 3); dist, ang: (..., B) (``ang`` may be (B,) and broadcast).
    Returns (..., B, 2).
    """
    a = ang + (pose[..., 2:3] - math.pi / 2.0)
    offs = dist[..., None] * torch.stack([torch.cos(a), torch.sin(a)], dim=-1)
    return pose[..., None, :2] + offs
