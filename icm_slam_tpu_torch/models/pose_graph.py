"""SE(2) pose-graph optimization with loop closures.

Port of ``icm_slam_tpu.models.pose_graph``: a fixed edge list (i, j,
measured relative pose of j in i, per-component weights), Gauss-Newton
outer iterations, each solving H dx = -g matrix-free by block-Jacobi
preconditioned conjugate gradients.  Node 0 is gauge-fixed.

Where the JAX package takes H v from a ``jvp`` and a ``vjp`` of the
stacked residuals and the per-edge 3x3 blocks from ``jacfwd``, the port
takes both from the closed-form Jacobians of the SE(2) relative residual
in x_i and x_j (``_edge_jacobians``), formed once per Gauss-Newton step:
the same products, a dozen small ops per H v on the card.  The per-node
sums go through ``landmark_map.add_rows``, so they add in a fixed order on
the card too.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from icm_slam_tpu_torch.core.geometry import wrap_angle
from icm_slam_tpu_torch.mapping.landmark_map import add_rows


class PoseGraph(NamedTuple):
    x: torch.Tensor        # (T, 3) pose estimates
    edges_i: torch.Tensor  # (E,) int64 source node
    edges_j: torch.Tensor  # (E,) int64 target node
    rel: torch.Tensor      # (E, 3) measured j-in-i [dx, dy, dtheta]
    weight: torch.Tensor   # (E, 3) per-component residual weights (sqrt info)


def edge_residuals(x, g: PoseGraph):
    """(E, 3) weighted residuals.  r_xy = R(-th_i) (p_j - p_i) - t_ij,
    r_th = wrap(th_j - th_i - dth_ij)."""
    xi = x[g.edges_i]
    xj = x[g.edges_j]
    c, s = torch.cos(xi[:, 2]), torch.sin(xi[:, 2])
    dx = xj[:, 0] - xi[:, 0]
    dy = xj[:, 1] - xi[:, 1]
    r_x = c * dx + s * dy - g.rel[:, 0]
    r_y = -s * dx + c * dy - g.rel[:, 1]
    r_th = wrap_angle(xj[:, 2] - xi[:, 2] - g.rel[:, 2])
    return torch.stack([r_x, r_y, r_th], dim=1) * g.weight


def _edge_jacobians(x, g: PoseGraph):
    """(J_i, J_j), each (E, 3, 3): the Jacobians of ``edge_residuals`` in
    x_i and x_j.  With l = R(-th_i) (p_j - p_i): d l / d p_j = R(-th_i),
    d l / d p_i = -R(-th_i), d l / d th_i = (l_y, -l_x); the heading row
    is -1 in th_i and 1 in th_j (the wrap has unit slope)."""
    xi = x[g.edges_i]
    xj = x[g.edges_j]
    c, s = torch.cos(xi[:, 2]), torch.sin(xi[:, 2])
    dx = xj[:, 0] - xi[:, 0]
    dy = xj[:, 1] - xi[:, 1]
    lx = c * dx + s * dy
    ly = -s * dx + c * dy
    z = torch.zeros_like(c)
    one = z + 1.0
    rows_i = [[-c, -s, ly], [s, -c, -lx], [z, z, -one]]
    rows_j = [[c, s, z], [-s, c, z], [z, z, one]]
    wgt = g.weight[:, :, None]
    return tuple(torch.stack([torch.stack(r, dim=-1) for r in rows], dim=1)
                 * wgt for rows in (rows_i, rows_j))


def _gauge_mask(T, dtype, device=None):
    m = torch.ones((T, 3), dtype=dtype, device=device)
    m[0] = 0.0  # anchor node 0
    return m


def _jt(jac, g: PoseGraph, r, T):
    """J^T r for edge-space r (E, 3): each edge's blocks scattered to its
    two nodes."""
    Ji, Jj = jac
    out = torch.zeros((T, 3), dtype=r.dtype, device=r.device)
    add_rows(out, g.edges_i, (Ji * r[:, :, None]).sum(dim=1))
    return add_rows(out, g.edges_j, (Jj * r[:, :, None]).sum(dim=1))


def _hvp(x, g: PoseGraph, v, jac=None):
    """Gauss-Newton H v = J^T J v, matrix-free, gauge-fixed.  ``jac``: the
    edge Jacobians at ``x`` when the caller has them."""
    Ji, Jj = _edge_jacobians(x, g) if jac is None else jac
    mask = _gauge_mask(x.shape[0], x.dtype, x.device)
    vm = v * mask
    jv = ((Ji * vm[g.edges_i][:, None, :]).sum(dim=-1)
          + (Jj * vm[g.edges_j][:, None, :]).sum(dim=-1))
    return _jt((Ji, Jj), g, jv, x.shape[0]) * mask


def _block_jacobi(x, g: PoseGraph, jac=None):
    """(T, 3, 3) inverse diagonal blocks of H (+ 1e-6 identity); node 0's
    block is the identity (its updates are masked anyway)."""
    T = x.shape[0]
    Ji, Jj = _edge_jacobians(x, g) if jac is None else jac
    diag = torch.zeros((T, 3, 3), dtype=x.dtype, device=x.device)
    add_rows(diag, g.edges_i,
             (Ji[:, :, :, None] * Ji[:, :, None, :]).sum(dim=1))
    add_rows(diag, g.edges_j,
             (Jj[:, :, :, None] * Jj[:, :, None, :]).sum(dim=1))
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    diag = diag + 1e-6 * eye
    diag[0] = eye
    return torch.linalg.inv_ex(diag).inverse        # no error check, no sync


def apply_blocks(minv, r):
    """(..., T, 3) product of (..., T, 3, 3) blocks with (..., T, 3)
    vectors."""
    return (minv * r[..., None, :]).sum(dim=-1)


def _dot_all(a, b):
    return (a * b).sum()


def _pcg(hvp, b, prec, iters, dot=_dot_all):
    """Preconditioned CG for H dx = b, ``iters`` fixed iterations with no
    host sync; ``prec(r)`` applies the preconditioner and ``dot`` takes
    the inner products (over everything, or per world of a fleet's
    independent systems).  A step whose curvature p.Hp or r.z is not
    positive is taken as zero, as in JAX."""
    x = torch.zeros_like(b)
    r = b
    z = prec(r)
    p = z
    for _ in range(iters):
        hp = hvp(p)
        rz = dot(r, z)
        denom = dot(p, hp)
        alpha = torch.where(denom > 0, rz / denom, 0.0)
        x = x + alpha * p
        r = r - alpha * hp
        z1 = prec(r)
        beta = torch.where(rz > 0, dot(r, z1) / rz, 0.0)
        p = z1 + beta * p
        z = z1
    return x


def optimize(g: PoseGraph, gn_iters=10, cg_iters=50, damping=1e-6):
    """Gauss-Newton with PCG inner solves; a step is kept only when it
    lowers the energy.  Returns (x, residual norm after each step)."""
    x = g.x
    mask = _gauge_mask(x.shape[0], x.dtype, x.device)
    norms = []
    for _ in range(gn_iters):
        r = edge_residuals(x, g)
        jac = _edge_jacobians(x, g)
        grad = _jt(jac, g, r, x.shape[0]) * mask
        minv = _block_jacobi(x, g, jac)
        dx = _pcg(lambda v: _hvp(x, g, v, jac) + damping * v * mask, -grad,
                  lambda rr: apply_blocks(minv, rr), cg_iters)
        x_new = x + dx
        e_old = (r * r).sum()
        r_new = edge_residuals(x_new, g)
        e_new = (r_new * r_new).sum()
        x = torch.where(e_new < e_old, x_new, x)
        norms.append(torch.sqrt(torch.minimum(e_new, e_old)))
    return x, (torch.stack(norms) if norms else x.new_zeros((0,)))


def from_trajectory(x, odom_rel_noise=None, loop_pairs=None, loop_rel=None,
                    odo_weight=10.0, loop_weight=10.0) -> PoseGraph:
    """A chain + loop-closure graph on the trajectory estimate ``x``.

    Chain edges join consecutive poses with their current relative pose
    (or the given measurements ``odom_rel_noise`` (T-1, 3)); ``loop_pairs``
    (K, 2) adds closure edges measuring ``loop_rel`` (K, 3).
    """
    T = x.shape[0]
    ei = torch.arange(0, T - 1, device=x.device)
    ej = ei + 1
    rel = relative_se2(x[ei], x[ej]) if odom_rel_noise is None \
        else odom_rel_noise
    w = torch.full((T - 1, 3), odo_weight, dtype=x.dtype, device=x.device)
    if loop_pairs is not None:
        pairs = torch.as_tensor(loop_pairs, device=x.device).long()
        ei = torch.cat([ei, pairs[:, 0]])
        ej = torch.cat([ej, pairs[:, 1]])
        rel = torch.cat([rel, torch.as_tensor(loop_rel, dtype=x.dtype,
                                              device=x.device)])
        w = torch.cat([w, torch.full((pairs.shape[0], 3), loop_weight,
                                     dtype=x.dtype, device=x.device)])
    return PoseGraph(x, ei, ej, rel, w)


def relative_se2(xi, xj):
    """Relative pose of xj in xi's frame, (..., 3)."""
    c, s = torch.cos(xi[..., 2]), torch.sin(xi[..., 2])
    dx = xj[..., 0] - xi[..., 0]
    dy = xj[..., 1] - xi[..., 1]
    return torch.stack([c * dx + s * dy, -s * dx + c * dy,
                        wrap_angle(xj[..., 2] - xi[..., 2])], dim=-1)
