"""Levenberg-Marquardt minimizer for a batch of small 3-dof pose problems.

Port of ``icm_slam_tpu.solver.gauss_newton.lm_minimize`` over a leading
problem axis P (the JAX package ``vmap``s it): a fixed iteration count,
Marquardt diagonal damping, accept/reject per problem by ``torch.where``,
the cofactor 3x3 solve, and the residual of the accepted point carried to
the next iteration so each step evaluates the residuals once.
"""
from __future__ import annotations

import torch


def _solve3(A, rhs):
    """Closed-form 3x3 solve (adjugate / determinant). A (P,3,3), rhs (P,3)."""
    c00 = A[:, 1, 1] * A[:, 2, 2] - A[:, 1, 2] * A[:, 2, 1]
    c01 = A[:, 1, 2] * A[:, 2, 0] - A[:, 1, 0] * A[:, 2, 2]
    c02 = A[:, 1, 0] * A[:, 2, 1] - A[:, 1, 1] * A[:, 2, 0]
    det = A[:, 0, 0] * c00 + A[:, 0, 1] * c01 + A[:, 0, 2] * c02
    c10 = A[:, 0, 2] * A[:, 2, 1] - A[:, 0, 1] * A[:, 2, 2]
    c11 = A[:, 0, 0] * A[:, 2, 2] - A[:, 0, 2] * A[:, 2, 0]
    c12 = A[:, 0, 1] * A[:, 2, 0] - A[:, 0, 0] * A[:, 2, 1]
    c20 = A[:, 0, 1] * A[:, 1, 2] - A[:, 0, 2] * A[:, 1, 1]
    c21 = A[:, 0, 2] * A[:, 1, 0] - A[:, 0, 0] * A[:, 1, 2]
    c22 = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
    b0, b1, b2 = rhs[:, 0], rhs[:, 1], rhs[:, 2]
    return torch.stack([c00 * b0 + c10 * b1 + c20 * b2,
                        c01 * b0 + c11 * b1 + c21 * b2,
                        c02 * b0 + c12 * b1 + c22 * b2], dim=1) / det[:, None]


def lm_minimize(resid_fn, jac_fn, x0, iters=12, lam0=1e-4, lam_down=0.25,
                lam_up=8.0):
    """Minimize sum(resid_fn(x)**2) per problem over x (P, 3).

    resid_fn: (P, 3) -> (P, m); jac_fn: (P, 3) -> (P, m, 3), analytic.
    """
    eye = torch.eye(3, dtype=x0.dtype, device=x0.device)
    x = x0
    r = resid_fn(x0)
    fx = (r * r).sum(dim=1)
    lam = torch.full_like(fx, lam0)
    for _ in range(iters):
        J = jac_fn(x)
        g = (J * r[..., None]).sum(dim=1)                     # (P, 3)
        H = (J[..., :, None] * J[..., None, :]).sum(dim=1)    # (P, 3, 3)
        damp = torch.diag_embed(torch.clamp(
            torch.diagonal(H, dim1=1, dim2=2), min=1e-12))
        A = H + lam[:, None, None] * damp + 1e-12 * eye
        x_new = x + _solve3(A, -g)
        r_new = resid_fn(x_new)
        f_new = (r_new * r_new).sum(dim=1)
        better = f_new < fx
        x = torch.where(better[:, None], x_new, x)
        fx = torch.where(better, f_new, fx)
        r = torch.where(better[:, None], r_new, r)
        lam = torch.where(better, lam * lam_down, lam * lam_up)
    return x
