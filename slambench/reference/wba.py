"""Plain reference of the windowed bundle-adjustment refinement
(``sweep_mode="windowed_ba"``) on the pipeline of ``icm.py``.

Written from the semantics the benchmarked program states for it (the
JAX package's ``models/windowed_ba.py``, which this file does not
import): ICM's scan filter, frame-0 seed, batched init and map filter as
``icm.py`` has them, then N sweeps, each

* the association of every frame's beams at its current pose against the
  previous sweep's map, with the running means of the landmarks as each
  frame's matched values (as ``icm.refine_sweep`` associates);
* a pass over windows of ``ba_window`` frames from frame 1 (frame 0 is
  never free), then a pass offset by half a window; each window's poses
  solved jointly, the poses either side of it frozen, against the
  residuals it owns: its frames' beams against their matched landmarks,
  the kinematic and odometry edges into each of its frames, and the edge
  out of its last frame where a frame follows it (the trajectory's last
  pose is one-sided); ``ba_gn_iters`` Levenberg-Marquardt steps from
  lambda = 1e-4, Marquardt damping on diag(H) (clamped at 1e-9, plus
  1e-9 I), a step taken only where it lowers the window's energy, lambda
  x0.3 on a taken step and x5 on a refused one;
* each frame's new pose the average of the windows of the pass that hold
  it (at most one: a pass's windows are disjoint);
* a frame with no valid beam the mean of its two neighbours' poses;

then the map filter.

Departures from the program's route, each exact in exact arithmetic:
the full beam axis (no beam compaction: a masked beam's rows are zero);
the window's Jacobian written analytically (``Windows.jacobian``), not
by forward mode; the normal equations as dense products of the stacked
windows' Jacobians; and the damped system solved by Gaussian elimination
without pivoting (the system is symmetric positive definite) written
here in plain operations, in place of a library's LU, so that it runs
in any precision.

``dtype`` is the precision of every tensor: float32 is the
configuration's; the control of the correctness check runs this same
code in bfloat16.  TF32 is off for every float32 product.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from slambench.reference import icm
from slambench.reference.icm import remap  # noqa: F401  (the map check)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class Params(icm.Params):
    ba_window: int = 64
    ba_gn_iters: int = 4

    SUPPORTED = dict(icm.Params.SUPPORTED, sweep_mode="windowed_ba")


def _block_diag(blocks, W: int):
    """(n, W, r, 3) blocks -> (n, W, r, W, 3), block i in column block i."""
    eye = torch.eye(W, dtype=blocks.dtype, device=blocks.device)
    return blocks[:, :, :, None, :] * eye[None, :, None, :, None]


class Windows:
    """n windows of W frames each, one pass's, stacked on a leading axis.
    Per frame (n, W, ...): the beams (dist, ang), ``mask`` (valid beams of
    the window's real frames), the matched landmark values, the controls
    and odometry; per window (n, ...): the frozen poses before and after
    it, the odometry before, the control and odometry of the edge out of
    it; ``ok`` (n, W): the frame is real (not past the trajectory's end);
    ``next_ok`` (n,): a real frame follows the window."""

    def __init__(self, dist, ang, mask, matched, u, odo, x_prev, x_next,
                 odo_prev, u_last, odo_next, ok, next_ok):
        self.dist, self.ang, self.matched = dist, ang, matched
        self.m = mask.to(dist.dtype)
        self.x_prev, self.x_next = x_prev, x_next
        # the W + 1 edges: (prev -> p0), (p0 -> p1), ..., (p_{W-1} -> next)
        self.u_e = torch.cat([u, u_last[:, None]], 1)
        self.odo_a = torch.cat([odo_prev[:, None], odo], 1)
        self.odo_b = torch.cat([odo, odo_next[:, None]], 1)
        self.edge_ok = torch.cat([ok, (ok[:, -1] & next_ok)[:, None]],
                                 1).to(dist.dtype)

    def _edges(self, p):
        xa = torch.cat([self.x_prev[:, None], p], 1)          # (n, W+1, 3)
        xb = torch.cat([p, self.x_next[:, None]], 1)
        return xa, xb

    def residual(self, p, w: icm.Weights):
        """The windows' residuals (n, 2 W B + 6 (W + 1)) at poses p
        (n, W, 3): the beams' (x, y) rows frame by frame, then the six
        rows (kinematic, odometry) of each edge."""
        n, W = p.shape[:2]
        a = self.ang + p[..., 2:3] - math.pi / 2.0
        pts = p[..., None, :2] + self.dist[..., None] * torch.stack(
            [torch.cos(a), torch.sin(a)], -1)
        r_obs = (pts - self.matched) * w.q * self.m[..., None]
        xa, xb = (e.reshape(-1, 3) for e in self._edges(p))
        r_kin = w.r * icm._head(xb - icm.kinematics(
            xa, self.u_e.reshape(-1, 2), w.dt))
        r_odo = w.odo * icm._odo_res(xa[:, 2], self.odo_a.reshape(-1, 3),
                                     self.odo_b.reshape(-1, 3),
                                     xb[:, :2] - xa[:, :2],
                                     xb[:, 2] - xa[:, 2])
        r_chain = torch.cat([r_kin, r_odo], 1).reshape(n, W + 1, 6) \
            * self.edge_ok[..., None]
        return torch.cat([r_obs.reshape(n, -1), r_chain.reshape(n, -1)], 1)

    def jacobian(self, p, w: icm.Weights):
        """d residual / d p, (n, rows, 3 W), written out: a beam's rows
        depend on its frame's pose alone; an edge's on the pose it leaves
        (a) and the pose it reaches (b), where those are free."""
        n, W = p.shape[:2]
        B = self.dist.shape[-1]
        a = self.ang + p[..., 2:3] - math.pi / 2.0
        z, one = torch.zeros_like(self.dist), torch.ones_like(self.dist)
        jx = torch.stack([one, z, -self.dist * torch.sin(a)], -1) \
            * (w.q[0] * self.m)[..., None]
        jy = torch.stack([z, one, self.dist * torch.cos(a)], -1) \
            * (w.q[1] * self.m)[..., None]
        j_obs = _block_diag(torch.stack([jx, jy], 3).reshape(n, W, 2 * B, 3),
                            W).reshape(n, 2 * W * B, 3 * W)

        xa, xb = self._edges(p)
        c, s = torch.cos(xa[..., 2]), torch.sin(xa[..., 2])
        v = self.u_e[..., 0]
        dx, dy = xb[..., 0] - xa[..., 0], xb[..., 1] - xa[..., 1]
        zz = torch.zeros_like(c)
        r0, r1, r2 = w.r[0], w.r[1], w.r[2]
        # by the pose the edge leaves ...
        ja = torch.stack([
            torch.stack([zz - r0, zz, r0 * w.dt * v * s], -1),
            torch.stack([zz, zz - r1, -r1 * w.dt * v * c], -1),
            torch.stack([zz, zz, zz - r2], -1),
            w.odo * torch.stack([c, s, s * dx - c * dy], -1),
            w.odo * torch.stack([-s, c, c * dx + s * dy], -1),
            w.odo * torch.stack([zz, zz, zz + 1.0], -1)], 2)  # (n, W+1, 6, 3)
        # ... and by the pose it reaches
        jb = torch.stack([
            torch.stack([zz + r0, zz, zz], -1),
            torch.stack([zz, zz + r1, zz], -1),
            torch.stack([zz, zz, zz + r2], -1),
            w.odo * torch.stack([-c, -s, zz], -1),
            w.odo * torch.stack([s, -c, zz], -1),
            w.odo * torch.stack([zz, zz, zz - 1.0], -1)], 2)
        ok = self.edge_ok[..., None, None]
        ja, jb = ja * ok, jb * ok
        edge = torch.zeros((n, 1, 6, W, 3), dtype=p.dtype, device=p.device)
        # edge e reaches pose e (e < W) and leaves pose e - 1 (e > 0)
        j_chain = (torch.cat([_block_diag(jb[:, :W], W), edge], 1)
                   + torch.cat([edge, _block_diag(ja[:, 1:], W)], 1))
        return torch.cat([j_obs, j_chain.reshape(n, 6 * (W + 1), 3 * W)], 1)


def solve(A, b):
    """A (n, k, k) symmetric positive definite, b (n, k): A^-1 b by
    Gaussian elimination without pivoting and back substitution, in A's
    precision."""
    A, b = A.clone(), b.clone()
    k = A.shape[-1]
    for i in range(k - 1):
        f = A[:, i + 1:, i] / A[:, i, i:i + 1]
        A[:, i + 1:, i:] -= f[..., None] * A[:, i:i + 1, i:]
        b[:, i + 1:] -= f * b[:, i:i + 1]
    x = torch.zeros_like(b)
    for i in range(k - 1, -1, -1):
        x[:, i] = (b[:, i] - (A[:, i, i + 1:] * x[:, i + 1:]).sum(1)) \
            / A[:, i, i]
    return x


def lm_windows(win: Windows, p, w: icm.Weights, iters: int):
    """``iters`` LM steps on every window's energy; returns the poses
    (n, W, 3)."""
    n, W = p.shape[:2]
    eye = torch.eye(3 * W, dtype=p.dtype, device=p.device)
    r = win.residual(p, w)
    f = (r * r).sum(1)
    lam = torch.full_like(f, 1e-4)
    for _ in range(iters):
        J = win.jacobian(p, w)
        Jt = J.transpose(1, 2)
        g = torch.bmm(Jt, r[..., None])[..., 0]
        H = torch.bmm(Jt, J)
        damp = torch.diag_embed(torch.clamp(torch.diagonal(H, dim1=1, dim2=2),
                                            min=1e-9))
        step = solve(H + lam[:, None, None] * damp + 1e-9 * eye, -g)
        new = p + step.reshape(n, W, 3)
        r_new = win.residual(new, w)
        f_new = (r_new * r_new).sum(1)
        ok = f_new < f
        p = torch.where(ok[:, None, None], new, p)
        r = torch.where(ok[:, None], r_new, r)
        f = torch.where(ok, f_new, f)
        lam = torch.where(ok, lam * 0.3, lam * 5.0)
    return p


def solve_pass(dist, mask, ang, matched, odom, u, x, offset: int, p: Params,
               w: icm.Weights):
    """One pass: the windows of ``ba_window`` frames from frame
    offset + 1, each solved with the poses around it frozen; returns the
    poses (T, 3)."""
    T = x.shape[0]
    W = p.ba_window
    dev = x.device
    n = max(1, -(-(T - offset - 1) // W))
    starts = offset + 1 + torch.arange(n, device=dev) * W
    idx = starts[:, None] + torch.arange(W, device=dev)
    ok = idx <= T - 1
    ic = torch.clamp(idx, max=T - 1)
    prev = torch.clamp(starts - 1, 0, T - 1)
    after = torch.clamp(starts + W, max=T - 1)
    win = Windows(dist[ic], ang[ic], mask[ic] & ok[..., None], matched[ic],
                  u[ic], odom[ic], x[prev], x[after], odom[prev],
                  u[torch.clamp(starts + W - 1, max=T - 1)], odom[after], ok,
                  starts + W <= T - 1)
    poses = lm_windows(win, x[ic], w, p.ba_gn_iters)
    x = x.clone()
    x[ic[ok]] = poses[ok]
    return x


def associate(dist, mask, ang, old: icm.Map, x, p: Params):
    """Every frame's beams at its pose against the frozen map ``old`` (the
    nearest live landmark by squared distance; beyond dist_thr a frame's
    far beams open one new landmark), as ``icm.refine_sweep`` associates.
    Returns (the sweep's map, matched (T, B, 2): each beam's landmark
    averaged over the frames up to its own)."""
    T, B = dist.shape
    L = p.L
    pts = icm.to_world(x, dist, ang.expand(T, B))
    K = old.nact
    if K:
        dx = pts[..., 0:1] - old.pos[:K, 0]
        dy = pts[..., 1:2] - old.pos[:K, 1]
        min2, lab = (dx * dx + dy * dy).min(-1)
        far = (min2 > p.dist_thr * p.dist_thr) & mask
    else:
        lab = torch.zeros((T, B), dtype=torch.long, device=dist.device)
        far = mask.clone()
    lab = torch.where(mask, lab, L)
    has_far = far.any(1)
    new_id = K + torch.cumsum(has_far.long(), 0) - 1
    lab = torch.where(far, new_id[:, None], lab)
    sx, sy, cn = icm._sums(pts, lab, L)
    csx, csy, ccn = (torch.cumsum(a, 0) for a in (sx, sy, cn))
    lc = torch.clamp(lab, 0, L - 1)
    den = torch.clamp(ccn, min=1.0)
    matched = torch.stack([torch.gather(csx / den, 1, lc),
                           torch.gather(csy / den, 1, lc)], -1)
    tot = torch.clamp(ccn[-1], min=1.0)
    new = icm.Map(torch.stack([csx[-1] / tot, csy[-1] / tot], -1)
                  * (ccn[-1] > 0)[:, None], ccn[-1], K + int(has_far.sum()))
    return new, matched


def sweep(dist, mask, ang, odom, u, old: icm.Map, x, p: Params,
          w: icm.Weights):
    """One windowed-BA sweep: the association, the two offset passes, the
    empty frames' neighbour mean.  Returns (the sweep's map, x)."""
    T, B = dist.shape
    new, matched = associate(dist, mask, ang, old, x, p)
    angb = ang.expand(T, B)
    for offset in (0, p.ba_window // 2):
        x = solve_pass(dist, mask, angb, matched, odom, u, x, offset, p, w)
    t = torch.arange(T, device=x.device)
    avg = (x[torch.clamp(t - 1, min=0)] + x[torch.clamp(t + 1, max=T - 1)]) / 2
    empty = ~mask.any(1) & (t >= 1)
    return new, torch.where(empty[:, None], avg, x)


def refine(dist, mask, ang, odom, u, m: icm.Map, x, p: Params,
           w: icm.Weights, n_iters=None):
    """``N`` windowed-BA sweeps, each followed by the map filter."""
    for _ in range(p.N if n_iters is None else n_iters):
        new, x = sweep(dist, mask, ang, odom, u, m, x, p, w)
        m = icm.filter_map(new, p.cota, p.dist_thr)
    return m, x


def offline(world, p: Params, device, dtype=torch.float32) -> icm.Result:
    """What ``run(world)`` computes: the scan filter, the frame-0 seed at
    the world's x0, the batched init and the map filter, then N
    windowed-BA sweeps."""
    w = icm.Weights(p, dtype, device)
    dist, mask, ang, odom, u = icm._inputs(world, p, dtype, device)
    x0 = torch.as_tensor(np.asarray(world.x0), device=device).to(dtype)
    m0 = icm.seed(dist[0], mask[0], ang, x0, p)
    m, x_init, _ = icm.batched_init(dist, mask, ang, odom, u, x0, m0, p, w)
    m = icm.filter_map(m, p.cota, p.dist_thr)
    m, x = refine(dist, mask, ang, odom, u, m, x_init, p, w)
    return icm._result(m, x_init, x)


def refine_from(world, x_init, map_pos, map_counts, p: Params, device,
                dtype=torch.float32):
    """The poses (T, 3) of the N windowed-BA sweeps (each followed by the
    map filter) of ``offline``, run from another run's initial poses
    ``x_init`` (T, 3), against that run's final map (``map_pos`` (K, 2),
    ``map_counts`` (K,)) as the first sweep's map: that run's refinement
    redone from its own start, so with none of the init's chaos between
    the two (the answer does not carry its post-init map; its final map
    is the one it holds)."""
    dist, mask, ang, odom, u = icm._inputs(world, p, dtype, device)
    K = len(map_pos)
    pos = torch.zeros((p.L, 2), dtype=dtype, device=device)
    counts = torch.zeros((p.L,), dtype=dtype, device=device)
    pos[:K] = torch.as_tensor(np.asarray(map_pos), device=device).to(dtype)
    counts[:K] = torch.as_tensor(np.asarray(map_counts),
                                 device=device).to(dtype)
    xs = torch.as_tensor(np.asarray(x_init), device=device).to(dtype)
    _, xs = refine(dist, mask, ang, odom, u, icm.Map(pos, counts, K), xs, p,
                   icm.Weights(p, dtype, device))
    return xs.float().cpu().numpy()
