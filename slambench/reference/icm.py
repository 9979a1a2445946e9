"""Plain reference of the ICM-SLAM pipeline that the benchmark's cells drive.

Written from the semantics of the reference ICM_ROS.py / ICM_SLAM.py
pipeline as the benchmarked program states them (scan filter, frame-0
clustering, the chunked-Picard batched init, the causal frame-by-frame
init, the map filter, the batched red-black refinement sweep), in plain
PyTorch and NumPy for one world at a time.  It imports nothing of the
program and takes nothing the program made: it starts from the raw scans,
odometry and controls.

It is deliberately the slow, straightforward form: the full beam axis and
the full landmark table (no beam compaction, no association caps, no
custom kernels, no CUDA graphs), the relabel walk of the map filter as a
host loop, the SE(2) chain as a loop over frames, and the causal init as a
loop over frames on its own device.  Those shortcuts of the program are
exact, so the two agree to float rounding; the T=1833 worlds are
rounding-sensitive (a knife-edge association or a count at the prune
threshold can flip), which is why the comparison (``compare.py``) takes
both a widest and a median gap.

``dtype`` is the precision of every tensor: float32 is the configuration's;
the control of the correctness check runs this same code in bfloat16.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

_FRAME_BLOCK = 256      # frames per (frames, B, B) block of the scan filter


@dataclasses.dataclass(frozen=True)
class Params:
    """The solver parameters the reference reads (names of config_ros.yaml
    and of the configuration files)."""
    N: int = 30
    deltat: float = 0.1
    L: int = 1024
    Q: tuple = (1.0, 1.0)
    R: tuple = (1.0, 1.0, 1.0)
    cte_odom: float = 1.0
    cota: float = 300.0
    dist_thr: float = 1.0
    rango_laser_max: float = 10.0
    radio: float = 0.137
    beam0_deg: float = 0.0
    beam_step_deg: float = 1.0
    init_rounds: int = 2
    init_chunk_len: int = 32
    init_gn_iters: int = 0          # 0: pose_gn_iters
    pose_gn_iters: int = 8
    pose_passes: int = 2

    # what the reference implements; a configuration asking for anything
    # else is refused
    SUPPORTED = {"sweep_mode": "batched", "init_mode": "auto",
                 "pose_update": "redblack", "replicate_new_obs_quirk": True,
                 "init_final_assoc": True, "init_merge_cap": 0,
                 "dtype": "float32", "model": None}

    @classmethod
    def from_solver(cls, solver: dict, supported=None) -> "Params":
        """The parameters of a configuration's ``solver`` over ``cls``'s
        fields, refused where it asks for a path that ``cls.SUPPORTED``
        (or ``supported``) does not list.  A reference of another path (a
        file of its own) subclasses ``Params`` with its own fields and
        ``SUPPORTED``."""
        for k, v in (cls.SUPPORTED if supported is None
                     else supported).items():
            if solver.get(k, v) != v:
                raise ValueError(f"the reference implements {k}={v!r}, "
                                 f"not {solver[k]!r}")
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in solver.items() if k in known}
        return cls(**kw)

    def replace_n(self, n: int) -> "Params":
        return dataclasses.replace(self, N=n)


@dataclasses.dataclass
class Result:
    x_init: np.ndarray      # (T, 3)
    x: np.ndarray           # (T, 3)
    map_pos: np.ndarray     # (K, 2) live landmarks
    map_counts: np.ndarray  # (K,)


class Map:
    """The landmark table: pos (L, 2), counts (L,), nact a host int."""

    def __init__(self, pos, counts, nact: int):
        self.pos, self.counts, self.nact = pos, counts, int(nact)


# --------------------------------------------------------------------------
# geometry and the scan filter
# --------------------------------------------------------------------------

def wrap(a):
    a = torch.remainder(a, 2.0 * math.pi)
    return torch.where(a > math.pi, a - 2.0 * math.pi, a)


def kinematics(x, u, dt):
    th = x[..., 2]
    return x + dt * torch.stack([u[..., 0] * torch.cos(th),
                                 u[..., 0] * torch.sin(th), u[..., 1]], -1)


def to_world(pose, dist, ang):
    """Beams (dist, ang) seen from ``pose`` (..., 3) -> (..., B, 2); beam
    0 points at -90 degrees in the body frame."""
    a = ang + (pose[..., 2:3] - math.pi / 2.0)
    return pose[..., None, :2] + dist[..., None] * torch.stack(
        [torch.cos(a), torch.sin(a)], -1)


def angles(n, p: Params, dtype, device):
    return ((p.beam0_deg + torch.arange(n, dtype=dtype, device=device)
             * p.beam_step_deg) * math.pi / 180.0)


def filter_scans(scans, p: Params, dtype, device):
    """Raw ranges (T, B) -> (median-filtered ranges, informative mask):
    NaN to max range, the trunk radius added and clipped, a window-3
    median with zero edges, the range gate, and the isolation prune (a
    beam needs a valid neighbour point within dist_thr; coincident points
    and the point itself count as 100 m away; a frame needs two beams)."""
    r = torch.as_tensor(np.asarray(scans), device=device).to(dtype)
    r = torch.clamp(torch.nan_to_num(r, nan=p.rango_laser_max) + p.radio,
                    max=p.rango_laser_max)
    z = torch.zeros_like(r[:, :1])
    prev = torch.cat([z, r[:, :-1]], 1)
    nxt = torch.cat([r[:, 1:], z], 1)
    rm = torch.minimum(torch.maximum(r, torch.minimum(prev, nxt)),
                       torch.maximum(prev, nxt))
    B = r.shape[1]
    ang = angles(B, p, dtype, device)
    valid = rm < p.rango_laser_max
    eye = torch.eye(B, dtype=torch.bool, device=device)
    masks = []
    for i in range(0, r.shape[0], _FRAME_BLOCK):
        rb, vb = rm[i:i + _FRAME_BLOCK], valid[i:i + _FRAME_BLOCK]
        pts = rb[..., None] * torch.stack([torch.cos(ang), torch.sin(ang)],
                                          -1)
        diff = pts[:, :, None] - pts[:, None]
        d = torch.sqrt((diff * diff).sum(-1))
        d = torch.where((d < 1e-9) | eye, torch.full_like(d, 100.0), d)
        d = torch.where(vb[:, :, None] & vb[:, None], d,
                        torch.full_like(d, float("inf")))
        near = d.min(2).values
        masks.append(vb & (near <= p.dist_thr)
                     & (vb.sum(1, keepdim=True) > 1))
    return rm, torch.cat(masks), ang


# --------------------------------------------------------------------------
# the pose costs and the Levenberg-Marquardt solve
# --------------------------------------------------------------------------

class Weights:
    """Square roots of the cost weights, and the sampling period."""

    def __init__(self, p: Params, dtype, device):
        def t(v):
            return torch.sqrt(torch.tensor(v, dtype=dtype, device=device))
        self.r, self.q, self.odo, self.dt = t(p.R), t(p.Q), t(p.cte_odom), \
            p.deltat


def _odo_res(th_anchor, odo0, odo1, dxy, dth):
    c0, s0 = torch.cos(odo0[:, 2]), torch.sin(odo0[:, 2])
    ca, sa = torch.cos(th_anchor), torch.sin(th_anchor)
    d0, d1 = odo1[:, 0] - odo0[:, 0], odo1[:, 1] - odo0[:, 1]
    rx = (c0 * d0 + s0 * d1) - (ca * dxy[:, 0] + sa * dxy[:, 1])
    ry = (-s0 * d0 + c0 * d1) - (-sa * dxy[:, 0] + ca * dxy[:, 1])
    return torch.stack([rx, ry, wrap(odo1[:, 2] - odo0[:, 2] - dth)], -1)


def _head(g):
    return torch.cat([g[:, :2], wrap(g[:, 2:3])], 1)


class Problems:
    """P pose problems.  One-sided: the kinematic term from x_prev, the
    observations of the frame's beams against their matched landmarks,
    the odometry term from x_prev.  Two-sided adds, first, the forward
    kinematic and odometry terms towards x_next; ``fold`` zeroes those six
    rows (the trajectory's last frame)."""

    def __init__(self, dist, ang, mask, matched, x_prev, u_prev, odo_prev,
                 odo_cur, x_next=None, u_cur=None, odo_next=None, fold=None):
        self.dist, self.ang, self.mask, self.matched = dist, ang, mask, matched
        self.x_prev, self.u_prev = x_prev, u_prev
        self.odo_prev, self.odo_cur = odo_prev, odo_cur
        self.x_next, self.u_cur, self.odo_next = x_next, u_cur, odo_next
        self.fold = fold
        self.m = mask.to(dist.dtype)

    @property
    def two_sided(self):
        return self.x_next is not None

    def residual(self, x, w: Weights):
        P = x.shape[0]
        a = self.ang + x[:, 2:3] - math.pi / 2.0
        pts = x[:, None, :2] + self.dist[..., None] * torch.stack(
            [torch.cos(a), torch.sin(a)], -1)
        r_obs = ((pts - self.matched) * w.q * self.m[..., None]).reshape(P, -1)
        r_kin = w.r * _head(x - kinematics(self.x_prev, self.u_prev, w.dt))
        r_odo = w.odo * _odo_res(self.x_prev[:, 2], self.odo_prev,
                                 self.odo_cur, x[:, :2] - self.x_prev[:, :2],
                                 x[:, 2] - self.x_prev[:, 2])
        parts = [r_kin, r_obs, r_odo]
        if self.two_sided:
            r_kf = w.r * _head(kinematics(x, self.u_cur, w.dt) - self.x_next)
            r_of = w.odo * _odo_res(x[:, 2], self.odo_cur, self.odo_next,
                                    self.x_next[:, :2] - x[:, :2],
                                    self.x_next[:, 2] - x[:, 2])
            fwd = torch.cat([r_kf, r_of], 1)
            if self.fold is not None:
                fwd = torch.where(self.fold[:, None], 0.0, fwd)
            parts = [fwd] + parts
        return torch.cat(parts, 1)

    def jacobian(self, x, w: Weights):
        P, B = self.dist.shape
        a = self.ang + x[:, 2:3] - math.pi / 2.0
        z, one = torch.zeros_like(self.dist), torch.ones_like(self.dist)
        jx = torch.stack([one, z, -self.dist * torch.sin(a)], -1) * (
            w.q[0] * self.m)[..., None]
        jy = torch.stack([z, one, self.dist * torch.cos(a)], -1) * (
            w.q[1] * self.m)[..., None]
        j_obs = torch.stack([jx, jy], 2).reshape(P, 2 * B, 3)
        j_kin = torch.diag(w.r).expand(P, 3, 3)
        c, s = torch.cos(self.x_prev[:, 2]), torch.sin(self.x_prev[:, 2])
        zp = torch.zeros_like(c)
        j_odo = w.odo * torch.stack([torch.stack([-c, -s, zp], -1),
                                     torch.stack([s, -c, zp], -1),
                                     torch.stack([zp, zp, zp - 1.0], -1)], 1)
        parts = [j_kin, j_obs, j_odo]
        if self.two_sided:
            c, s = torch.cos(x[:, 2]), torch.sin(x[:, 2])
            v = self.u_cur[:, 0]
            dt = w.dt
            j_kf = w.r[:, None] * torch.stack([
                torch.stack([zp + 1.0, zp, -dt * v * s], -1),
                torch.stack([zp, zp + 1.0, dt * v * c], -1),
                torch.stack([zp, zp, zp + 1.0], -1)], 1)
            dx = self.x_next[:, 0] - x[:, 0]
            dy = self.x_next[:, 1] - x[:, 1]
            j_of = w.odo * torch.stack([
                torch.stack([c, s, s * dx - c * dy], -1),
                torch.stack([-s, c, c * dx + s * dy], -1),
                torch.stack([zp, zp, zp + 1.0], -1)], 1)
            fwd = torch.cat([j_kf, j_of], 1)
            if self.fold is not None:
                fwd = torch.where(self.fold[:, None, None], 0.0, fwd)
            parts = [fwd] + parts
        return torch.cat(parts, 1)


def _solve3(A, b):
    """3x3 solve by the adjugate."""
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
    return torch.stack([c00 * b[:, 0] + c10 * b[:, 1] + c20 * b[:, 2],
                        c01 * b[:, 0] + c11 * b[:, 1] + c21 * b[:, 2],
                        c02 * b[:, 0] + c12 * b[:, 1] + c22 * b[:, 2]],
                       1) / det[:, None]


def lm(prob: Problems, x0, w: Weights, iters: int):
    """Levenberg-Marquardt on sum(r^2) per problem: a fixed number of
    steps, Marquardt damping (lambda from 1e-4, x0.25 on a better point,
    x8 on a worse), a step taken only where it lowers the energy."""
    eye = torch.eye(3, dtype=x0.dtype, device=x0.device)
    x, r = x0, prob.residual(x0, w)
    f = (r * r).sum(1)
    lam = torch.full_like(f, 1e-4)
    for _ in range(iters):
        J = prob.jacobian(x, w)
        g = (J * r[..., None]).sum(1)
        H = (J[..., :, None] * J[..., None, :]).sum(1)
        damp = torch.diag_embed(torch.clamp(torch.diagonal(H, dim1=1, dim2=2),
                                            min=1e-12))
        x_new = x + _solve3(H + lam[:, None, None] * damp + 1e-12 * eye, -g)
        r_new = prob.residual(x_new, w)
        f_new = (r_new * r_new).sum(1)
        ok = f_new < f
        x = torch.where(ok[:, None], x_new, x)
        r = torch.where(ok[:, None], r_new, r)
        f = torch.where(ok, f_new, f)
        lam = torch.where(ok, lam * 0.25, lam * 8.0)
    return x


# --------------------------------------------------------------------------
# the landmark table
# --------------------------------------------------------------------------

def seed(dist0, mask0, ang, x0, p: Params) -> Map:
    """Frame 0's points clustered on the host (single linkage, scipy's
    'inconsistent' criterion at dist_thr); each cluster's mean seeds a
    landmark."""
    from scipy.cluster.hierarchy import fcluster, linkage
    from scipy.spatial.distance import pdist
    dtype, dev = dist0.dtype, dist0.device
    pos = torch.zeros((p.L, 2), dtype=dtype, device=dev)
    counts = torch.zeros((p.L,), dtype=dtype, device=dev)
    pts = to_world(x0, dist0, ang).float().cpu().numpy()[
        mask0.cpu().numpy()]
    if pts.shape[0] == 0:
        return Map(pos, counts, 0)
    lab = (np.zeros(pts.shape[0], np.int64) if pts.shape[0] == 1 else
           fcluster(linkage(pdist(pts)), p.dist_thr,
                    criterion="inconsistent").astype(np.int64) - 1)
    for k in range(int(lab.max()) + 1):
        sel = pts[lab == k]
        if sel.shape[0]:
            pos[k] = torch.as_tensor(sel, device=dev).to(dtype).sum(0) / \
                sel.shape[0]
            counts[k] = sel.shape[0]
    return Map(pos, counts, int(lab.max()) + 1)


def _sums(pts, lab, L):
    """Per-frame sums over L + 1 bins (bin L discards): pts (F, B, 2),
    lab (F, B) -> sx, sy, cnt (F, L)."""
    F = lab.shape[0]
    idx = torch.clamp(lab, max=L).long() + torch.arange(
        F, device=lab.device)[:, None] * (L + 1)
    wgt = (lab < L).to(pts.dtype)
    vals = torch.stack([pts[..., 0] * wgt, pts[..., 1] * wgt, wgt], -1)
    out = torch.zeros((F * (L + 1), 3), dtype=pts.dtype, device=pts.device)
    out.index_put_((idx.reshape(-1),), vals.reshape(-1, 3), accumulate=True)
    out = out.view(F, L + 1, 3)[:, :L]
    return out[..., 0], out[..., 1], out[..., 2]


def filter_map(m: Map, cota: float, dist_thr: float) -> Map:
    """Prune landmarks seen fewer than ``cota`` times, then merge each kept
    landmark into its nearest neighbour closer than dist_thr by the
    reference's walk over the rows in order (every row labelled as the
    neighbour's label takes the row's label), and fuse each label's rows
    by count-weighted means."""
    L = m.pos.shape[0]
    dtype, dev = m.pos.dtype, m.pos.device
    keep = ((torch.arange(L, device=dev) < m.nact)
            & (m.counts >= cota)).cpu().numpy()
    rows = np.flatnonzero(keep)
    n = rows.size
    pos = torch.zeros((L, 2), dtype=dtype, device=dev)
    counts = torch.zeros((L,), dtype=dtype, device=dev)
    if n == 0:
        return Map(pos, counts, 0)
    rows_t = torch.as_tensor(rows, device=dev)
    kp, kc = m.pos[rows_t], m.counts[rows_t]
    diff = kp[:, None] - kp[None]
    d = torch.sqrt((diff * diff).sum(-1))
    dmax = d.max()
    d = torch.where((d < 1e-9) | torch.eye(n, dtype=torch.bool, device=dev),
                    dmax, d)
    nnd, nn = d.min(1)
    close = (nnd < dist_thr).cpu().numpy()
    nn = nn.cpu().numpy()
    lab = np.arange(n)
    for i in range(n):
        if close[i]:
            tgt, mine = lab[nn[i]], lab[i]
            lab[lab == tgt] = mine
    _, lab = np.unique(lab, return_inverse=True)
    k = int(lab.max()) + 1
    lab_t = torch.as_tensor(lab, device=dev)
    sums = torch.zeros((k, 2), dtype=dtype, device=dev).index_put_(
        (lab_t,), kp * kc[:, None], accumulate=True)
    cnts = torch.zeros((k,), dtype=dtype, device=dev).index_put_(
        (lab_t,), kc, accumulate=True)
    pos[:k] = torch.where((cnts > 0)[:, None],
                          sums / torch.clamp(cnts, min=1.0)[:, None], 0.0)
    counts[:k] = cnts
    return Map(pos, counts, k)


# --------------------------------------------------------------------------
# iteration 0: the batched (chunked-Picard) init and the causal init
# --------------------------------------------------------------------------

def _chain(x_last, rel, x_stale, anchor):
    """Compose a chunk's poses from ``x_last``: frame i keeps ``rel[i]``
    where ``anchor[i]`` (an absolute pose), else takes the previous new
    pose composed with its pose relative to the stale predecessor
    ``x_stale[i]`` (None: ``rel`` is already relative)."""
    if x_stale is not None:
        d = rel - x_stale
        c, s = torch.cos(x_stale[:, 2]), torch.sin(x_stale[:, 2])
        inc = torch.stack([c * d[:, 0] + s * d[:, 1],
                           -s * d[:, 0] + c * d[:, 1], d[:, 2]], 1)
    else:
        inc = rel
    anchor = anchor.cpu().numpy()
    out, prev = [], x_last
    for i in range(rel.shape[0]):
        if anchor[i]:
            prev = rel[i]
        else:
            c, s = torch.cos(prev[2]), torch.sin(prev[2])
            prev = torch.stack([prev[0] + c * inc[i, 0] - s * inc[i, 1],
                                prev[1] + s * inc[i, 0] + c * inc[i, 1],
                                prev[2] + inc[i, 2]])
        out.append(prev)
    return torch.stack(out)


def batched_init(dist, mask, ang, odom, u, x0, seed_map: Map, p: Params,
                 w: Weights):
    """ICM iteration 0 in chunks of ``init_chunk_len`` frames, each a few
    Picard rounds: associate every frame of the chunk at its kinematic
    prediction against the table as that frame sees it (the carried table
    plus the chunk's earlier frames of the previous round), every far
    frame opening one new landmark; solve every frame's one-sided pose;
    re-chain the chunk.  A last association builds the table from the
    converged poses.  Returns (the table with its duplicates merged, the
    poses (T, 3), the raw allocated count)."""
    T, B = dist.shape
    L = p.L
    dtype, dev = dist.dtype, dist.device
    sx = seed_map.pos[:, 0] * seed_map.counts
    sy = seed_map.pos[:, 1] * seed_map.counts
    cnt = seed_map.counts.clone()
    nact = seed_map.nact
    x_last = x0
    poses = [x0[None]]
    C = max(2, int(p.init_chunk_len))
    thr2 = p.dist_thr * p.dist_thr
    angb = ang.expand(B)
    for t0 in range(1, T, C):
        f = slice(t0, min(t0 + C, T))
        fp = slice(t0 - 1, min(t0 + C, T) - 1)
        dist_c, mask_c, odo_c = dist[f], mask[f], odom[f]
        odo_p, u_p = odom[fp], u[fp]
        n = dist_c.shape[0]
        ang_c = angb.expand(n, B)
        empty = ~mask_c.any(1)

        def assoc(pts, pts_prev, lab_prev):
            psx, psy, pcn = _sums(pts_prev, lab_prev, L)
            csx = sx + torch.cumsum(psx, 0) - psx
            csy = sy + torch.cumsum(psy, 0) - psy
            ccn = cnt + torch.cumsum(pcn, 0) - pcn
            ex = csx / torch.clamp(ccn, min=1.0)
            ey = csy / torch.clamp(ccn, min=1.0)
            dx = pts[..., 0:1] - ex[:, None]
            dy = pts[..., 1:2] - ey[:, None]
            d2 = torch.where((ccn > 0)[:, None], dx * dx + dy * dy,
                             float("inf"))
            min2, lab = d2.min(-1)
            far = (min2 > thr2) & mask_c
            lab = torch.where(mask_c, lab, L)
            has_far = far.any(1)
            new_id = nact + torch.cumsum(has_far.long(), 0) - 1
            lab = torch.where(far, torch.clamp(new_id[:, None], max=L), lab)
            osx, osy, ocn = _sums(pts, lab, L)
            lc = torch.clamp(lab, 0, L - 1)
            den = torch.clamp(ccn + ocn, min=1.0)
            matched = torch.stack([torch.gather((csx + osx) / den, 1, lc),
                                   torch.gather((csy + osy) / den, 1, lc)],
                                  -1)
            oc = torch.clamp(torch.gather(ocn, 1, lc), min=1.0)
            own = torch.stack([torch.gather(osx, 1, lc) / oc,
                               torch.gather(osy, 1, lc) / oc], -1)
            matched = torch.where(far[..., None], own, matched)
            return (lab, int(has_far.sum()), matched,
                    (sx + osx.sum(0), sy + osy.sum(0), cnt + ocn.sum(0)))

        c0, s0 = torch.cos(odo_p[:, 2]), torch.sin(odo_p[:, 2])
        dw = odo_c - odo_p
        rel0 = torch.stack([c0 * dw[:, 0] + s0 * dw[:, 1],
                            -s0 * dw[:, 0] + c0 * dw[:, 1], dw[:, 2]], 1)
        x = _chain(x_last, rel0, None, torch.zeros(n, dtype=torch.bool))
        lab = torch.full((n, B), L, dtype=torch.long, device=dev)
        pts_prev = torch.zeros((n, B, 2), dtype=dtype, device=dev)
        for _ in range(max(1, int(p.init_rounds))):
            x_prev = torch.cat([x_last[None], x[:-1]])
            xp = kinematics(x_prev, u_p, p.deltat)
            pts = to_world(xp, dist_c, ang_c)
            lab, _, matched, _ = assoc(pts, pts_prev, lab)
            pts_prev = pts
            xs = lm(Problems(dist_c, ang_c, mask_c, matched, x_prev, u_p,
                             odo_p, odo_c), xp, w,
                    p.init_gn_iters or p.pose_gn_iters)
            xs = torch.where(empty[:, None], xp, xs)
            x = _chain(x_last, xs, x_prev, ~empty)
        x_prev = torch.cat([x_last[None], x[:-1]])
        pts = to_world(kinematics(x_prev, u_p, p.deltat), dist_c, ang_c)
        _, n_new, _, (sx, sy, cnt) = assoc(pts, pts_prev, lab)
        nact += n_new
        x_last = x[-1]
        poses.append(x)
    live = cnt > 0
    pos = torch.stack([sx, sy], -1) / torch.clamp(cnt, min=1.0)[:, None] \
        * live[:, None]
    merged = filter_map(Map(pos, cnt, nact), 0.0, p.dist_thr)
    return merged, torch.cat(poses), nact


def causal_init(dist, mask, ang, odom, u, x0, seed_map: Map, p: Params,
                w: Weights, follow=None):
    """ICM iteration 0 frame by frame: predict the pose by the kinematics,
    associate its beams against the table as it stands (the nearest live
    landmark by distance, the first on a tie; beyond dist_thr the frame's
    far beams open one new landmark), fold them into the table by running
    means, then solve the frame's one-sided pose against the updated
    landmarks.  A frame with no valid beam keeps its prediction.  Returns
    (the table, the poses (T, 3)).

    ``follow`` (T, 3): another run's poses; frame t then starts from
    ``follow[t - 1]`` in place of this run's own pose, so that each frame's
    result is what that run's state gives it."""
    T, B = dist.shape
    L = p.L
    dtype, dev = dist.dtype, dist.device
    pos, counts, nact = seed_map.pos.clone(), seed_map.counts.clone(), \
        seed_map.nact
    masks = mask.cpu().numpy()
    x = x0
    out = [x0]
    for t in range(1, T):
        if follow is not None:
            x = follow[t - 1]
        xc = kinematics(x[None], u[t - 1][None], p.deltat)[0]
        sel = np.flatnonzero(masks[t])
        if sel.size == 0:
            x = xc
            out.append(x)
            continue
        sel_t = torch.as_tensor(sel, device=dev)
        d_t, a_t = dist[t, sel_t], ang[sel_t]
        pts = to_world(xc, d_t, a_t)
        if nact:
            diff = pts[:, None] - pos[None, :nact]
            dd = torch.sqrt((diff * diff).sum(-1))
            best, lab = dd.min(1)
            far = best > p.dist_thr
        else:
            lab = torch.zeros(sel.size, dtype=torch.long, device=dev)
            far = torch.ones(sel.size, dtype=torch.bool, device=dev)
        lab = torch.where(far, nact, lab)
        new = bool(far.any())
        keep = lab < L
        s = torch.zeros((L, 2), dtype=dtype, device=dev).index_put_(
            (lab[keep],), pts[keep], accumulate=True)
        c = torch.zeros((L,), dtype=dtype, device=dev).index_put_(
            (lab[keep],), torch.ones_like(lab[keep], dtype=dtype),
            accumulate=True)
        tot = counts + c
        pos = torch.where((c > 0)[:, None],
                          (s + pos * counts[:, None])
                          / torch.clamp(tot, min=1.0)[:, None], pos)
        counts = tot
        nact += int(new)
        matched = pos[torch.clamp(lab, 0, L - 1)]
        x = lm(Problems(d_t[None], a_t[None],
                        torch.ones((1, sel.size), dtype=torch.bool,
                                   device=dev),
                        matched[None], x[None], u[t - 1][None],
                        odom[t - 1][None], odom[t][None]),
               xc[None], w, p.pose_gn_iters)[0]
        out.append(x)
    return Map(pos, counts, nact), torch.stack(out)


# --------------------------------------------------------------------------
# the refinement sweep
# --------------------------------------------------------------------------

def refine_sweep(dist, mask, ang, odom, u, old: Map, x, p: Params,
                 w: Weights):
    """One ICM sweep: every frame's beams at its current pose against the
    frozen previous table (the nearest live landmark by squared distance;
    beyond dist_thr a frame's far beams open one new landmark), running
    means of the landmarks over the frames so far; then ``pose_passes``
    pairs of half-passes, the odd frames then the even ones, each pose
    solved two-sided between its neighbours from their midpoint (the last
    frame one-sided, from its kinematic prediction); a frame with no valid
    beam takes its neighbours' mean.  Returns (the sweep's table, x)."""
    T, B = dist.shape
    L = p.L
    dtype, dev = dist.dtype, dist.device
    angb = ang.expand(T, B)
    pts = to_world(x, dist, angb)
    K = old.nact
    if K:
        dx = pts[..., 0:1] - old.pos[:K, 0]
        dy = pts[..., 1:2] - old.pos[:K, 1]
        min2, lab = (dx * dx + dy * dy).min(-1)
        far = (min2 > p.dist_thr * p.dist_thr) & mask
    else:
        lab = torch.zeros((T, B), dtype=torch.long, device=dev)
        far = mask.clone()
    lab = torch.where(mask, lab, L)
    has_far = far.any(1)
    new_id = K + torch.cumsum(has_far.long(), 0) - 1
    lab = torch.where(far, new_id[:, None], lab)
    sx, sy, cn = _sums(pts, lab, L)
    csx, csy, ccn = (torch.cumsum(a, 0) for a in (sx, sy, cn))
    lc = torch.clamp(lab, 0, L - 1)
    den = torch.clamp(ccn, min=1.0)
    matched = torch.stack([torch.gather(csx / den, 1, lc),
                           torch.gather(csy / den, 1, lc)], -1)
    tot = torch.clamp(ccn[-1], min=1.0)
    new = Map(torch.stack([csx[-1] / tot, csy[-1] / tot], -1)
              * (ccn[-1] > 0)[:, None], ccn[-1], K + int(has_far.sum()))
    empty = ~mask.any(1)
    last = T - 1
    for _ in range(p.pose_passes):
        for start in (1, 2):
            ts = torch.arange(start, T, 2, device=dev)
            if ts.numel() == 0:
                continue
            tm1 = ts - 1
            tp1 = torch.clamp(ts + 1, max=last)
            is_last = ts == last
            prob = Problems(dist[ts], angb[ts], mask[ts], matched[ts],
                            x[tm1], u[tm1], odom[tm1], odom[ts],
                            x[tp1], u[ts], odom[tp1], fold=is_last)
            start_x = torch.where(is_last[:, None],
                                  kinematics(x[tm1], u[tm1], p.deltat),
                                  (x[tm1] + x[tp1]) / 2.0)
            cand = lm(prob, start_x, w, p.pose_gn_iters)
            cand = torch.where(empty[ts][:, None], (x[tm1] + x[tp1]) / 2.0,
                               cand)
            x = x.index_copy(0, ts, cand)
    return new, x


# --------------------------------------------------------------------------
# the pipelines
# --------------------------------------------------------------------------

def _inputs(world, p: Params, dtype, device):
    dist, mask, ang = filter_scans(world.scans, p, dtype, device)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)
    return dist, mask, ang, t(world.odom), t(world.u)


def refine(dist, mask, ang, odom, u, m: Map, x, p: Params, w: Weights,
           n_iters=None):
    """``N`` sweeps, each followed by the map filter."""
    for _ in range(p.N if n_iters is None else n_iters):
        new, x = refine_sweep(dist, mask, ang, odom, u, m, x, p, w)
        m = filter_map(new, p.cota, p.dist_thr)
    return m, x


def _result(m: Map, x_init, x) -> Result:
    k = m.nact
    return Result(x_init.float().cpu().numpy(), x.float().cpu().numpy(),
                  m.pos[:k].float().cpu().numpy(),
                  m.counts[:k].float().cpu().numpy())


def offline(world, p: Params, device, dtype=torch.float32) -> Result:
    """What ``run(world)`` computes: the scan filter, the frame-0 seed at
    the world's x0, the batched init and the map filter, then N sweeps."""
    w = Weights(p, dtype, device)
    dist, mask, ang, odom, u = _inputs(world, p, dtype, device)
    x0 = torch.as_tensor(np.asarray(world.x0), device=device).to(dtype)
    m0 = seed(dist[0], mask[0], ang, x0, p)
    m, x_init, _ = batched_init(dist, mask, ang, odom, u, x0, m0, p, w)
    m = filter_map(m, p.cota, p.dist_thr)
    m, x = refine(dist, mask, ang, odom, u, m, x_init, p, w)
    return _result(m, x_init, x)


def streamed(world, p: Params, device, init_device="cpu",
             dtype=torch.float32) -> Result:
    """What a stream of the world's frames through the online engine and
    its refining finish computes: the frame-0 seed at the first odometry
    pose, the causal init (on ``init_device``), the map filter, then N
    sweeps (on ``device``)."""
    dist, mask, ang, odom, u = (a.to(init_device) for a in _inputs(
        world, p, dtype, device))
    w = Weights(p, dtype, init_device)
    x0 = odom[0]
    m0 = seed(dist[0], mask[0], ang, x0, p)
    m, x_init = causal_init(dist, mask, ang, odom, u, x0, m0, p, w)
    m = filter_map(m, p.cota, p.dist_thr)

    def dev(a):
        return a.to(device)
    m = Map(dev(m.pos), dev(m.counts), m.nact)
    m, x = refine(dev(dist), dev(mask), dev(ang), dev(odom), dev(u), m,
                  dev(x_init), p, Weights(p, dtype, device))
    return _result(m, x_init, x)


def remap(world, x, map_pos, map_counts, p: Params, device,
          dtype=torch.float32):
    """The map of one more refinement sweep from another run's final poses
    ``x`` (T, 3) and map (``map_pos`` (K, 2), ``map_counts`` (K,)), then
    the map filter: the table a run's last sweep and filter build, from
    that run's own state, with no chaos between.  Returns (pos, counts)
    of the live landmarks."""
    dist, mask, ang, odom, u = _inputs(world, p, dtype, device)
    K = len(map_pos)
    pos = torch.zeros((p.L, 2), dtype=dtype, device=device)
    counts = torch.zeros((p.L,), dtype=dtype, device=device)
    pos[:K] = torch.as_tensor(np.asarray(map_pos), device=device).to(dtype)
    counts[:K] = torch.as_tensor(np.asarray(map_counts),
                                 device=device).to(dtype)
    xs = torch.as_tensor(np.asarray(x), device=device).to(dtype)
    new, _ = refine_sweep(dist, mask, ang, odom, u, Map(pos, counts, K), xs,
                          dataclasses.replace(p, pose_passes=0),
                          Weights(p, dtype, device))
    m = filter_map(new, p.cota, p.dist_thr)
    return (m.pos[:m.nact].float().cpu().numpy(),
            m.counts[:m.nact].float().cpu().numpy())


def replay_stream(world, x_init, p: Params, device, init_device="cpu",
                  dtype=torch.float32):
    """The causal init of ``streamed`` frame by frame from another run's
    poses ``x_init`` (T, 3): frame 0 is the first odometry pose, and frame
    t's pose is solved from ``x_init[t - 1]`` against the table built along
    ``x_init``.  Returns the poses (T, 3)."""
    dist, mask, ang, odom, u = (a.to(init_device) for a in _inputs(
        world, p, dtype, device))
    w = Weights(p, dtype, init_device)
    m0 = seed(dist[0], mask[0], ang, odom[0], p)
    follow = torch.as_tensor(np.asarray(x_init), device=init_device).to(
        dtype)
    _, x = causal_init(dist, mask, ang, odom, u, odom[0], m0, p, w, follow)
    return x.float().cpu().numpy()

