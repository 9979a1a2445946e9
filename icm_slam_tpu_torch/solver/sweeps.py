"""ICM sweep engines of the default batched path: Picard init, batched refine.

Port of the batched half of ``icm_slam_tpu.solver.sweeps``:

* ``init_sweep_batched`` — ICM iteration 0 as a chunked-Picard sweep
  (C frames per chunk, R rounds).  The JAX ``lax.scan`` over chunks is a
  Python loop with no host syncs; the segmented SE(2) ``associative_scan``
  is a log-step (Hillis-Steele) scan in plain ops.
* ``refine_sweep_batched`` — one sweep: all T associations against the
  frozen map in one pass (``batched_associate``), running means by
  cumulative sums over frames, then red-black half-passes of batched LM
  solves with the last frame's one-sided solve folded into the batch.

The association runs through the port's CUDA kernels on a GPU: the fused
association + per-frame sums (``ops.assoc_sums``) on the capped branch,
the nearest-landmark search (``ops.assoc``) on the uncapped one.
Only the default model with the one-new-label-per-frame quirk is ported.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from icm_slam_tpu_torch.core.energy import (PoseProblem, one_sided_jacobian,
                                            one_sided_residuals,
                                            two_sided_jacobian,
                                            two_sided_residuals)
from icm_slam_tpu_torch.core.geometry import beams_to_world, unicycle_step
from icm_slam_tpu_torch.mapping.landmark_map import MapState, filter_map
from icm_slam_tpu_torch.ops.assoc import nearest_landmark
from icm_slam_tpu_torch.ops.assoc_sums import associate_and_sums
from icm_slam_tpu_torch.solver.gauss_newton import lm_minimize


class SweepData(NamedTuple):
    """Pre-filtered dataset, fixed shapes. T frames x B beams."""
    dist: torch.Tensor   # (T, B) median-filtered ranges
    mask: torch.Tensor   # (T, B) informative-beam mask
    ang: torch.Tensor    # (B,) beam angles, or (T, B) once compacted
    odom: torch.Tensor   # (T, 3) odometry poses
    u: torch.Tensor      # (T, 2) controls [v, omega]


def compact_data(data: SweepData, cap: int) -> SweepData:
    """Move each frame's valid beams to the front (stable) and keep ``cap``.

    Exact when ``cap`` >= the largest per-frame valid count (auto_obs_cap).
    The returned ``ang`` is per-frame (T, cap).
    """
    order = torch.argsort((~data.mask).to(torch.int8), dim=1,
                          stable=True)[:, :cap]
    return SweepData(
        dist=torch.gather(data.dist, 1, order),
        mask=torch.gather(data.mask, 1, order),
        ang=data.ang[order],
        odom=data.odom, u=data.u)


def auto_obs_cap(mask, multiple: int = 8) -> int:
    """Smallest safe compaction budget for a dataset (host-side)."""
    m = int(mask.sum(dim=1).max()) if mask.shape[0] else 0
    return max(multiple, -(-m // multiple) * multiple)


def resolve_init_merge_cap(config) -> int:
    """Width of the batched init's final duplicate merge (0 = full L)."""
    cap = (config.map_run_cap if config.init_merge_cap < 0
           else config.init_merge_cap)
    return cap if 0 < cap < config.L else 0


def _per_frame_ang(data: SweepData) -> SweepData:
    return data._replace(ang=data.ang.expand(data.dist.shape))


def _frame_sums(px, py, lab, wgt, L):
    """Per-frame segment sums over L + 1 bins (bin L discards).

    px, py, wgt: (F, B); lab: (F, B) labels, clamped to L.
    Returns (sx, sy, cnt), each (F, L).
    """
    F = lab.shape[0]
    idx = (torch.clamp(lab, max=L).long()
           + torch.arange(F, device=lab.device)[:, None] * (L + 1))
    vals = torch.stack([px * wgt, py * wgt, wgt])            # (3, F, B)
    out = torch.zeros((3, F * (L + 1)), dtype=px.dtype, device=px.device)
    out.index_add_(1, idx.reshape(-1), vals.reshape(3, -1))
    out = out.view(3, F, L + 1)[:, :, :L]
    return out[0], out[1], out[2]


# ---------------------------------------------------------------------------
# batched (Picard) init sweep — ICM iteration 0
# ---------------------------------------------------------------------------

def _se2_scan(th, tx, ty, anc):
    """Inclusive segmented SE(2) composition scan, log-step (Hillis-Steele).

    Element i composes all elements from the last anchored one up to i;
    an anchored element resets the prefix.  Same operator as the JAX
    ``associative_scan``; the composition order differs, so results agree
    to rounding.
    """
    n = th.shape[0]
    off = 1
    while off < n:
        tha, txa, tya, aa = th[:-off], tx[:-off], ty[:-off], anc[:-off]
        thb, txb, tyb, ab = th[off:], tx[off:], ty[off:], anc[off:]
        ca, sa = torch.cos(tha), torch.sin(tha)
        th_n = torch.where(ab, thb, tha + thb)
        tx_n = torch.where(ab, txb, txa + ca * txb - sa * tyb)
        ty_n = torch.where(ab, tyb, tya + sa * txb + ca * tyb)
        th = torch.cat([th[:off], th_n])
        tx = torch.cat([tx[:off], tx_n])
        ty = torch.cat([ty[:off], ty_n])
        anc = torch.cat([anc[:off], aa | ab])
        off *= 2
    return th, tx, ty


def _rechain(xs, x_prev_stale, x_last, keep_abs=None):
    """Re-compose a chunk's pose chain from the carried anchor ``x_last``.

    Frames flagged ``keep_abs`` keep their absolute pose and re-anchor the
    chain; the others contribute their pose relative to the stale
    predecessor (``icm_slam_tpu.solver.sweeps.init_sweep_batched``).
    """
    C = xs.shape[0]
    dth = xs[:, 2] - x_prev_stale[:, 2]
    dx = xs[:, 0] - x_prev_stale[:, 0]
    dy = xs[:, 1] - x_prev_stale[:, 1]
    c = torch.cos(x_prev_stale[:, 2])
    sn = torch.sin(x_prev_stale[:, 2])
    rx = c * dx + sn * dy
    ry = -sn * dx + c * dy

    th = torch.cat([x_last[2:3], dth])
    px = torch.cat([x_last[0:1], rx])
    py = torch.cat([x_last[1:2], ry])
    if keep_abs is None:
        anc = torch.arange(C + 1, device=xs.device) == 0
    else:
        anc = torch.cat([torch.ones((1,), dtype=torch.bool, device=xs.device),
                         keep_abs])
    th = torch.where(anc, torch.cat([x_last[2:3], xs[:, 2]]), th)
    px = torch.where(anc, torch.cat([x_last[0:1], xs[:, 0]]), px)
    py = torch.where(anc, torch.cat([x_last[1:2], xs[:, 1]]), py)
    th, px, py = _se2_scan(th, px, py, anc)
    return torch.stack([px, py, th], dim=-1)[1:]


def init_sweep_batched(data: SweepData, seed: MapState, x0, config, w
                       ) -> Tuple[MapState, torch.Tensor, torch.Tensor]:
    """Causal init (ICM_ROS.py:47-119) as a chunked-Picard sweep.

    Returns (merged map_state, poses (T, 3), raw_nact), ``raw_nact`` being
    the pre-merge allocated-label count (the table-overflow witness).  See
    ``icm_slam_tpu.solver.sweeps.init_sweep_batched`` for the algorithm.
    """
    cap = config.obs_cap or 0
    if cap and cap < data.dist.shape[1]:
        data = compact_data(data, cap)
    else:
        data = _per_frame_ang(data)

    T, B = data.dist.shape
    L = seed.pos.shape[0]
    dtype, dev = x0.dtype, x0.device
    dist_thr = config.dist_thr
    deltat = config.deltat
    C = max(2, int(config.init_chunk_len))
    R = max(1, int(config.init_rounds))
    iters = config.init_gn_iters or config.pose_gn_iters
    z3 = torch.zeros((C, 3), dtype=dtype, device=dev)
    z2 = torch.zeros((C, 2), dtype=dtype, device=dev)

    # frames 1..T-1, padded to a multiple of C with empty frames
    n = T - 1
    nc = -(-n // C)
    pad = nc * C - n

    def pad_c(a):
        z = torch.zeros((pad,) + a.shape[1:], dtype=a.dtype, device=a.device)
        return torch.cat([a, z]).reshape((nc, C) + a.shape[1:])

    dist = pad_c(data.dist[1:])
    mask = pad_c(data.mask[1:])
    ang = pad_c(data.ang[1:])
    odom = pad_c(data.odom[1:])
    u_prev = pad_c(data.u[:T - 1])
    odom_prev = pad_c(data.odom[:T - 1])

    base_sx = seed.pos[:, 0] * seed.counts
    base_sy = seed.pos[:, 1] * seed.counts
    base_cnt = seed.counts
    nact = seed.nact
    x_last = x0
    chunks = []
    for ci in range(nc):
        dist_c, mask_c, ang_c = dist[ci], mask[ci], ang[ci]
        odom_c, u_prev_c, odom_prev_c = odom[ci], u_prev[ci], odom_prev[ci]
        empty = ~mask_c.any(dim=1)                                # (C,)

        def assoc_pass(pts, pts_prev, lab_prev):
            """One causal association round + anchored matched targets."""
            wgt = (lab_prev < L).to(dtype)
            sx, sy, cnt = _frame_sums(pts_prev[..., 0], pts_prev[..., 1],
                                      lab_prev, wgt, L)
            # EXCLUSIVE prefix: the table as each frame sees it
            csx = base_sx[None] + torch.cumsum(sx, 0) - sx        # (C, L)
            csy = base_sy[None] + torch.cumsum(sy, 0) - sy
            ccn = base_cnt[None] + torch.cumsum(cnt, 0) - cnt
            ex = csx / torch.clamp(ccn, min=1.0)
            ey = csy / torch.clamp(ccn, min=1.0)
            live = ccn > 0
            dx = pts[..., 0:1] - ex[:, None, :]
            dy = pts[..., 1:2] - ey[:, None, :]
            d2 = torch.where(live[:, None, :], dx * dx + dy * dy,
                             float("inf"))
            min2, lab = d2.min(dim=2)
            lab = lab.to(torch.int32)
            far = (min2 > dist_thr * dist_thr) & mask_c
            lab = torch.where(mask_c, lab, L)
            # quirk (ICM_SLAM.py:176): one shared new label per far frame
            has_far = far.any(dim=1)
            new_id = nact + torch.cumsum(has_far, 0, dtype=torch.int32) - 1
            lab = torch.where(far, torch.clamp(new_id[:, None], max=L), lab)
            n_new = has_far.sum().to(torch.int32)

            wgt_c = (lab < L).to(dtype)
            osx, osy, ocn = _frame_sums(pts[..., 0], pts[..., 1], lab,
                                        wgt_c, L)
            rx = (csx + osx) / torch.clamp(ccn + ocn, min=1.0)
            ry = (csy + osy) / torch.clamp(ccn + ocn, min=1.0)
            lab_cl = torch.clamp(lab, 0, L - 1).long()
            matched = torch.stack([torch.gather(rx, 1, lab_cl),
                                   torch.gather(ry, 1, lab_cl)], dim=-1)
            # far beams match their own frame's far-cluster mean
            ox = torch.gather(osx, 1, lab_cl)
            oy = torch.gather(osy, 1, lab_cl)
            oc = torch.clamp(torch.gather(ocn, 1, lab_cl), min=1.0)
            matched = torch.where(far[..., None],
                                  torch.stack([ox / oc, oy / oc], dim=-1),
                                  matched)
            fx = base_sx + osx.sum(dim=0)
            fy = base_sy + osy.sum(dim=0)
            fc = base_cnt + ocn.sum(dim=0)
            return lab, n_new, matched, fx, fy, fc

        def solve_round(x_prev_arr, xp, matched):
            prob = PoseProblem(
                dist=dist_c, ang=ang_c, mask=mask_c, matched=matched,
                x_prev=x_prev_arr, u_prev=u_prev_c, odo_prev=odom_prev_c,
                odo_cur=odom_c, x_next=z3, u_cur=z2, odo_next=z3)
            xs = lm_minimize(lambda xx: one_sided_residuals(xx, prob, w),
                             lambda xx: one_sided_jacobian(xx, prob, w),
                             xp, iters=iters)
            # empty frames take the pure kinematic increment; solved frames
            # keep their absolute pose
            xs = torch.where(empty[:, None], xp, xs)
            return _rechain(xs, x_prev_arr, x_last, keep_abs=~empty)

        # round 0: chain the measured odometry increments from the anchor
        dth0 = odom_c[:, 2] - odom_prev_c[:, 2]
        dwx = odom_c[:, 0] - odom_prev_c[:, 0]
        dwy = odom_c[:, 1] - odom_prev_c[:, 1]
        c0 = torch.cos(odom_prev_c[:, 2])
        s0 = torch.sin(odom_prev_c[:, 2])
        rel0 = torch.stack([c0 * dwx + s0 * dwy, -s0 * dwx + c0 * dwy,
                            dth0], dim=-1)
        x = _rechain(rel0, z3, x_last)
        lab = torch.full((C, B), L, dtype=torch.int32, device=dev)
        pts_prev = torch.zeros((C, B, 2), dtype=dtype, device=dev)
        for _ in range(R):
            x_prev_arr = torch.cat([x_last[None], x[:-1]])
            xp = unicycle_step(x_prev_arr, u_prev_c, deltat)
            pts = beams_to_world(xp, dist_c, ang_c)
            lab, n_new, matched, fx, fy, fc = assoc_pass(pts, pts_prev, lab)
            pts_prev = pts
            x = solve_round(x_prev_arr, xp, matched)

        if config.init_final_assoc:
            # final map-build from the converged poses (no solves)
            x_prev_arr = torch.cat([x_last[None], x[:-1]])
            xp = unicycle_step(x_prev_arr, u_prev_c, deltat)
            pts = beams_to_world(xp, dist_c, ang_c)
            lab, n_new, _, fx, fy, fc = assoc_pass(pts, pts_prev, lab)

        base_sx, base_sy, base_cnt = fx, fy, fc
        nact = nact + n_new
        x_last = x[-1]
        chunks.append(x)

    x = torch.cat([x0[None], torch.cat(chunks)[:n]])
    live = base_cnt > 0
    pos = (torch.stack([base_sx, base_sy], dim=-1)
           / torch.clamp(base_cnt, min=1.0)[:, None] * live[:, None])
    # merge duplicate columns without pruning (cota = 0); the raw
    # allocated-label count is returned as the overflow witness
    merged = filter_map(MapState(pos, base_cnt, nact), 0.0, dist_thr,
                        live_cap=resolve_init_merge_cap(config))
    return merged, x, nact


# ---------------------------------------------------------------------------
# batched refinement sweep
# ---------------------------------------------------------------------------

def batched_associate(data: SweepData, old_map: MapState, x, config):
    """Associate every frame against the frozen map in one batched pass.

    ``data`` has per-frame (T, B) ``ang``.  Returns (labels (T, B) int32
    in [0, L] with L = discard, map_after (MapState), matched (T, B, 2)
    running-mean values).  With an active ``map_run_cap`` only the first
    cap columns are searched (run() guarantees the live count stays below
    it), through the fused association + sums kernel, with the gate in the
    d^2 form; otherwise the nearest-landmark kernel searches all L columns
    and the gate compares the distance.
    """
    L = old_map.pos.shape[0]
    dist_thr = config.dist_thr
    cap_l = config.map_run_cap if 0 < config.map_run_cap < L else 0
    if not config.replicate_new_obs_quirk:
        raise NotImplementedError(
            "replicate_new_obs_quirk=False (connected-component labels) "
            "is not ported")

    pts = beams_to_world(x, data.dist, data.ang)             # (T, B, 2)
    if cap_l:
        lab_n, d2min, sums = associate_and_sums(
            pts, old_map.pos[:cap_l], data.mask, old_map.nact, dist_thr)
        lab = torch.where(d2min > dist_thr * dist_thr, -1, lab_n)
    else:
        lab_n, min_dist = nearest_landmark(pts, old_map.pos, old_map.nact)
        lab = torch.where(min_dist > dist_thr, -1, lab_n)
    lab = torch.where(data.mask, lab, L)

    far = lab == -1
    has_far = far.any(dim=1)                                  # (T,)
    # frame t's new label = nact0 + (#frames before t that spawned one)
    new_id = old_map.nact + torch.cumsum(has_far, 0, dtype=torch.int32) - 1
    lab = torch.where(far, new_id[:, None], lab)
    n_new = has_far.sum().to(torch.int32)
    if cap_l:
        final, matched = _running_means_capped(
            pts, data.mask, lab, far, has_far, new_id, sums, old_map, n_new,
            cap_l)
    else:
        final, matched = _running_means_full(pts, lab, old_map, n_new)
    return lab, final, matched


def _running_means_capped(pts, mask, lab, far, has_far, new_id, sums,
                          old_map, n_new, cap_l):
    """Running means from the kernel's per-frame old-landmark sums.

    A new landmark only receives observations from its creating frame, so
    its running mean is that frame's far-beam mean; old labels are < cap_l.
    """
    L = old_map.pos.shape[0]
    dtype, dev = pts.dtype, pts.device
    far_w = (far & mask).to(dtype)                            # (T, B)
    fcnt = far_w.sum(dim=1)                                   # (T,)
    fmean = torch.stack([(pts[..., 0] * far_w).sum(dim=1),
                         (pts[..., 1] * far_w).sum(dim=1)], dim=-1) \
        / torch.clamp(fcnt, min=1.0)[:, None]                 # (T, 2)

    cums = torch.cumsum(sums, dim=0)                          # (T, 3, cap)
    cum_cnt = cums[:, 2]
    denom = torch.clamp(cum_cnt, min=1.0)
    run_x = cums[:, 0] / denom
    run_y = cums[:, 1] / denom

    lab_c = torch.clamp(lab, 0, cap_l - 1).long()
    matched = torch.stack([torch.gather(run_x, 1, lab_c),
                           torch.gather(run_y, 1, lab_c)], dim=-1)
    matched = torch.where(far[..., None], fmean[:, None, :], matched)

    # final table: old columns from the cumulative sums, new columns from
    # the per-frame far means; row L is the discard row
    live_last = cum_cnt[-1] > 0
    pos = torch.zeros((L + 1, 2), dtype=dtype, device=dev)
    pos[:cap_l] = torch.stack([run_x[-1], run_y[-1]], dim=-1) \
        * live_last[:, None]
    counts = torch.zeros((L + 1,), dtype=dtype, device=dev)
    counts[:cap_l] = cum_cnt[-1]
    scatter_id = torch.clamp(torch.where(has_far, new_id, L), 0, L).long()
    pos[scatter_id] = fmean
    counts[scatter_id] = fcnt
    return MapState(pos[:L], counts[:L], old_map.nact + n_new), matched


def _running_means_full(pts, lab, old_map, n_new):
    """Running means over all L columns by per-frame segment sums."""
    L = old_map.pos.shape[0]
    w = (lab < L).to(pts.dtype)
    sx, sy, cnts = _frame_sums(pts[..., 0], pts[..., 1], lab, w, L)
    cum_cnt = torch.cumsum(cnts, dim=0)                       # (T, L)
    denom = torch.clamp(cum_cnt, min=1.0)
    run_x = torch.cumsum(sx, dim=0) / denom
    run_y = torch.cumsum(sy, dim=0) / denom
    lab_c = torch.clamp(lab, 0, L - 1).long()
    matched = torch.stack([torch.gather(run_x, 1, lab_c),
                           torch.gather(run_y, 1, lab_c)], dim=-1)
    live_last = cum_cnt[-1] > 0
    final_pos = torch.stack([run_x[-1], run_y[-1]], dim=-1) \
        * live_last[:, None]
    return MapState(final_pos, cum_cnt[-1], old_map.nact + n_new), matched


def _solve_two_at(data: SweepData, x, obs, config, w, ts, last_t):
    """Two-sided LM solves for the poses ``ts`` (K,) as one batch of K.

    The last real frame ``last_t`` is solved with the one-sided cost folded
    into the batch: zeroing the 6 forward rows of its residual and of its
    Jacobian leaves exactly the one-sided system, and its start point is
    the kinematic prediction (ICM_ROS.py:153-156, 254-260).
    """
    T = x.shape[0]
    dist_c, ang_c, mask_c, matched_c = obs
    tm1 = torch.clamp(ts - 1, min=0)
    tp1 = torch.clamp(ts + 1, max=T - 1)
    prob = PoseProblem(
        dist=dist_c[ts], ang=ang_c[ts], mask=mask_c[ts],
        matched=matched_c[ts], x_prev=x[tm1], u_prev=data.u[tm1],
        odo_prev=data.odom[tm1], odo_cur=data.odom[ts],
        x_next=x[tp1], u_cur=data.u[ts], odo_next=data.odom[tp1])
    is_last = (ts == last_t)[:, None]
    x_init = torch.where(is_last,
                         unicycle_step(x[tm1], data.u[tm1], config.deltat),
                         (x[tm1] + x[tp1]) / 2.0)
    m = 12 + 2 * dist_c.shape[1]
    fold = is_last & (torch.arange(m, device=x.device) < 6)   # (K, m)

    def resid(xx):
        r = two_sided_residuals(xx, prob, w)
        return torch.where(fold, 0.0, r)

    def jac(xx):
        J = two_sided_jacobian(xx, prob, w)
        return torch.where(fold[..., None], 0.0, J)

    return lm_minimize(resid, jac, x_init, iters=config.pose_gn_iters)


def refine_sweep_batched(data: SweepData, old_map: MapState, x, config, w,
                         last_t: int | None = None
                         ) -> Tuple[MapState, torch.Tensor]:
    """One ICM sweep: batched association + red-black pose half-passes."""
    if config.pose_update != "redblack":
        raise NotImplementedError(
            f"pose_update={config.pose_update!r} is not ported")
    T = x.shape[0]
    if last_t is None:
        last_t = T - 1
    empty = ~data.mask.any(dim=1)                             # (T,)

    cap = config.obs_cap if config.obs_cap else data.dist.shape[1]
    if cap < data.dist.shape[1]:
        data_c = compact_data(data, cap)
    else:
        data_c = _per_frame_ang(data)
    _, final_map, matched = batched_associate(data_c, old_map, x, config)
    obs = (data_c.dist, data_c.ang, data_c.mask, matched)

    def solve_at(x, ts):
        cand = _solve_two_at(data, x, obs, config, w, ts, last_t)
        tm1 = torch.clamp(ts - 1, min=0)
        tp1 = torch.clamp(ts + 1, max=last_t)
        x_avg = (x[tm1] + x[tp1]) / 2.0
        cand = torch.where(empty[ts][:, None], x_avg, cand)
        cand = torch.where((ts <= last_t)[:, None], cand, x[ts])
        return x.index_copy(0, ts, cand)

    odd = torch.arange(1, T, 2, device=x.device)
    even = torch.arange(2, T, 2, device=x.device)
    for _ in range(config.pose_passes):
        x = solve_at(x, odd)
        x = solve_at(x, even)
    return final_map, x
