"""Windowed bundle adjustment: joint pose solves over keyframe blocks
(``sweep_mode="windowed_ba"``).

Port of ``icm_slam_tpu.models.windowed_ba``: the trajectory is cut into
windows of ``win`` frames, each window's poses are optimized jointly by
dense Gauss-Newton / LM with the poses around it frozen (the map enters
through the frozen running-mean matched values of the batched sweep), and
every window of a pass solves in one batch: the residuals and their
(3 win)-column forward-mode Jacobians by ``torch.func.vmap`` over the
windows, the (3 win x 3 win) normal systems by one batched
``torch.linalg.solve``.  Two passes, the second offset by win/2, update
the window boundaries.  The per-frame averages go through
``landmark_map.add_rows`` (a fixed order on the card too).  A fleet's W
worlds (a leading world axis) put all their windows in one batch.

Spans (``utils.profiling.span``): ``icm.wba.assoc`` around the
association, ``icm.wba.pass`` around each pass, holding each LM step's
``icm.wba.jacobian`` (the residuals and their Jacobians),
``icm.wba.normal`` (J^T r, J^T J, the damping and the batched solve) and
``icm.wba.accept`` (the trial residuals and the LM accept test), and
``icm.wba.fill`` around the empty frames' neighbour average.  Given a
``timings`` dict, a sweep adds to its counters ``wba_passes``,
``wba_windows`` (the windows solved), ``wba_steps`` (the windows' LM
steps), ``wba_pass_s`` (host seconds in the passes) and ``wba_accepted``
(the accepted steps, a device tensor that the caller reads once, with
its results), and the size of the normal systems solved: ``wba_rows``
and ``wba_cols``, each system's residual rows and pose columns summed
over the window LM steps.  None of them waits for the device.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch.func import jacfwd, vmap

from icm_slam_tpu_torch.core.energy import _odo_residual, _wrap_heading
from icm_slam_tpu_torch.core.geometry import unicycle_step
from icm_slam_tpu_torch.mapping.landmark_map import MapState, add_rows
from icm_slam_tpu_torch.solver.sweeps import (SweepData, _per_frame_ang,
                                              batched_associate, compact_data)
from icm_slam_tpu_torch.utils.profiling import span


def _chain_residuals(xa, xb, u_a, odo_a, odo_b, w):
    """(E, 6) kinematic + odometry residuals of the edges a -> b; every
    argument has a leading E."""
    sqrt_r, _, sqrt_odom, deltat = w
    r_kin = sqrt_r * _wrap_heading(xb - unicycle_step(xa, u_a, deltat))
    r_odo = sqrt_odom * _odo_residual(xa[:, 2], odo_a, odo_b,
                                      xb[:, :2] - xa[:, :2],
                                      xb[:, 2] - xa[:, 2])
    return torch.cat([r_kin, r_odo], dim=1)


def _window_residuals(p, x_prev_fix, x_next_fix, dist, ang, mask, matched,
                      u_in, odo_in, odo_prev, u_last, odo_next, frame_ok,
                      next_ok, w):
    """All residuals owned by one window, (2 win K + 6 (win + 1),).

    p: (win, 3) free poses; x_prev_fix / x_next_fix: (3,) the frozen poses
    before and after the window; dist/ang/mask/matched: (win, K...)
    compacted observations; u_in/odo_in: (win, ...) control/odometry at
    the window's frames; odo_prev: (3,) odometry of the frame before;
    u_last/odo_next: the edge to the pose after the window; frame_ok:
    (win,) frames past the real trajectory end contribute nothing;
    next_ok: () whether a real frame follows the window.  Without one,
    x_next_fix is the window's own stale last pose and the forward edge
    would be a self-edge: next_ok masks it, giving the last pose the
    one-sided treatment.
    """
    sqrt_q = w[1]
    a = ang + p[:, 2:3] - math.pi / 2.0                       # (win, K)
    pts = p[:, None, :2] + dist[..., None] * torch.stack(
        [torch.cos(a), torch.sin(a)], dim=-1)
    r_obs = (pts - matched) * sqrt_q
    r_obs = torch.where((mask & frame_ok[:, None])[..., None], r_obs, 0.0)

    # chain edges: (prev -> p0), (p0 -> p1), ..., (p_{win-1} -> next)
    xs_a = torch.cat([x_prev_fix[None], p])                   # (win + 1, 3)
    xs_b = torch.cat([p, x_next_fix[None]])
    u_e = torch.cat([u_in, u_last[None]])
    odo_a = torch.cat([odo_prev[None], odo_in])
    odo_b = torch.cat([odo_in, odo_next[None]])
    edge_ok = torch.cat([frame_ok, (frame_ok[-1] & next_ok)[None]])
    r_chain = _chain_residuals(xs_a, xs_b, u_e, odo_a, odo_b, w)
    r_chain = torch.where(edge_ok[:, None], r_chain, 0.0)
    return torch.cat([r_obs.reshape(-1), r_chain.reshape(-1)])


def _count(timings, **add) -> None:
    """Add to the counters in ``timings`` (None: nothing)."""
    if timings is not None:
        for k, v in add.items():
            timings[k] = timings.get(k, 0) + v


def _solve_windows(data: SweepData, obs, x, offset, win, last_t, config, w,
                   timings=None):
    """One pass over the windows of ``win`` frames starting at offset + 1,
    offset + 1 + win, ... (pose 0 is never free), all solved in one batch.
    A fleet (``x`` (W, T, 3), ``data`` and ``obs`` with the world axis)
    puts the windows of all W worlds in that batch, world by world, and
    averages each world's poses in its own rows of one flat table.
    ``timings`` gets the pass's counters."""
    T = x.shape[-2]
    lead = x.shape[:-2]
    n = math.prod(lead)
    dev, dtype = x.device, x.dtype
    dist_c, ang_c, mask_c, matched_c = obs
    n_win = max(1, -(-(T - offset - 1) // win))
    starts = offset + 1 + torch.arange(n_win, device=dev) * win
    idx = starts[:, None] + torch.arange(win, device=dev)     # (n_win, win)
    ok = (idx >= 1) & (idx <= last_t)
    idx_c = torch.clamp(idx, max=T - 1)
    # a pass offset past a short trajectory leaves one inert window (no
    # frame of it is ok); JAX's gathers clamp its indices into range
    prev = torch.clamp(starts - 1, 0, T - 1)
    after = torch.clamp(starts + win, max=T - 1)

    def take(a, i):
        """``a[i]`` of each world, the worlds' windows one after another."""
        return a[i] if not lead else a[:, i].flatten(0, 1)

    args = (take(x, prev), take(x, after), take(dist_c, idx_c),
            take(ang_c, idx_c), take(mask_c, idx_c), take(matched_c, idx_c),
            take(data.u, idx_c), take(data.odom, idx_c),
            take(data.odom, prev),
            take(data.u, torch.clamp(starts + win - 1, max=T - 1)),
            take(data.odom, after), ok.repeat(n, 1),
            ((starts + win) <= last_t).repeat(n))

    def resid_one(flat, *a):
        return _window_residuals(flat.reshape(win, 3), *a, w)

    resid = vmap(resid_one)
    jac = vmap(jacfwd(resid_one))
    eye = torch.eye(3 * win, dtype=dtype, device=dev)
    flat = take(x, idx_c).reshape(n * n_win, 3 * win)
    lam = torch.full((n * n_win,), 1e-4, dtype=dtype, device=dev)
    accepted, m = 0, 0
    for _ in range(config.ba_gn_iters):
        with span("icm.wba.jacobian"):
            r = resid(flat, *args)                            # (n, m)
            J = jac(flat, *args)                              # (n, m, 3win)
            m = J.shape[1]
        with span("icm.wba.normal"):
            Jt = J.transpose(1, 2)
            g = torch.bmm(Jt, r[..., None])[..., 0]
            H = torch.bmm(Jt, J)
            damp = torch.diag_embed(torch.clamp(
                torch.diagonal(H, dim1=1, dim2=2), min=1e-9))
            A = H + lam[:, None, None] * damp + 1e-9 * eye
            delta = torch.linalg.solve_ex(A, -g).result       # no sync
        with span("icm.wba.accept"):
            new = flat + delta
            r_new = resid(new, *args)
            better = (r_new * r_new).sum(dim=1) < (r * r).sum(dim=1)
            flat = torch.where(better[:, None], new, flat)
            lam = torch.where(better, lam * 0.3, lam * 5.0)
            if timings is not None:
                accepted = accepted + better.sum()
    steps = n * n_win * config.ba_gn_iters
    _count(timings, wba_passes=1, wba_windows=n * n_win, wba_steps=steps,
           wba_accepted=accepted, wba_rows=steps * m,
           wba_cols=steps * 3 * win)

    # each frame lies in at most one window of a pass: the average below
    # is that window's pose (frames past last_t add zeros); each world's
    # frames are T rows apart in the flat table
    new_p = flat.reshape(n * n_win, win, 3) * args[11][..., None]
    rows = idx_c.reshape(-1)
    if lead:
        rows = (rows + torch.arange(n, device=dev)[:, None] * T).reshape(-1)
    upd = add_rows(torch.zeros((n * T, 3), dtype=dtype, device=dev), rows,
                   new_p.reshape(-1, 3)).view(x.shape)
    cnt = add_rows(torch.zeros((n * T, 1), dtype=dtype, device=dev), rows,
                   args[11].reshape(-1, 1).to(dtype)).view(
                       lead + (T, 1))
    return torch.where(cnt > 0, upd / torch.clamp(cnt, min=1.0), x)


def windowed_ba_refine(data: SweepData, old_map: MapState, x, config, w,
                       window: int = 64, last_t: int | None = None,
                       timings=None) -> Tuple[MapState, torch.Tensor]:
    """One outer iteration: batched association + two offset window
    passes, then the reference's neighbour average for empty frames.  A
    fleet (``x`` (W, T, 3), ``data`` and ``old_map`` with the world axis)
    is one association and one batch of windows a pass for all W
    worlds.  ``timings`` gets the passes' counters."""
    T = x.shape[-2]
    if last_t is None:
        last_t = T - 1
    cap = config.obs_cap if config.obs_cap else data.dist.shape[-1]
    data_c = compact_data(data, cap) if cap < data.dist.shape[-1] \
        else _per_frame_ang(data)
    with span("icm.wba.assoc"):
        _, final_map, matched = batched_associate(data_c, old_map, x, config)
    obs = (data_c.dist, data_c.ang, data_c.mask, matched)
    for offset in (0, window // 2):
        t = {}
        with span("icm.wba.pass", t, "s"):
            x = _solve_windows(data, obs, x, offset, window, last_t, config,
                               w, timings)
        _count(timings, wba_pass_s=t["s"])
    with span("icm.wba.fill"):
        empty = ~data.mask.any(dim=-1)
        t_idx = torch.arange(T, device=x.device)
        avg = (x[..., torch.clamp(t_idx - 1, min=0), :]
               + x[..., torch.clamp(t_idx + 1, max=T - 1), :]) / 2
        sel = empty & (t_idx >= 1) & (t_idx <= last_t)
        return final_map, torch.where(sel[..., None], avg, x)
