"""ICM sweep engines: causal init, sequential refine, Picard init, batched
refine.

Port of ``icm_slam_tpu.solver.sweeps``:

* ``init_sweep`` / ``init_chunk`` — ICM iteration 0 frame by frame (the
  reference's causal loop): a Python loop over one-problem LM solves in
  place of the JAX ``lax.scan``, with no host sync per frame.
* ``refine_sweep_sequential`` — the reference-faithful Gauss-Seidel sweep,
  frame by frame against the frozen previous map.
* ``init_sweep_batched`` — ICM iteration 0 as a chunked-Picard sweep
  (C frames per chunk, R rounds).  The JAX ``lax.scan`` over chunks is a
  chunk step over fixed buffers (``BatchedInit``) with no host sync,
  replayed from one CUDA graph on the card; the segmented SE(2)
  ``associative_scan`` is a log-step (Hillis-Steele) scan in plain ops.
* ``refine_sweep_batched`` — one sweep: all T associations against the
  frozen map in one pass (``batched_associate``), running means by
  cumulative sums over frames, then red-black half-passes (or Jacobi
  passes) of batched LM solves with the last frame's one-sided solve
  folded into the batch.

Every engine runs on a leading world axis W: a fleet of W same-shape
worlds (``solver.icm.run_batched``, the JAX package's ``vmap``) is the
same sequence of operations as one world, each one W times as wide, and
the kernels take W worlds in one launch.  Given one world (no W axis),
the batched engine (``compact_data``, ``init_sweep_batched``,
``batched_associate``, ``refine_sweep_batched`` and their helpers) runs
the same code with W = 1, and the causal engines (``init_sweep``,
``init_chunk``, ``refine_sweep_sequential``) run their one-world form, the
same ops without the axis.  Every cumulative sum runs along the frames of
its own world.

The association runs through the port's CUDA kernels on a GPU: the fused
association + per-frame sums (``ops.assoc_sums``) on the capped quirk
branch, the nearest-landmark search (``ops.assoc``) on the other batched
branches and, through ``landmark_map.update``, in every frame of the
sequential engines.  Every LM pose solve goes through ``_pose_solve``:
with the default model that is the fused LM kernel (``ops.pose_lm``,
K4), one launch for a batch of problems; a config's ``EnergyModel``
takes the plain LM on its cost, whose hooks are torch code.  Both use the
cofactor 3x3 solve (JAX's sequential engines use an LU solve: the same
math, other rounding) and the analytic Jacobians of ``core.energy`` (a
model's hooks by forward mode; JAX takes ``jacfwd`` of every residual).
Such a model also reaches the kinematic predictions, and when it replaces
or extends the two-sided cost the last frame's one-sided solve runs on
its own (``_solve_one_at``), not folded into the batch.
"""
from __future__ import annotations

import functools
import math
import time
from typing import NamedTuple, Tuple

import torch

from icm_slam_tpu_torch.core.energy import (DEFAULT_MODEL, EnergyModel,
                                            PoseProblem, two_sided_jacobian,
                                            two_sided_residuals)
from icm_slam_tpu_torch.core.geometry import beams_to_world
from icm_slam_tpu_torch.mapping.landmark_map import (MapState, add_rows,
                                                     compact_labels,
                                                     connected_component_labels,
                                                     filter_map, update)
from icm_slam_tpu_torch.ops.assoc import nearest_landmark
from icm_slam_tpu_torch.ops.assoc_sums import associate_and_sums
from icm_slam_tpu_torch.ops.pose_lm import pose_lm, pose_lm_plain
from icm_slam_tpu_torch.solver.cuda_graph import CapturedStep


class SweepData(NamedTuple):
    """Pre-filtered dataset, fixed shapes. T frames x B beams (a fleet's
    worlds: the same with a leading world axis W)."""
    dist: torch.Tensor   # (T, B) median-filtered ranges
    mask: torch.Tensor   # (T, B) informative-beam mask
    ang: torch.Tensor    # (B,) beam angles, or (T, B) once compacted
    odom: torch.Tensor   # (T, 3) odometry poses
    u: torch.Tensor      # (T, 2) controls [v, omega]


def with_world_axis(nt):
    """A SweepData or MapState of one world as a fleet of W = 1."""
    return type(nt)(*(a[None] for a in nt))


def world(nt, w: int = 0):
    """World ``w`` of a fleet's SweepData or MapState."""
    return type(nt)(*(a[w] for a in nt))


def compact_data(data: SweepData, cap: int) -> SweepData:
    """Move each frame's valid beams to the front (stable) and keep ``cap``.

    Exact when ``cap`` >= the largest per-frame valid count (auto_obs_cap).
    The returned ``ang`` is per-frame (..., T, cap).
    """
    order = _valid_first(data.mask, cap)
    return SweepData(
        dist=torch.gather(data.dist, -1, order),
        mask=torch.gather(data.mask, -1, order),
        ang=torch.gather(_per_frame_ang(data).ang, -1, order),
        odom=data.odom, u=data.u)


def compact_obs(data: SweepData, matched, cap: int):
    """Gather each frame's valid beams to the front and truncate to ``cap``.

    As ``compact_data``, for a pose solve's observations: real frames
    carry ~10-17 informative beams of 181, so a solve over the whole
    padded beam axis spends ~90% of its work on zero residuals.  Exact
    when ``cap`` >= the largest per-frame valid count (auto_obs_cap).
    Returns (dist (..., T, cap), ang (..., T, cap), mask (..., T, cap),
    matched (..., T, cap, 2)).
    """
    order = _valid_first(data.mask, cap)
    return (torch.gather(data.dist, -1, order),
            torch.gather(_per_frame_ang(data).ang, -1, order),
            torch.gather(data.mask, -1, order),
            torch.gather(matched, -2, order[..., None].expand(
                order.shape + matched.shape[-1:])))


def _valid_first(mask, cap: int):
    """Per frame, the beam indices with the valid ones first (each group
    in beam order), the first ``cap`` of them."""
    return torch.argsort((~mask).to(torch.int8), dim=-1,
                         stable=True)[..., :cap]


def auto_obs_cap(mask, multiple: int = 8) -> int:
    """Smallest safe compaction budget for a dataset (host-side)."""
    m = int(mask.sum(dim=-1).max()) if mask.numel() else 0
    return max(multiple, -(-m // multiple) * multiple)


def resolve_init_merge_cap(config) -> int:
    """Width of the batched init's final duplicate merge (0 = full L)."""
    cap = (config.map_run_cap if config.init_merge_cap < 0
           else config.init_merge_cap)
    return cap if 0 < cap < config.L else 0


def _per_frame_ang(data: SweepData) -> SweepData:
    """``data`` with per-frame beam angles (..., T, B)."""
    if data.ang.dim() == data.dist.dim():
        return data
    return data._replace(ang=data.ang.unsqueeze(-2).expand(data.dist.shape))


def _frame_sums(px, py, lab, wgt, L):
    """Per-frame segment sums over L + 1 bins (bin L discards).

    px, py, wgt: (..., F, B); lab: (..., F, B) labels, clamped to L.
    Returns (sx, sy, cnt), each (..., F, L).
    """
    lead = lab.shape[:-1]
    F = lab[..., 0].numel()
    idx = (torch.clamp(lab, max=L).long().reshape(F, -1)
           + torch.arange(F, device=lab.device)[:, None] * (L + 1))
    vals = torch.stack([px * wgt, py * wgt, wgt], dim=-1)    # (..., B, 3)
    out = add_rows(torch.zeros((F * (L + 1), 3), dtype=px.dtype,
                               device=px.device),
                   idx.reshape(-1), vals.reshape(-1, 3))
    out = out.view(lead + (L + 1, 3))[..., :L, :]
    return out[..., 0], out[..., 1], out[..., 2]


def _model_of(config) -> EnergyModel:
    """The config's EnergyModel; DEFAULT_MODEL when it sets none."""
    return DEFAULT_MODEL if config.model is None else config.model


def _pose_solve(prob, x0, w, config, two_sided: bool, fold=None,
                iters=None):
    """The sweeps' LM pose solve of the problems ``prob`` from ``x0``
    (P, 3): K4 (``ops.pose_lm``) for the default model, the plain LM on
    the config's model's cost for a model (K4 cannot run its hooks).
    ``fold`` (P,) zeroes the forward rows of a two-sided cost."""
    iters = config.pose_gn_iters if iters is None else iters
    if config.model is None:
        return pose_lm(prob, x0, w, iters, two_sided, fold)
    return pose_lm_plain(prob, x0, w, iters, two_sided, fold, config.model)


def _two_sided(prob, w, config):
    """(residual fn, Jacobian fn) of the two-sided cost under the config's
    model (``parallel.pipeline``'s LM stage)."""
    model = _model_of(config)
    return (lambda xx: two_sided_residuals(xx, prob, w, model),
            lambda xx: two_sided_jacobian(xx, prob, w, model))


def _where_map(cond, a: MapState, b: MapState) -> MapState:
    """``a`` where ``cond`` else ``b``, field by field; ``cond`` () for one
    world, (W,) for a fleet's maps."""
    return MapState(*(torch.where(cond.reshape(cond.shape + (1,) * (
        u.dim() - cond.dim())), u, v) for u, v in zip(a, b)))


# ---------------------------------------------------------------------------
# causal init sweep — ICM iteration 0, frame by frame
# ---------------------------------------------------------------------------
#
# The causal engines (``_causal_step``, ``init_chunk``, ``init_sweep``,
# ``refine_sweep_sequential``) take one world or a fleet's W worlds on a
# leading world axis: poses (W, 3) or (W, T, 3), the map and ``data`` with
# the world axis.  A fleet's frame is then one K2 launch at (W, 1, B, L)
# (``landmark_map.update``) and one LM batch of W poses, so W worlds cost
# the launches of one; every choice per world is a ``torch.where``.

def _causal_step(state: MapState, xt, frame, config, w):
    """One frame of the causal init (ICM_ROS.py:102-119).

    frame = (dist_t (B,), mask_t (B,), ang_t (B,), u_prev (2,),
    odo_prev (3,), odo_cur (3,)), each with the world axis W of a fleet
    (xt (W, 3)).  Returns (new state, new pose).  Empty frames dead-reckon
    and leave the map as ``update`` left it (it adds nothing for an
    all-masked frame); the choice is a ``torch.where``, so the step never
    waits for the device.
    """
    dist_t, mask_t, ang_t, u_prev, odo_prev, odo_cur = frame
    lead = xt.shape[:-1]
    flat = functools.partial(_flat, lead=len(lead))
    L = state.pos.shape[-2]
    model = _model_of(config)
    xtc = model.kinematics(flat(xt), flat(u_prev), config.deltat).view(
        xt.shape)
    empty = ~mask_t.any(dim=-1)
    pts = beams_to_world(xtc, dist_t, ang_t)
    new_state, labels = update(state, state.pos, state.nact, pts, mask_t,
                               config.dist_thr,
                               config.replicate_new_obs_quirk)
    matched = torch.gather(
        new_state.pos, -2,
        torch.clamp(labels, 0, L - 1).long()[..., None].expand(
            labels.shape + (2,)))
    dist_p, ang_p, mask_p, matched_p = dist_t, ang_t, mask_t, matched
    cap = config.obs_cap or 0
    B = mask_t.shape[-1]
    if cap and cap < B:
        # gather the valid beams for the pose solve (exact when cap >= the
        # frame's valid count): the JAX cumsum-scatter compaction, each
        # world's slots cap + 1 apart (slot cap discards)
        n = mask_t[..., 0].numel()
        dev = mask_t.device
        rank = torch.cumsum(mask_t, -1) - 1
        tgt = (torch.where(mask_t & (rank < cap), rank, cap)
               + torch.arange(0, n * (cap + 1), cap + 1,
                              device=dev).view(lead + (1,)))
        order = torch.zeros((n * (cap + 1),), dtype=torch.long, device=dev)
        order[tgt.reshape(-1)] = torch.arange(B, device=dev).repeat(n)
        order = order.view(lead + (cap + 1,))[..., :cap]
        mask_p = (torch.arange(cap, device=dev)
                  < mask_t.sum(dim=-1, keepdim=True))
        dist_p = torch.gather(dist_t, -1, order)
        ang_p = torch.gather(ang_t.expand(dist_t.shape), -1, order)
        matched_p = torch.gather(matched, -2,
                                 order[..., None].expand(order.shape + (2,)))
    z3 = xt.new_zeros((math.prod(lead), 3))
    prob = PoseProblem(
        dist=flat(dist_p), ang=flat(ang_p), mask=flat(mask_p),
        matched=flat(matched_p), x_prev=flat(xt), u_prev=flat(u_prev),
        odo_prev=flat(odo_prev), odo_cur=flat(odo_cur), x_next=z3,
        u_cur=z3[:, :2], odo_next=z3)
    x_opt = _pose_solve(prob, flat(xtc), w, config, False).view(xt.shape)
    return new_state, torch.where(empty[..., None], xtc, x_opt)


def init_chunk(data: SweepData, state: MapState, xt, config, w,
               t_offset: int = 1):
    """Causal init over the frames t_offset..T-1 of ``data``, from the
    carry (state, xt).  Returns (state, last pose, poses of those frames
    (T - t_offset, 3), or (W, T - t_offset, 3) for a fleet)."""
    T = data.dist.shape[-2]
    ang = _per_frame_ang(data).ang
    xs = []
    for t in range(t_offset, T):
        frame = (data.dist[..., t, :], data.mask[..., t, :], ang[..., t, :],
                 data.u[..., t - 1, :], data.odom[..., t - 1, :],
                 data.odom[..., t, :])
        state, xt = _causal_step(state, xt, frame, config, w)
        xs.append(xt)
    xs = (torch.stack(xs, dim=-2) if xs
          else xt.new_zeros(xt.shape[:-1] + (0, 3)))
    return state, xt, xs


def init_sweep(data: SweepData, seed: MapState, x0, config, w
               ) -> Tuple[MapState, torch.Tensor, torch.Tensor]:
    """The causal init over frames 1..T-1 from the frame-0 seed.

    Returns (map_state, poses (T, 3), raw_nact): the raw allocated-label
    count, the table-overflow witness.  A fleet (``x0`` (W, 3), ``data``
    and ``seed`` with the world axis) returns (W, T, 3) poses and (W,)
    counts, one K2 launch and one LM batch a frame for all W worlds.
    """
    cap = config.obs_cap or 0
    if cap and cap < data.dist.shape[-1]:
        data = compact_data(data, cap)
    state, _, xs = init_chunk(data, seed, x0, config, w, t_offset=1)
    return state, torch.cat([x0[..., None, :], xs], dim=-2), state.nact


# ---------------------------------------------------------------------------
# sequential refinement sweep (fidelity mode)
# ---------------------------------------------------------------------------

def refine_sweep_sequential(data: SweepData, old_map: MapState, x, config,
                            w) -> Tuple[MapState, torch.Tensor]:
    """One Gauss-Seidel ICM sweep, faithful to ICM_ROS.py:121-164.

    ``data`` has the shared 1-D beam angles.  Frame t associates at its
    stale pose against the frozen ``old_map`` and accumulates into a
    table zeroed and seeded by frame 0; interior poses solve the
    two-sided cost from the midpoint of their neighbours (fresh x[t-1],
    stale x[t+1]), the last frame the one-sided cost from the kinematic
    prediction; empty frames average.  The poses are written in place
    into a clone of ``x``.  An empty frame 0 returns (old_map, x)
    unchanged (ICM_ROS.py:133-135), chosen by ``torch.where``.  A fleet
    (``x`` (W, T, 3), ``data`` and ``old_map`` with the world axis) writes
    ``x_all[:, t]``: one K2 launch and one LM batch a frame for all W
    worlds, each world's choices its own.
    """
    T = x.shape[-2]
    lead = x.shape[:-2]
    flat = functools.partial(_flat, lead=len(lead))
    L = old_map.pos.shape[-2]
    dist_thr = config.dist_thr
    quirk = config.replicate_new_obs_quirk
    dtype, dev = x.dtype, x.device
    ang = flat(data.ang.expand(data.dist.shape[:-2] + data.dist.shape[-1:]))
    model = _model_of(config)

    def at(a, t):
        """Frame t of ``a`` (..., T, ...) as (P, ...)."""
        return flat(a[..., t, :])

    def assoc_frame(state, xt, t):
        pts = beams_to_world(xt, data.dist[..., t, :], data.ang)
        new_state, labels = update(state, old_map.pos, old_map.nact, pts,
                                   data.mask[..., t, :], dist_thr, quirk)
        return new_state, torch.gather(
            new_state.pos, -2,
            torch.clamp(labels, 0, L - 1).long()[..., None].expand(
                labels.shape + (2,)))

    state = MapState(torch.zeros(lead + (L, 2), dtype=dtype, device=dev),
                     torch.zeros(lead + (L,), dtype=dtype, device=dev),
                     old_map.nact)
    state, _ = assoc_frame(state, x[..., 0, :], 0)
    x_all = x.clone()
    xt_run = x[..., 0, :]
    for t in range(1, T - 1):
        empty = ~data.mask[..., t, :].any(dim=-1)
        new_state, matched = assoc_frame(state, x_all[..., t, :], t)
        x_prev, x_next = x_all[..., t - 1, :], x_all[..., t + 1, :]
        prob = PoseProblem(
            dist=at(data.dist, t), ang=ang, mask=at(data.mask, t),
            matched=flat(matched), x_prev=flat(x_prev),
            u_prev=at(data.u, t - 1), odo_prev=at(data.odom, t - 1),
            odo_cur=at(data.odom, t), x_next=flat(x_next),
            u_cur=at(data.u, t), odo_next=at(data.odom, t + 1))
        x_opt = _pose_solve(prob, flat((x_prev + x_next) / 2.0), w, config,
                            True).view(x_prev.shape)
        x_t = torch.where(empty[..., None], (xt_run + x_next) / 2.0, x_opt)
        state = _where_map(empty, state, new_state)
        x_all[..., t, :] = x_t
        xt_run = x_t

    t = T - 1
    empty = ~data.mask[..., t, :].any(dim=-1)
    new_state, matched = assoc_frame(state, x_all[..., t, :], t)
    x_prev = x_all[..., t - 1, :]
    z3 = torch.zeros((math.prod(lead), 3), dtype=dtype, device=dev)
    prob = PoseProblem(
        dist=at(data.dist, t), ang=ang, mask=at(data.mask, t),
        matched=flat(matched), x_prev=flat(x_prev), u_prev=at(data.u, t - 1),
        odo_prev=at(data.odom, t - 1), odo_cur=at(data.odom, t), x_next=z3,
        u_cur=z3[:, :2], odo_next=z3)
    x_one = _pose_solve(
        prob, model.kinematics(flat(x_prev), at(data.u, t - 1),
                               config.deltat), w, config,
        False).view(x_prev.shape)
    # an empty last frame dead-reckons from the running pose (the
    # reference would index past the end, ICM_ROS.py:144)
    x_t = torch.where(empty[..., None], (xt_run + x_all[..., t, :]) / 2.0,
                      x_one)
    state = _where_map(empty, state, new_state)
    x_all[..., t, :] = x_t

    empty0 = ~data.mask[..., 0, :].any(dim=-1)
    return (_where_map(empty0, old_map, state),
            torch.where(empty0[..., None, None], x, x_all))


# ---------------------------------------------------------------------------
# batched (Picard) init sweep — ICM iteration 0
# ---------------------------------------------------------------------------

def _se2_scan(th, tx, ty, anc):
    """Inclusive segmented SE(2) composition scan along the last axis,
    log-step (Hillis-Steele).

    Element i composes all elements from the last anchored one up to i;
    an anchored element resets the prefix.  Same operator as the JAX
    ``associative_scan``; the composition order differs, so results agree
    to rounding.
    """
    n = th.shape[-1]
    off = 1
    while off < n:
        tha, txa, tya, aa = (a[..., :-off] for a in (th, tx, ty, anc))
        thb, txb, tyb, ab = (a[..., off:] for a in (th, tx, ty, anc))
        ca, sa = torch.cos(tha), torch.sin(tha)
        th_n = torch.where(ab, thb, tha + thb)
        tx_n = torch.where(ab, txb, txa + ca * txb - sa * tyb)
        ty_n = torch.where(ab, tyb, tya + sa * txb + ca * tyb)
        th = torch.cat([th[..., :off], th_n], dim=-1)
        tx = torch.cat([tx[..., :off], tx_n], dim=-1)
        ty = torch.cat([ty[..., :off], ty_n], dim=-1)
        anc = torch.cat([anc[..., :off], aa | ab], dim=-1)
        off *= 2
    return th, tx, ty


def _rechain(xs, x_prev_stale, x_last, keep_abs=None):
    """Re-compose each world's chunk of poses (W, C, 3) from its carried
    anchor ``x_last`` (W, 3).

    Frames flagged ``keep_abs`` (W, C) keep their absolute pose and
    re-anchor the chain; the others contribute their pose relative to the
    stale predecessor (``icm_slam_tpu.solver.sweeps.init_sweep_batched``).
    """
    W, C = xs.shape[:2]
    dth = xs[..., 2] - x_prev_stale[..., 2]
    dx = xs[..., 0] - x_prev_stale[..., 0]
    dy = xs[..., 1] - x_prev_stale[..., 1]
    c = torch.cos(x_prev_stale[..., 2])
    sn = torch.sin(x_prev_stale[..., 2])
    rx = c * dx + sn * dy
    ry = -sn * dx + c * dy

    th = torch.cat([x_last[:, 2:3], dth], dim=1)
    px = torch.cat([x_last[:, 0:1], rx], dim=1)
    py = torch.cat([x_last[:, 1:2], ry], dim=1)
    if keep_abs is None:
        anc = (torch.arange(C + 1, device=xs.device) == 0).expand(W, C + 1)
    else:
        anc = torch.cat([torch.ones((W, 1), dtype=torch.bool,
                                    device=xs.device), keep_abs], dim=1)
    th = torch.where(anc, torch.cat([x_last[:, 2:3], xs[..., 2]], dim=1), th)
    px = torch.where(anc, torch.cat([x_last[:, 0:1], xs[..., 0]], dim=1), px)
    py = torch.where(anc, torch.cat([x_last[:, 1:2], xs[..., 1]], dim=1), py)
    th, px, py = _se2_scan(th, px, py, anc)
    return torch.stack([px, py, th], dim=-1)[:, 1:]


def _flat(a, lead: int = 2):
    """``a`` with its first ``lead`` axes (worlds, frames) merged into the
    problem axis P that the LM solver and the energy hooks take; with
    ``lead`` 0, one problem (P = 1)."""
    return a.reshape((-1,) + a.shape[lead:])


class _InitChunk(NamedTuple):
    """One chunk's frames of every world (W, C, ...), or all nc chunks of
    them (W, nc, C, ...): frames 1..T-1 padded with empty frames to a
    multiple of C."""
    dist: torch.Tensor
    mask: torch.Tensor
    ang: torch.Tensor
    odom: torch.Tensor
    u_prev: torch.Tensor
    odom_prev: torch.Tensor


class _InitCarry(NamedTuple):
    """What a chunk of the batched init hands the next: the table's sums
    and counts (W, L), its allocated-label count (W,), the last pose
    (W, 3)."""
    sx: torch.Tensor
    sy: torch.Tensor
    cnt: torch.Tensor
    nact: torch.Tensor
    x_last: torch.Tensor


def _init_chunk(inp: _InitChunk, carry: _InitCarry, config, w):
    """One chunk of the batched init (``icm_slam_tpu.solver.sweeps.
    init_sweep_batched``'s scan body): R Picard rounds of association
    against the carried table and LM solves, then the final map-build.
    Returns (the next carry, the chunk's poses (W, C, 3)).  No host read."""
    dist_c, mask_c, ang_c, odom_c, u_prev_c, odom_prev_c = inp
    base_sx, base_sy, base_cnt, nact, x_last = carry
    W, C, B = dist_c.shape
    L = base_sx.shape[-1]
    dtype, dev = x_last.dtype, x_last.device
    dist_thr = config.dist_thr
    model = _model_of(config)
    R = max(1, int(config.init_rounds))
    iters = config.init_gn_iters or config.pose_gn_iters
    z3 = torch.zeros((W, C, 3), dtype=dtype, device=dev)
    z2 = torch.zeros((W * C, 2), dtype=dtype, device=dev)
    empty = ~mask_c.any(dim=-1)                               # (W, C)

    def kinematics(xx, uu):
        """The model's g over the chunk's W * C poses, as (W, C, 3)."""
        return model.kinematics(_flat(xx), _flat(uu),
                                config.deltat).view(xx.shape)

    def assoc_pass(pts, pts_prev, lab_prev):
        """One causal association round + anchored matched targets."""
        wgt = (lab_prev < L).to(dtype)
        sx, sy, cnt = _frame_sums(pts_prev[..., 0], pts_prev[..., 1],
                                  lab_prev, wgt, L)           # (W, C, L)
        # EXCLUSIVE prefix along each world's frames: the table as each
        # frame sees it
        csx = base_sx[:, None] + torch.cumsum(sx, 1) - sx
        csy = base_sy[:, None] + torch.cumsum(sy, 1) - sy
        ccn = base_cnt[:, None] + torch.cumsum(cnt, 1) - cnt
        ex = csx / torch.clamp(ccn, min=1.0)
        ey = csy / torch.clamp(ccn, min=1.0)
        live = ccn > 0
        dx = pts[..., 0:1] - ex[:, :, None, :]                # (W, C, B, L)
        dy = pts[..., 1:2] - ey[:, :, None, :]
        d2 = torch.where(live[:, :, None, :], dx * dx + dy * dy,
                         float("inf"))
        min2, lab = d2.min(dim=-1)
        lab = lab.to(torch.int32)
        far = (min2 > dist_thr * dist_thr) & mask_c
        lab = torch.where(mask_c, lab, L)
        # quirk (ICM_SLAM.py:176): one shared new label per far frame,
        # numbered along the frames of its own world
        has_far = far.any(dim=-1)                             # (W, C)
        new_id = nact[:, None] + torch.cumsum(has_far, 1,
                                              dtype=torch.int32) - 1
        lab = torch.where(far, torch.clamp(new_id[..., None], max=L), lab)
        n_new = has_far.sum(dim=1).to(torch.int32)            # (W,)

        wgt_c = (lab < L).to(dtype)
        osx, osy, ocn = _frame_sums(pts[..., 0], pts[..., 1], lab, wgt_c, L)
        rx = (csx + osx) / torch.clamp(ccn + ocn, min=1.0)
        ry = (csy + osy) / torch.clamp(ccn + ocn, min=1.0)
        lab_cl = torch.clamp(lab, 0, L - 1).long()
        matched = torch.stack([torch.gather(rx, -1, lab_cl),
                               torch.gather(ry, -1, lab_cl)], dim=-1)
        # far beams match their own frame's far-cluster mean
        ox = torch.gather(osx, -1, lab_cl)
        oy = torch.gather(osy, -1, lab_cl)
        oc = torch.clamp(torch.gather(ocn, -1, lab_cl), min=1.0)
        matched = torch.where(far[..., None],
                              torch.stack([ox / oc, oy / oc], dim=-1),
                              matched)
        fx = base_sx + osx.sum(dim=1)
        fy = base_sy + osy.sum(dim=1)
        fc = base_cnt + ocn.sum(dim=1)
        return lab, n_new, matched, fx, fy, fc

    def solve_round(x_prev_arr, xp, matched):
        prob = PoseProblem(
            dist=_flat(dist_c), ang=_flat(ang_c), mask=_flat(mask_c),
            matched=_flat(matched), x_prev=_flat(x_prev_arr),
            u_prev=_flat(u_prev_c), odo_prev=_flat(odom_prev_c),
            odo_cur=_flat(odom_c), x_next=_flat(z3), u_cur=z2,
            odo_next=_flat(z3))
        xs = _pose_solve(prob, _flat(xp), w, config, False,
                         iters=iters).view(W, C, 3)
        # empty frames take the pure kinematic increment; solved frames
        # keep their absolute pose
        xs = torch.where(empty[..., None], xp, xs)
        return _rechain(xs, x_prev_arr, x_last, keep_abs=~empty)

    # round 0: chain the measured odometry increments from the anchor
    dth0 = odom_c[..., 2] - odom_prev_c[..., 2]
    dwx = odom_c[..., 0] - odom_prev_c[..., 0]
    dwy = odom_c[..., 1] - odom_prev_c[..., 1]
    c0 = torch.cos(odom_prev_c[..., 2])
    s0 = torch.sin(odom_prev_c[..., 2])
    rel0 = torch.stack([c0 * dwx + s0 * dwy, -s0 * dwx + c0 * dwy, dth0],
                       dim=-1)
    x = _rechain(rel0, z3, x_last)
    lab = torch.full((W, C, B), L, dtype=torch.int32, device=dev)
    pts_prev = torch.zeros((W, C, B, 2), dtype=dtype, device=dev)
    for _ in range(R):
        x_prev_arr = torch.cat([x_last[:, None], x[:, :-1]], dim=1)
        xp = kinematics(x_prev_arr, u_prev_c)
        pts = beams_to_world(xp, dist_c, ang_c)
        lab, n_new, matched, fx, fy, fc = assoc_pass(pts, pts_prev, lab)
        pts_prev = pts
        x = solve_round(x_prev_arr, xp, matched)

    if config.init_final_assoc:
        # final map-build from the converged poses (no solves)
        x_prev_arr = torch.cat([x_last[:, None], x[:, :-1]], dim=1)
        xp = kinematics(x_prev_arr, u_prev_c)
        pts = beams_to_world(xp, dist_c, ang_c)
        lab, n_new, _, fx, fy, fc = assoc_pass(pts, pts_prev, lab)
    return _InitCarry(fx, fy, fc, nact + n_new, x[:, -1]), x


class BatchedInit:
    """The batched init of a fleet (``data``, ``seed`` with the world
    axis, ``x0`` (W, 3)) as nc steps of one chunk over fixed buffers (the
    JAX ``lax.scan`` over chunks): ``step`` reads its frames from the
    padded (W, nc, C, ...) inputs at a chunk counter on the device and
    writes its poses into a (W, nc, C, 3) tensor, so every step has the
    same shapes and no host read, and one step captured in a CUDA graph
    can be replayed for the others.  ``start`` is the state before the
    first chunk, ``finish`` the result from the carry after the last."""

    def __init__(self, data: SweepData, seed: MapState, x0, config, w):
        cap = config.obs_cap or 0
        if cap and cap < data.dist.shape[-1]:
            data = compact_data(data, cap)
        else:
            data = _per_frame_ang(data)
        W, T = data.dist.shape[:2]
        C = max(2, int(config.init_chunk_len))
        n = T - 1
        self.nc = nc = -(-n // C)
        pad = nc * C - n

        def pad_c(a):
            z = torch.zeros((W, pad) + a.shape[2:], dtype=a.dtype,
                            device=a.device)
            return torch.cat([a, z], dim=1).reshape((W, nc, C) + a.shape[2:])

        # frames 1..T-1 of every world, padded with empty frames
        self.chunks = _InitChunk(
            pad_c(data.dist[:, 1:]), pad_c(data.mask[:, 1:]),
            pad_c(data.ang[:, 1:]), pad_c(data.odom[:, 1:]),
            pad_c(data.u[:, :n]), pad_c(data.odom[:, :n]))
        self.xs = x0.new_zeros((W, nc, C, 3))
        self.x0, self.T, self.config, self.w = x0, T, config, w
        self.start = (
            _InitCarry(seed.pos[..., 0] * seed.counts,
                       seed.pos[..., 1] * seed.counts, seed.counts,
                       seed.nact, x0),
            torch.zeros((1,), dtype=torch.long, device=x0.device))

    def step(self, carry: _InitCarry, ci):
        """Chunk ``ci`` ((1,) int64 on the device) from ``carry``; its
        poses go to ``xs[:, ci]``.  Returns (the next carry, ci + 1)."""
        inp = _InitChunk(*(a.index_select(1, ci).squeeze(1)
                           for a in self.chunks))
        carry, x = _init_chunk(inp, carry, self.config, self.w)
        self.xs.index_copy_(1, ci, x[:, None])
        return carry, ci + 1

    def finish(self, carry: _InitCarry):
        """(merged map_state, poses (W, T, 3), raw_nact (W,)) from the
        carry after the last chunk: the duplicate merge, once."""
        W = self.x0.shape[0]
        x = torch.cat([self.x0[:, None],
                       self.xs.reshape(W, -1, 3)[:, :self.T - 1]], dim=1)
        base_sx, base_sy, base_cnt, nact, _ = carry
        live = base_cnt > 0
        pos = (torch.stack([base_sx, base_sy], dim=-1)
               / torch.clamp(base_cnt, min=1.0)[..., None] * live[..., None])
        # merge duplicate columns without pruning (cota = 0); the raw
        # allocated-label count is returned as the overflow witness
        merged = filter_map(MapState(pos, base_cnt, nact), 0.0,
                            self.config.dist_thr,
                            live_cap=resolve_init_merge_cap(self.config))
        return merged, x, nact


def init_sweep_batched(data: SweepData, seed: MapState, x0, config, w,
                       timings=None
                       ) -> Tuple[MapState, torch.Tensor, torch.Tensor]:
    """Causal init (ICM_ROS.py:47-119) as a chunked-Picard sweep.

    Returns (merged map_state, poses (T, 3), raw_nact), ``raw_nact`` being
    the pre-merge allocated-label count (the table-overflow witness).  See
    ``icm_slam_tpu.solver.sweeps.init_sweep_batched`` for the algorithm.
    A fleet (``x0`` (W, 3), ``data`` and ``seed`` with the world axis)
    solves the W * C poses of a chunk in one LM batch, returns (W, T, 3)
    poses and (W,) counts, and merges the W tables in one ``filter_map``.

    The chunks are ``BatchedInit`` steps.  On a CUDA device with the
    default model the first chunk runs eagerly, one chunk is captured in a
    CUDA graph (``solver.cuda_graph.CapturedStep``) and replayed for the
    other nc - 1: the counterpart of JAX's compiled ``_init_jit``, bitwise
    the eager chunks (the same kernels in the same order).  A capture that
    fails raises.  Its seconds go to ``timings["init_capture_s"]`` when
    given (0 without a capture).  Elsewhere the steps run in a Python
    loop.
    """
    if x0.dim() == 1:
        state, x, nact = init_sweep_batched(
            with_world_axis(data), with_world_axis(seed), x0[None], config,
            w, timings)
        return world(state), x[0], nact[0]
    run = BatchedInit(data, seed, x0, config, w)
    graphed = x0.is_cuda and config.model is None
    captured = None
    if timings is not None:
        timings["init_capture_s"] = 0.0
    state = run.start
    for k in range(run.nc):
        if k == 0 or not graphed:
            state = run.step(*state)
            continue
        if captured is None:
            t0 = time.perf_counter()
            captured = CapturedStep(run.step, *state)
            if timings is not None:
                timings["init_capture_s"] = time.perf_counter() - t0
        captured.replay()
    if captured is not None:
        state = captured.state
    return run.finish(state[0])


# ---------------------------------------------------------------------------
# batched refinement sweep
# ---------------------------------------------------------------------------

def batched_associate(data: SweepData, old_map: MapState, x, config,
                      mesh=None):
    """Associate every frame against the frozen map in one batched pass.

    ``data`` has per-frame (T, B) ``ang``.  Returns (labels (T, B) int32
    in [0, L] with L = discard, map_after (MapState), matched (T, B, 2)
    running-mean values).  With an active ``map_run_cap`` only the first
    cap columns are searched (run() guarantees the live count stays below
    it).  On the quirk path that search is the fused association + sums
    kernel, with the gate in the d^2 form; otherwise the nearest-landmark
    kernel searches the columns and the gate compares the distance.  A
    fleet (``x`` (W, T, 3), ``data`` and ``old_map`` with the world axis)
    is one kernel launch for all W worlds.

    On a time mesh (``mesh``, ``parallel.mesh.make_mesh``) ``data`` and
    ``x`` are this rank's block of frames (``shard_sweep_inputs``): the
    labels and running means are the block's, numbered and summed after
    every earlier frame on every earlier rank, and the map is the whole
    trajectory's, the same on every rank.
    """
    if x.dim() == 2:
        lab, final, matched = batched_associate(
            with_world_axis(data), with_world_axis(old_map), x[None], config,
            mesh)
        return lab[0], world(final), matched[0]
    blk = _time_block(mesh, x.shape[1])
    L = old_map.pos.shape[-2]
    dist_thr = config.dist_thr
    cap_l = config.map_run_cap if 0 < config.map_run_cap < L else 0

    pts = beams_to_world(x, data.dist, data.ang)             # (W, T, B, 2)
    if not config.replicate_new_obs_quirk:
        return _associate_components(data, old_map, pts, config,
                                     cap_l or L, blk)
    if cap_l:
        lab_n, d2min, sums = associate_and_sums(
            pts, old_map.pos[:, :cap_l], data.mask, old_map.nact, dist_thr)
        lab = torch.where(d2min > dist_thr * dist_thr, -1, lab_n)
    else:
        lab_n, min_dist = nearest_landmark(pts, old_map.pos, old_map.nact)
        lab = torch.where(min_dist > dist_thr, -1, lab_n)
    lab = torch.where(data.mask, lab, L)

    far = lab == -1
    has_far = far.any(dim=-1)                                 # (W, T)
    # frame t's new label = nact0 + (#frames of its world before t that
    # spawned one)
    spawned, n_new = _frame_scan(has_far, blk, torch.int32)
    new_id = old_map.nact[:, None] + spawned - 1
    lab = torch.where(far, new_id[..., None], lab)
    if cap_l:
        final, matched = _running_means_capped(
            pts, data.mask, lab, far, has_far, new_id, sums, old_map, n_new,
            cap_l, blk)
    else:
        final, matched = _running_means_full(pts, lab, old_map, n_new, blk)
    return lab, final, matched


def _time_block(mesh, T: int):
    """This rank's ``parallel.mesh.TimeBlock`` of T frames on a time mesh;
    None without one."""
    if mesh is None:
        return None
    from icm_slam_tpu_torch.parallel.mesh import TimeBlock
    return TimeBlock(mesh, T)


def _frame_scan(a, blk, dtype=None):
    """The inclusive cumulative sum of ``a`` (W, T, ...) along the frames
    and its total over all frames (W, ...).  On a time mesh (``blk``) the
    frames of the earlier ranks come first: their sum is added to the
    block's, and the total is every rank's, summed in rank order."""
    c = torch.cumsum(a, dim=1, dtype=dtype)
    if blk is None:
        return c, c[:, -1]
    pre, total = blk.scan(c[:, -1])
    return (c if pre is None else c + pre.unsqueeze(1)), total


def _associate_components(data: SweepData, old_map: MapState, pts, config,
                          Lr, blk=None):
    """The non-quirk branch of ``batched_associate``: far beams of each
    frame split into connected components at dist_thr, labelled from
    ``nact + cumsum(k) - k`` (k = the frame's component count, summed
    along its world's frames); the association searches the first ``Lr``
    columns, gated on the distance
    (``icm_slam_tpu.solver.sweeps.batched_associate``, :650-658 and
    :779-793)."""
    L = old_map.pos.shape[-2]
    B = pts.shape[-2]
    lab_n, min_dist = nearest_landmark(pts, old_map.pos[:, :Lr],
                                       old_map.nact)
    lab = torch.where(min_dist > config.dist_thr, -1, lab_n)
    lab = torch.where(data.mask, lab, L)
    far = lab == -1
    fm = far & data.mask
    comp = compact_labels(
        connected_component_labels(pts, fm, config.dist_thr), fm, B)
    k = torch.where(fm.any(dim=-1),
                    torch.where(fm, comp, -1).amax(dim=-1) + 1, 0)
    ck, n_new = _frame_scan(k, blk, torch.int32)
    base = old_map.nact[:, None] + ck - k
    lab = torch.where(far, base[..., None] + comp, lab)
    final, matched = _running_means_full(pts, lab, old_map, n_new, blk)
    return lab, final, matched


def _running_means_capped(pts, mask, lab, far, has_far, new_id, sums,
                          old_map, n_new, cap_l, blk=None):
    """Running means from the kernel's per-frame old-landmark sums.

    A new landmark only receives observations from its creating frame, so
    its running mean is that frame's far-beam mean; old labels are < cap_l.
    On a time mesh each new column is one rank's frame: every rank's
    frames are gathered and written in global order.
    """
    W, L = old_map.counts.shape
    dtype, dev = pts.dtype, pts.device
    far_w = (far & mask).to(dtype)                            # (W, T, B)
    fcnt = far_w.sum(dim=-1)                                  # (W, T)
    fmean = torch.stack([(pts[..., 0] * far_w).sum(dim=-1),
                         (pts[..., 1] * far_w).sum(dim=-1)], dim=-1) \
        / torch.clamp(fcnt, min=1.0)[..., None]               # (W, T, 2)

    cums, total = _frame_scan(sums, blk)          # (W, T, 3, cap), (W, 3, cap)
    cum_cnt = cums[:, :, 2]
    denom = torch.clamp(cum_cnt, min=1.0)
    run_x = cums[:, :, 0] / denom
    run_y = cums[:, :, 1] / denom

    lab_c = torch.clamp(lab, 0, cap_l - 1).long()
    matched = torch.stack([torch.gather(run_x, -1, lab_c),
                           torch.gather(run_y, -1, lab_c)], dim=-1)
    matched = torch.where(far[..., None], fmean[..., None, :], matched)

    # final table: old columns from the cumulative sums, new columns from
    # the per-frame far means; row L is the discard row
    live_last = total[:, 2] > 0
    denom_last = torch.clamp(total[:, 2], min=1.0)
    pos = torch.zeros((W, L + 1, 2), dtype=dtype, device=dev)
    pos[:, :cap_l] = torch.stack([total[:, 0] / denom_last,
                                  total[:, 1] / denom_last], dim=-1) \
        * live_last[..., None]
    counts = torch.zeros((W, L + 1), dtype=dtype, device=dev)
    counts[:, :cap_l] = total[:, 2]
    new_row = torch.clamp(torch.where(has_far, new_id, L), 0, L)
    if blk is not None:
        # the ids (< 2^24) travel with the means as float32
        every = blk.frames(torch.cat([fmean, fcnt[..., None],
                                      new_row[..., None].to(dtype)], -1))
        fmean, fcnt, new_row = (every[..., :2], every[..., 2],
                                every[..., 3].to(new_row.dtype))
    # each world's rows L + 1 apart in the flat table: one index a frame
    scatter_id = (new_row.long()
                  + torch.arange(W, device=dev)[:, None] * (L + 1))
    pos.view(-1, 2)[scatter_id.reshape(-1)] = fmean.reshape(-1, 2)
    counts.view(-1)[scatter_id.reshape(-1)] = fcnt.reshape(-1)
    return MapState(pos[:, :L], counts[:, :L], old_map.nact + n_new), matched


def _running_means_full(pts, lab, old_map, n_new, blk=None):
    """Running means over all L columns by per-frame segment sums."""
    L = old_map.pos.shape[-2]
    w = (lab < L).to(pts.dtype)
    sx, sy, cnts = _frame_sums(pts[..., 0], pts[..., 1], lab, w, L)
    cum_cnt, total_cnt = _frame_scan(cnts, blk)               # (W, T, L)
    cum_sx, total_sx = _frame_scan(sx, blk)
    cum_sy, total_sy = _frame_scan(sy, blk)
    denom = torch.clamp(cum_cnt, min=1.0)
    run_x = cum_sx / denom
    run_y = cum_sy / denom
    lab_c = torch.clamp(lab, 0, L - 1).long()
    matched = torch.stack([torch.gather(run_x, -1, lab_c),
                           torch.gather(run_y, -1, lab_c)], dim=-1)
    live_last = total_cnt > 0
    denom_last = torch.clamp(total_cnt, min=1.0)
    final_pos = torch.stack([total_sx / denom_last, total_sy / denom_last],
                            dim=-1) * live_last[..., None]
    return MapState(final_pos, total_cnt, old_map.nact + n_new), matched


class _Neighbours(NamedTuple):
    """Where a sweep reads the neighbours t - 1 and t + 1 of its frames:
    ``x``, ``u`` and ``odom`` (W, T, ...) themselves, or on a time mesh
    (``halo``) the block's arrays between the neighbour ranks' edge frames
    (``parallel.mesh.TimeBlock.halo``), local frame j at j + 1.  ``start``
    is the global index of local frame 0, ``total`` the global frame
    count."""
    x: torch.Tensor
    u: torch.Tensor
    odom: torch.Tensor
    start: int
    total: int
    halo: bool = False

    def at(self, g):
        """Indices into ``x``, ``u``, ``odom`` of the global frames ``g``
        (a tensor, or an int); a frame outside the halo reads its edge."""
        if not self.halo:
            return g
        top = self.x.shape[1] - 1
        if isinstance(g, int):
            return min(max(g + 1 - self.start, 0), top)
        return torch.clamp(g + (1 - self.start), 0, top)


def _solve_two_at(data: SweepData, x, obs, config, w, ts, last_t=None,
                  nb: _Neighbours = None):
    """Two-sided LM solves for the poses ``ts`` (K,) of every world, as one
    batch of W * K problems; returns (W, K, 3).

    With ``last_t`` the last real frame is solved with the one-sided cost
    folded into the batch: zeroing the 6 forward rows of its residual (and
    of the analytic Jacobian) leaves exactly the one-sided system, and its
    start point is the kinematic prediction (ICM_ROS.py:153-156, 254-260).
    That needs the default [forward (6), one-sided] stacking; without
    ``last_t`` every pose takes the plain two-sided cost.  ``nb`` says
    where the neighbours are read (a time mesh's halo; ``x`` itself
    without), and ``last_t`` is a global frame index.
    """
    W, T = x.shape[:2]
    if nb is None:
        nb = _Neighbours(x, data.u, data.odom, 0, T)
    model = _model_of(config)
    dist_c, ang_c, mask_c, matched_c = obs
    gts = ts if nb.start == 0 else ts + nb.start
    tm1 = nb.at(torch.clamp(gts - 1, min=0))
    tp1 = nb.at(torch.clamp(gts + 1, max=nb.total - 1))

    def at(a, i):
        return _flat(a[:, i])

    prob = PoseProblem(
        dist=at(dist_c, ts), ang=at(ang_c, ts), mask=at(mask_c, ts),
        matched=at(matched_c, ts), x_prev=at(nb.x, tm1),
        u_prev=at(nb.u, tm1), odo_prev=at(nb.odom, tm1),
        odo_cur=at(data.odom, ts), x_next=at(nb.x, tp1), u_cur=at(data.u, ts),
        odo_next=at(nb.odom, tp1))
    x_init = (prob.x_prev + prob.x_next) / 2.0
    if last_t is None:
        return _pose_solve(prob, x_init, w, config, True).view(W, -1, 3)
    is_last = (gts == last_t).repeat(W)
    x_init = torch.where(
        is_last[:, None],
        model.kinematics(prob.x_prev, prob.u_prev, config.deltat), x_init)
    return _pose_solve(prob, x_init, w, config, True,
                       fold=is_last).view(W, -1, 3)


def _solve_one_at(data: SweepData, x, obs, config, w, t: int,
                  nb: _Neighbours = None):
    """One-sided LM solves (W, 3) of frame ``t`` (the trajectory's last) of
    every world from its kinematic prediction, against the current ``x``;
    given one world ((T, 3) poses), its solve (3,).  ``t`` is global; on a
    time mesh (``nb``) the rank that holds it calls this."""
    if x.dim() == 2:
        return _solve_one_at(with_world_axis(data), x[None],
                             tuple(a[None] for a in obs), config, w, t)[0]
    if nb is None:
        nb = _Neighbours(x, data.u, data.odom, 0, x.shape[1])
    dist_c, ang_c, mask_c, matched_c = obs
    W = x.shape[0]
    j = t - nb.start
    tm1 = nb.at(max(t - 1, 0))
    z3 = torch.zeros((W, 3), dtype=x.dtype, device=x.device)
    prob = PoseProblem(
        dist=dist_c[:, j], ang=ang_c[:, j], mask=mask_c[:, j],
        matched=matched_c[:, j], x_prev=nb.x[:, tm1], u_prev=nb.u[:, tm1],
        odo_prev=nb.odom[:, tm1], odo_cur=data.odom[:, j], x_next=z3,
        u_cur=z3[:, :2], odo_next=z3)
    x_init = _model_of(config).kinematics(nb.x[:, tm1], nb.u[:, tm1],
                                          config.deltat)
    return _pose_solve(prob, x_init, w, config, False)


def refine_sweep_batched(data: SweepData, old_map: MapState, x, config, w,
                         last_t: int | None = None, mesh=None
                         ) -> Tuple[MapState, torch.Tensor]:
    """One ICM sweep: batched association, then ``pose_passes`` red-black
    half-pass pairs or, with ``pose_update="jacobi"``, full Jacobi passes
    (every pose against the previous pass's neighbours).

    The last real frame ``last_t`` rides the batch (``_solve_two_at``)
    unless the model replaces or extends the two-sided cost; then it is
    solved on its own and written into its slot of the batch.  A fleet
    (``x`` (W, T, 3), ``data`` and ``old_map`` with the world axis) solves
    every world's poses of a half-pass in one LM batch.

    On a time mesh (``mesh``, ``parallel.mesh.make_mesh``) ``data`` and
    ``x`` are this rank's block of frames (``parallel.mesh.
    shard_sweep_inputs``), ``last_t`` and the red-black parity count
    global frames, and each pass first reads the neighbour ranks' edge
    poses (a halo); the rank returns the whole trajectory's map and its
    block of poses.  Without a mesh nothing crosses ranks.
    """
    if x.dim() == 2:
        final_map, x = refine_sweep_batched(
            with_world_axis(data), with_world_axis(old_map), x[None], config,
            w, last_t, mesh)
        return world(final_map), x[0]
    T = x.shape[1]
    blk = _time_block(mesh, T)
    if last_t is None:
        last_t = (T if blk is None else blk.total) - 1
    empty = ~data.mask.any(dim=-1)                            # (W, T)

    cap = config.obs_cap if config.obs_cap else data.dist.shape[-1]
    if cap < data.dist.shape[-1]:
        data_c = compact_data(data, cap)
    else:
        data_c = _per_frame_ang(data)
    _, final_map, matched = batched_associate(data_c, old_map, x, config,
                                              mesh)
    obs = (data_c.dist, data_c.ang, data_c.mask, matched)
    model = _model_of(config)
    fold_last = model.two_sided is None and model.extra_two_sided is None

    if blk is None:
        def neighbours(x):
            return _Neighbours(x, data.u, data.odom, 0, T)
    else:
        # the controls and odometry of the edge frames once a sweep, the
        # poses before every pass
        uo = blk.halo(torch.cat([data.u, data.odom], dim=-1))

        def neighbours(x):
            return _Neighbours(blk.halo(x), uo[..., :2], uo[..., 2:],
                               blk.start, blk.total, halo=True)

    def frames(start, stride):
        """The block's frames start, start + stride, ... (global numbering):
        (local indices, global indices, the first local index)."""
        s = 0 if blk is None else blk.start
        first = start - s if start >= s else (start - s) % stride
        ts = torch.arange(first, T, stride, device=x.device)
        return ts, (ts if s == 0 else ts + s), first

    def solve_at(x, sel, start, stride):
        """Solve the poses ``sel`` = ``frames(start, stride)``."""
        ts, gts, first = sel
        nb = neighbours(x)
        if ts.numel() == 0:
            return x
        cand = _solve_two_at(data, x, obs, config, w, ts,
                             last_t if fold_last else None, nb)
        if not fold_last and last_t >= start \
                and (last_t - start) % stride == 0 \
                and nb.start <= last_t < nb.start + T:
            cand[:, (last_t - nb.start - first) // stride] = _solve_one_at(
                data, x, obs, config, w, last_t, nb)
        tm1 = nb.at(torch.clamp(gts - 1, min=0))
        tp1 = nb.at(torch.clamp(gts + 1, max=last_t))
        x_avg = (nb.x[:, tm1] + nb.x[:, tp1]) / 2.0
        cand = torch.where(empty[:, ts][..., None], x_avg, cand)
        cand = torch.where((gts <= last_t)[:, None], cand, x[:, ts])
        return x.index_copy(1, ts, cand)

    if config.pose_update == "jacobi":
        every = frames(1, 1)
        for _ in range(config.pose_passes):
            x = solve_at(x, every, 1, 1)
        return final_map, x
    odd, even = frames(1, 2), frames(2, 2)
    for _ in range(config.pose_passes):
        x = solve_at(x, odd, 1, 2)
        x = solve_at(x, even, 2, 2)
    return final_map, x
