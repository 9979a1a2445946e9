"""Pipeline parallelism over the ranks of a process group: a GPipe stage
pipeline.

Port of ``icm_slam_tpu.parallel.pipeline``.  Each rank of a 1-D
``stage`` mesh owns one processing stage; microbatches (chunks of frames)
go from rank to rank by point-to-point sends (``batch_isend_irecv``), where
the JAX package rides a ``ppermute`` ring under ``shard_map`` and picks each
device's stage with ``lax.switch``: here each rank simply calls its own
stage function.

As in the JAX package, the time-axis mesh (``parallel.mesh``) is the
decomposition that fits this workload (every stage of the sweep is a
batched op over frames); the pipeline is the scaffold for deployments
whose stages differ (ranks dedicated to ingest-side filtering against
pose optimisation), and ``pipelined_refine_pass`` is held against the
barrier sweep.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from icm_slam_tpu_torch.parallel import mesh as pmesh

STAGE_AXIS = "stage"


def make_stage_mesh(n_stages: int, device="cuda"):
    """1-D mesh whose axis enumerates the pipeline's stages, one rank each
    (the process group must have ``n_stages`` ranks)."""
    return pmesh._mesh(STAGE_AXIS, n_stages, device)


def _wire(a):
    """``a`` as it travels: bool as uint8, contiguous."""
    return (a.to(torch.uint8) if a.dtype == torch.bool else a).contiguous()


def pipeline_stages(mesh, stage_fns: Sequence[Callable],
                    make_payload: Callable, n_chunks: int, consts,
                    extract: Callable = lambda p: p):
    """Run ``n_chunks`` microbatches through ``len(stage_fns)`` stages.

    GPipe schedule: at tick t, rank s runs ``stage_fns[s]`` on chunk t - s
    and hands its payload to rank s + 1, which takes it at tick t + 1;
    n_chunks + S - 1 ticks fill and drain the pipe.

    ``make_payload(consts, i)`` builds chunk i's first payload: a pytree
    of tensors whose structure and shapes are the same for every chunk
    (a rank receives into buffers shaped like chunk 0's).
    ``stage_fns[s](consts, payload)`` returns a payload of that structure.
    ``consts`` is whatever every stage may read; every rank passes the
    same.  Returns ``extract(payload)`` of each chunk's last-stage payload,
    stacked on a leading (n_chunks,) axis, the same on every rank (the
    last stage broadcasts it).
    """
    S, s = mesh.size(), mesh.get_local_rank()
    if len(stage_fns) != S:
        raise ValueError(f"{len(stage_fns)} stages for a {S}-rank mesh")
    group = mesh.get_group()
    template = make_payload(consts, 0)
    leaves, spec = tree_flatten(template)

    def peer(r):
        return dist.get_global_rank(group, r)

    outs, sending = [], None
    for t in range(n_chunks + S - 1):
        c = t - s
        ops, bufs = [], None
        if sending is not None:
            ops += [dist.P2POp(dist.isend, a, peer(s + 1), group)
                    for a in sending]
        if s > 0 and 0 <= c < n_chunks:
            bufs = [torch.empty_like(_wire(a)) for a in leaves]
            ops += [dist.P2POp(dist.irecv, b, peer(s - 1), group)
                    for b in bufs]
        if ops:
            pmesh.COLLECTIVES += 1
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        sending = None
        if 0 <= c < n_chunks:
            if s == 0:
                payload = make_payload(consts, c)
            else:
                payload = tree_unflatten(
                    [b.to(a.dtype) for a, b in zip(leaves, bufs)], spec)
            payload = stage_fns[s](consts, payload)
            if s == S - 1:
                outs.append(extract(payload))
            else:
                sending = [_wire(a) for a in tree_flatten(payload)[0]]

    shape = extract(template)
    if s == S - 1:
        stacked = tree_map(lambda *xs: torch.stack(xs), *outs)
    else:
        stacked = tree_map(
            lambda a: a.new_empty((n_chunks,) + tuple(a.shape)), shape)
    flat, out_spec = tree_flatten(stacked)
    wire = [_wire(a) for a in flat]
    for a in wire:
        pmesh.COLLECTIVES += 1
        dist.broadcast(a, src=peer(S - 1), group=group)
    return tree_unflatten([b.to(a.dtype) for a, b in zip(flat, wire)],
                          out_spec)


# ---------------------------------------------------------------------------
# application: the refine half-pass as a 3-stage pipeline
#   stage 0  gather    — the chunk's observations and neighbour poses
#   stage 1  optimize  — the chunk's two-sided LM pose solves, one batch
#   stage 2  finalize  — the last frame's one-sided solve (when it does not
#                        ride the batch), empty-frame averaging, keep-masking
# ---------------------------------------------------------------------------

def pipelined_refine_pass(data, old_map, x, config, w, mesh,
                          chunk: int = 64, last_t: int | None = None):
    """One ICM sweep (association + red-black poses) of one world, with the
    pose passes run as a 3-stage pipeline over chunks of frames.

    The math of ``solver.sweeps.refine_sweep_batched`` (the frames of one
    parity are independent, so chunking and pipelining change the
    schedule, not the algorithm; the LM batches are the chunks).  The last
    real frame's one-sided solve rides the batch as there; a model that
    replaces or extends the two-sided cost solves it once a chunk in the
    finalize stage and keeps it where the chunk holds that frame.  Every
    rank associates on its own and returns (the map, poses (T, 3)).
    """
    from icm_slam_tpu_torch.core.energy import PoseProblem
    from icm_slam_tpu_torch.solver.gauss_newton import lm_minimize
    from icm_slam_tpu_torch.solver.sweeps import (_model_of, _per_frame_ang,
                                                  _solve_one_at, _two_sided,
                                                  batched_associate,
                                                  compact_data)

    T = x.shape[0]
    if last_t is None:
        last_t = T - 1
    empty = ~data.mask.any(dim=1)
    model = _model_of(config)
    fold_last = model.two_sided is None and model.extra_two_sided is None
    cap = config.obs_cap if config.obs_cap else data.dist.shape[1]
    data_c = (compact_data(data, cap) if cap < data.dist.shape[1]
              else _per_frame_ang(data))
    _, final_map, matched = batched_associate(data_c, old_map, x, config)
    obs = (data_c.dist, data_c.ang, data_c.mask, matched)
    dtype, dev = x.dtype, x.device

    def half_pass(x, start):
        ts_all = torch.arange(start, T, 2, device=dev)
        K = ts_all.shape[0]
        n_chunks = -(-K // chunk)
        # pad with frame 0 (never a solve target; its write-back keeps it)
        ts_pad = torch.cat([ts_all, ts_all.new_zeros(n_chunks * chunk - K)])
        consts = dict(x=x, ts=ts_pad.view(n_chunks, chunk))

        def stage_gather(c, p):
            ts = c["ts"][p["i"]]
            tm1 = torch.clamp(ts - 1, min=0)
            tp1 = torch.clamp(ts + 1, max=T - 1)
            xx = c["x"]
            prob = PoseProblem(
                dist=obs[0][ts], ang=obs[1][ts], mask=obs[2][ts],
                matched=obs[3][ts], x_prev=xx[tm1], u_prev=data.u[tm1],
                odo_prev=data.odom[tm1], odo_cur=data.odom[ts],
                x_next=xx[tp1], u_cur=data.u[ts], odo_next=data.odom[tp1])
            x_init = (prob.x_prev + prob.x_next) / 2.0
            if fold_last:
                x_init = torch.where(
                    (ts == last_t)[:, None],
                    model.kinematics(prob.x_prev, prob.u_prev,
                                     config.deltat), x_init)
            return {**p, "ts": ts, "prob": prob, "x_init": x_init}

        def stage_optimize(c, p):
            resid2, jac2 = _two_sided(p["prob"], w, config)
            if fold_last:
                is_last = (p["ts"] == last_t)[:, None]

                def fold(v):
                    rows = is_last & (torch.arange(v.shape[1],
                                                   device=v.device) < 6)
                    return torch.where(
                        rows.view(rows.shape + (1,) * (v.dim() - 2)), 0.0, v)
                resid, jac = (lambda xx: fold(resid2(xx)),
                              lambda xx: fold(jac2(xx)))
            else:
                resid, jac = resid2, jac2
            cand = lm_minimize(resid, jac, p["x_init"],
                               iters=config.pose_gn_iters)
            return {**p, "cand": cand}

        def stage_finalize(c, p):
            ts, cand, xx = p["ts"], p["cand"], c["x"]
            if not fold_last:
                one = _solve_one_at(data_c, xx, obs, config, w, last_t)
                cand = torch.where((ts == last_t)[:, None], one[None, :],
                                   cand)
            tm1 = torch.clamp(ts - 1, min=0)
            tp1 = torch.clamp(ts + 1, max=last_t)
            cand = torch.where(empty[ts][:, None], (xx[tm1] + xx[tp1]) / 2.0,
                               cand)
            keep = (ts <= last_t) & (ts >= start)
            return {**p, "cand": torch.where(keep[:, None], cand, xx[ts])}

        def make_payload(c, i):
            def z(*shape, like=dtype):
                return torch.zeros((chunk,) + shape, dtype=like, device=dev)
            B = obs[0].shape[1]
            prob0 = PoseProblem(
                dist=z(B), ang=z(B), mask=z(B, like=torch.bool),
                matched=z(B, 2), x_prev=z(3), u_prev=z(2), odo_prev=z(3),
                odo_cur=z(3), x_next=z(3), u_cur=z(2), odo_next=z(3))
            return {"i": torch.tensor(i, device=dev),
                    "ts": z(like=ts_pad.dtype), "prob": prob0,
                    "x_init": z(3), "cand": z(3)}

        out = pipeline_stages(
            mesh, [stage_gather, stage_optimize, stage_finalize],
            make_payload, n_chunks, consts,
            extract=lambda p: {"ts": p["ts"], "cand": p["cand"]})
        return x.index_put((out["ts"].reshape(-1),),
                           out["cand"].reshape(-1, 3))

    for _ in range(config.pose_passes):
        x = half_pass(x, 1)
        x = half_pass(x, 2)
    return final_map, x
