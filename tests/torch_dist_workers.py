"""Multi-rank runs of the port on gloo CPU processes, for the
``tests/test_torch_parallel*.py`` files.

The tests spawn n ranks (``spawn``), each a fresh interpreter that imports
this module (never JAX, never tests/conftest.py), runs one worker function
at one torch thread, and pickles what it found to a file of its own; the
test process reads every rank's file and holds the results against the
unsharded port and JAX.  A group that does not finish within its timeout
is killed and fails the test.
"""
import os
import pickle
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# the inputs both sides build: the fleets, and time-axis sweeps in the
# five configurations of refine_sweep_batched on tests/test_sharding.py's
# world and config ("t67": it sees two landmarks and spawns none), on a
# world whose frames spawn landmarks on every rank ("t120", L=256: 20
# live after one sweep) and on one of nine frames padded to 16 ("t9": at
# two and four ranks its last frame opens a block, and at four the last
# rank holds only padding)
FLEET_SEEDS = (7, 10, 11, 12)
SHARD_CONFIG = dict(N=1, L=64, cota=3.0, dtype="float32", pose_gn_iters=4,
                    pose_passes=1)
SWEEP_CASES = {"k2": {}, "k1": dict(L=256, map_run_cap=128),
               "nonquirk": dict(replicate_new_obs_quirk=False),
               "jacobi": dict(pose_update="jacobi"), "hook": {}}
SWEEP_WORLDS = {"t67": (dict(T=67, n_landmarks=8, seed=0), {}, None),
                "t120": (dict(T=120, n_landmarks=10, seed=10),
                         dict(L=256), None),
                "t9": (dict(T=9, n_landmarks=4, seed=3), dict(L=256), 16)}


def spawn(target, n, tmp_path, *args, timeout=120.0):
    """``target(rank, n, init_file, *args)`` on ``n`` spawned ranks; returns
    each rank's return value, in rank order.  A rank that raises fails the
    call with its traceback; a group still running after ``timeout``
    seconds is killed and raises TimeoutError."""
    tmp = str(tmp_path)
    init = os.path.join(tmp, f"init_{target.__name__}_{n}")
    ctx = mp.start_processes(_entry, args=(target, n, init, tmp, args),
                             nprocs=n, start_method="spawn", join=False)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{target.__name__} on {n} ranks did not "
                                   f"finish within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    out = []
    for r in range(n):
        with open(os.path.join(tmp, f"{target.__name__}_{n}_{r}.pkl"),
                  "rb") as f:
            out.append(pickle.load(f))
    return out


def _entry(rank, target, n, init, tmp, args):
    torch.set_num_threads(1)
    res = target(rank, n, init, *args)
    if dist.is_initialized():
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"{target.__name__}_{n}_{rank}.pkl"),
              "wb") as f:
        pickle.dump(res, f)


def join_gloo(rank, n, init):
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            world_size=n, rank=rank)


# --- the bring-up -----------------------------------------------------------

def initialize_worker(rank, n, init, port):
    """``initialize`` by explicit arguments on even ranks and by the
    environment on odd ones (as tools/dryrun_multiprocess.py alternates
    them), then one gather over the global mesh."""
    from icm_slam_tpu_torch.parallel import distributed as pd
    from icm_slam_tpu_torch.parallel.mesh import gather_blocks
    if rank % 2 == 0:
        pd.initialize(f"localhost:{port}", n, rank, device="cpu")
    else:
        os.environ.update(ICM_COORDINATOR=f"localhost:{port}",
                          ICM_NUM_PROCESSES=str(n), ICM_PROCESS_ID=str(rank))
        pd.initialize(device="cpu")
    mesh = pd.global_mesh(device="cpu")
    got = gather_blocks(mesh, torch.tensor([rank * 10], dtype=torch.int32))
    return dict(rank=dist.get_rank(), world=dist.get_world_size(),
                backend=dist.get_backend(), primary=pd.is_primary(),
                mesh=(mesh.mesh_dim_names, mesh.size(),
                      mesh.get_local_rank()),
                gathered=got.tolist())


# --- fleet and time meshes ------------------------------------------------

def fleet_worlds(k, T=120, n_landmarks=10):
    from icm_slam_tpu_torch.data.datasets import synthetic_world
    return [synthetic_world(T=T, n_landmarks=n_landmarks, seed=s)
            for s in FLEET_SEEDS[:k]]


def fleet_config(**kw):
    from icm_slam_tpu_torch.config import ICMConfig
    return ICMConfig(**{**dict(L=256, cota=5.0, N=2), **kw})


FLEET_CASES = {
    # name: (worlds, config, ranks it runs on)
    "w4": (lambda: fleet_worlds(4), lambda: fleet_config(), (1, 2, 4)),
    "w3": (lambda: fleet_worlds(3), lambda: fleet_config(), (2,)),
    "sequential": (lambda: fleet_worlds(2, T=60),
                   lambda: fleet_config(N=1, sweep_mode="sequential"), (2,)),
}


def overflow_worlds():
    from icm_slam_tpu_torch.data.datasets import synthetic_world
    return [synthetic_world(T=60, n_landmarks=4, seed=0),
            synthetic_world(T=60, n_landmarks=40, seed=1)]


def hook_model():
    """A model that extends the two-sided cost, so the last frame's
    one-sided solve runs on its own (on the rank that holds it)."""
    from icm_slam_tpu_torch.core.energy import EnergyModel
    return EnergyModel(extra_two_sided=lambda x, p: 5.0 * (
        x[:, :2] - p.odo_cur[:, :2]))


def sweep_config(case, world="t67"):
    from icm_slam_tpu_torch.config import ICMConfig
    cfg = ICMConfig(**{**SHARD_CONFIG, **SWEEP_WORLDS[world][1],
                       **SWEEP_CASES[case]})
    if case == "hook":
        import dataclasses
        cfg = dataclasses.replace(cfg, model=hook_model())
    return cfg


def sweep_inputs(world="t67", T=None):
    """tests/test_sharding.py's inputs in the port: the prepared world, its
    frame-0 seed map and the odometry as the poses."""
    from icm_slam_tpu_torch.data.datasets import synthetic_world
    from icm_slam_tpu_torch.solver import icm
    kw = SWEEP_WORLDS[world][0]
    ds = synthetic_world(**{**kw, "T": T or kw["T"]})
    cfg = sweep_config("k2", world)
    data = icm.prepare(ds, cfg, "cpu")
    x0 = torch.as_tensor(ds.x0).float()
    return data, icm.seed_map(data, x0, cfg), torch.as_tensor(ds.odom).float()


def sweep_sharded(mesh, world, case, data, seed, x):
    """One time-sharded sweep and its map filter; every rank's gathered
    poses and its map."""
    from icm_slam_tpu_torch.core.energy import weights
    from icm_slam_tpu_torch.mapping.landmark_map import filter_map
    from icm_slam_tpu_torch.parallel.mesh import (gather_time_sharded,
                                                  shard_sweep_inputs)
    from icm_slam_tpu_torch.solver.sweeps import refine_sweep_batched
    cfg = sweep_config(case, world)
    d, xs, T = shard_sweep_inputs(mesh, data, x, SWEEP_WORLDS[world][2])
    st, xs = refine_sweep_batched(d, seed, xs, cfg, weights(cfg, "cpu"),
                                  last_t=T - 1, mesh=mesh)
    fm = filter_map(st, cfg.cota, cfg.dist_thr)
    return dict(x=gather_time_sharded(mesh, xs, T).numpy(),
                state=tuple(a.numpy() for a in st),
                filtered=tuple(a.numpy() for a in fm), block=xs.shape[0])


def fleet_worker(rank, n, init):
    """Every fleet case of this rank count on one group, the overflow
    case, and a put_fleet_sharded block."""
    from icm_slam_tpu_torch.parallel import mesh as pm
    from icm_slam_tpu_torch.solver.icm import run_batched
    join_gloo(rank, n, init)
    out = {}
    fmesh = pm.make_fleet_mesh(device="cpu")
    for name, (worlds, cfg, ranks) in FLEET_CASES.items():
        if n in ranks:
            res = run_batched(worlds(), cfg(), "cpu", mesh=fmesh)
            out[f"fleet_{name}"] = [dict(x_init=r.x_init, x=r.x,
                                         map_pos=r.map_pos,
                                         map_counts=r.map_counts,
                                         timings=r.timings) for r in res]
    try:
        run_batched(overflow_worlds(), fleet_config(L=24, cota=2.0, N=1),
                    "cpu", mesh=fmesh)
        out["overflow"] = None
    except RuntimeError as e:
        out["overflow"] = str(e)
    blocks = pm.put_fleet_sharded(fmesh, {"a": torch.arange(8 * 3).view(
        8, 3)})
    out["fleet_block"] = blocks["a"].numpy()
    out["mesh"] = (fmesh.mesh_dim_names, fmesh.size(), fmesh.get_local_rank())
    try:
        pm.make_fleet_mesh(n + 1, device="cpu")
        out["wrong_size"] = None
    except ValueError as e:
        out["wrong_size"] = str(e)
    try:
        run_batched(fleet_worlds(1, T=20), fleet_config(N=1), "cpu",
                    mesh=pm.make_mesh(device="cpu"))
        out["wrong_axis"] = None
    except ValueError as e:
        out["wrong_axis"] = str(e)
    return out


def time_worker(rank, n, init):
    """Every time-mesh sweep of this rank count on one group, and
    shard_sweep_inputs' padding on tests/test_sharding.py's T=61."""
    from icm_slam_tpu_torch.parallel import mesh as pm
    join_gloo(rank, n, init)
    out = {}
    tmesh = pm.make_mesh(device="cpu")
    for world in SWEEP_WORLDS:
        data, seed, x = sweep_inputs(world)
        for case in SWEEP_CASES:
            out[f"sweep_{world}_{case}"] = sweep_sharded(tmesh, world, case,
                                                         data, seed, x)
    d61, _, x61 = sweep_inputs(T=61)
    ds, xs, T = pm.shard_sweep_inputs(tmesh, d61, x61, pad_to=8)
    out["pad61"] = dict(T=T, mask=pm.gather_blocks(tmesh, ds.mask).numpy(),
                        dist=pm.gather_blocks(tmesh, ds.dist).numpy(),
                        x=pm.gather_time_sharded(tmesh, xs, T).numpy(),
                        ang=ds.ang.numpy(), block=ds.dist.shape[0])
    return out


# --- the stage pipeline ---------------------------------------------------

PIPE_CHUNKS = (16, 64)
# seed 7 of this family is rounding-sensitive: JAX's own sweep moves 2.6e-3
# when its odometry is scaled by 1 + 1e-6 (seed 3: 9.8e-5)
PIPE_WORLD = dict(T=201, n_landmarks=12, seed=3)


def pipe_generic(mesh):
    """tests/test_pipeline.py's arithmetic pipeline: six chunks of four
    through +1, *2, -3."""
    from icm_slam_tpu_torch.parallel.pipeline import pipeline_stages
    chunks = torch.arange(24, dtype=torch.float32).view(6, 4)
    return pipeline_stages(
        mesh, [lambda c, p: {"v": p["v"] + 1.0},
               lambda c, p: {"v": p["v"] * c["scale"]},
               lambda c, p: {"v": p["v"] - 3.0}],
        lambda c, i: {"v": chunks[i]}, 6, {"scale": torch.tensor(2.0)}
    )["v"].numpy()


def pipe_inputs():
    """A small world after the port's init and map filter, uncapped
    (``map_run_cap=0``): (data, map, poses, config)."""
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.data.datasets import synthetic_world
    from icm_slam_tpu_torch.mapping.landmark_map import filter_map
    from icm_slam_tpu_torch.solver import icm
    ds = synthetic_world(**PIPE_WORLD)
    cfg = ICMConfig(N=1, L=256, cota=20.0, map_run_cap=0)
    data = icm.prepare(ds, cfg, "cpu")
    cfg = icm.resolve_config(cfg, data)
    x0 = torch.as_tensor(ds.x0).float()
    state, x, _ = icm._init(data, icm.seed_map(data, x0, cfg), x0, cfg,
                            icm.weights(cfg, "cpu"))
    cur = filter_map(state, cfg.cota, cfg.dist_thr)
    return data, cur, x, cfg


def pipeline_worker(rank, n, init):
    """The generic pipeline and ``pipelined_refine_pass`` at each chunk
    size on a 3-stage mesh."""
    from icm_slam_tpu_torch.core.energy import weights
    from icm_slam_tpu_torch.parallel.pipeline import (make_stage_mesh,
                                                      pipelined_refine_pass)
    join_gloo(rank, n, init)
    mesh = make_stage_mesh(3, device="cpu")
    out = {"generic": pipe_generic(mesh)}
    data, cur, x, cfg = pipe_inputs()
    for chunk in PIPE_CHUNKS:
        m, xx = pipelined_refine_pass(data, cur, x, cfg, weights(cfg, "cpu"),
                                      mesh, chunk=chunk)
        out[f"refine_{chunk}"] = dict(pos=m.pos.numpy(),
                                      counts=m.counts.numpy(),
                                      nact=int(m.nact), x=xx.numpy())
    return out


def one_rank_fleet_worker(rank, n, init, k):
    """``run_batched`` of ``k`` small worlds on a fleet mesh of the group
    (one rank in tests/test_torch_fleet.py)."""
    from icm_slam_tpu_torch.parallel.mesh import make_fleet_mesh
    from icm_slam_tpu_torch.solver.icm import run_batched
    join_gloo(rank, n, init)
    res = run_batched(fleet_worlds(k, T=20, n_landmarks=4),
                      fleet_config(N=1), "cpu",
                      mesh=make_fleet_mesh(device="cpu"))
    return [(r.x_init, r.x, r.map_pos, r.map_counts) for r in res]
