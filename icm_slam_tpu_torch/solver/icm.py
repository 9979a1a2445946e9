"""ICM outer loop: init sweep + N refinement sweeps + map filtering.

Port of ``icm_slam_tpu.solver.icm.run`` (the reference __main__ pipeline,
ICM_ROS.py:280-316): scan filtering, first-frame clustering on the host,
the init (batched Picard or the causal frame-by-frame sweep), then N
refinement sweeps (batched, sequential, or the bundle-adjustment backends
of ``models/``: ``ba`` and ``windowed_ba``), each followed by the map
filter.  The per-sweep witnesses and map changes stay on the device
during a segment of sweeps and are checked at its end, before any
observer sees the segment's state, as the fused JAX loop does.  On the
card the batched sweeps after the first are replays of one captured CUDA
graph (``refine_sweeps``), the counterpart of that fused loop.

``run_batched`` is fleet mode: W same-shape worlds through the engines at
once, on a leading world axis (the JAX package's ``vmap``), so that W
worlds cost the kernel launches of one; with a fleet mesh its worlds are
sharded over the ranks of a process group.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from icm_slam_tpu_torch.config import ICMConfig
from icm_slam_tpu_torch.core.energy import EnergyModel, weights
from icm_slam_tpu_torch.core.geometry import beam_angles, beams_to_world
from icm_slam_tpu_torch.data.datasets import Dataset
from icm_slam_tpu_torch.frontend.scan_filter import (filter_scans,
                                                     preprocess_ranges)
from icm_slam_tpu_torch.mapping.landmark_map import (MapState, empty_map,
                                                     filter_map,
                                                     seed_from_clusters)
from icm_slam_tpu_torch.solver.cuda_graph import CapturedSweep
from icm_slam_tpu_torch.solver.sweeps import (SweepData, auto_obs_cap,
                                              compact_data, init_sweep,
                                              init_sweep_batched,
                                              refine_sweep_batched,
                                              refine_sweep_sequential,
                                              resolve_init_merge_cap)


def first_frame_labels(pts: np.ndarray, dist_thr: float,
                       criterion: str = "inconsistent") -> np.ndarray:
    """Host-side hierarchical clustering of the first frame's points
    (single linkage, scipy's 'inconsistent' criterion, ICM_SLAM.py:161)."""
    if pts.shape[0] == 0:
        return np.zeros((0,), np.int32)
    if pts.shape[0] == 1:
        return np.zeros((1,), np.int32)
    from scipy.cluster.hierarchy import fcluster, linkage
    from scipy.spatial.distance import pdist
    return (fcluster(linkage(pdist(pts)), dist_thr, criterion=criterion)
            - 1).astype(np.int32)


@dataclasses.dataclass
class ICMResult:
    x_init: np.ndarray          # (T, 3) poses after iteration 0
    x: np.ndarray               # (T, 3) refined poses
    map_pos: np.ndarray         # (K, 2) live landmarks
    map_counts: np.ndarray      # (K,)
    changes: np.ndarray         # (N, 3) min/max/mean map change per iter
    timings: dict


def check_supported(config: ICMConfig) -> None:
    """Raise TypeError on a ``model`` that is not the port's EnergyModel
    (the JAX package's hooks are JAX code; the JAX ``run`` fails on a model
    without its hooks too)."""
    if config.model is not None and not isinstance(config.model,
                                                   EnergyModel):
        raise TypeError(f"config.model must be an icm_slam_tpu_torch "
                        f"EnergyModel, got {type(config.model).__name__}")


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without CUDA raises
    (the port never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but "
                           f"torch.cuda.is_available() is False")
    return device


def resolve_config(config: ICMConfig, data) -> ICMConfig:
    """Data-dependent config resolution + safety guards.

    As ``icm_slam_tpu.solver.icm.resolve_config``: an explicit ``obs_cap``
    below the dataset's largest per-frame valid count is an error in every
    mode; ``obs_cap`` 0 resolves to that count in the batched modes only
    (the sequential engines associate on all beams); ``map_run_cap`` is
    dropped when the provable live bound total_obs / cota reaches it, and
    otherwise shrinks to the tightest 128-aligned width above that bound.
    """
    if config.obs_cap:
        cap_needed = auto_obs_cap(data.mask)
        if config.obs_cap < cap_needed:
            raise ValueError(
                f"obs_cap={config.obs_cap} is below this dataset's max "
                f"per-frame valid-beam count ({cap_needed}); beam "
                f"compaction would silently drop real observations. "
                f"Use obs_cap=0 (auto) or >= {cap_needed}.")
    elif config.sweep_mode in ("batched", "windowed_ba", "ba"):
        config = dataclasses.replace(config, obs_cap=auto_obs_cap(data.mask))
    if config.map_run_cap and config.map_run_cap_checked:
        if config.map_run_cap >= config.L:
            config = dataclasses.replace(config, map_run_cap=0)
    elif config.map_run_cap:
        live_bound = float(data.mask.sum()) / max(config.cota, 1.0)
        if live_bound + 1 >= config.map_run_cap:
            config = dataclasses.replace(config, map_run_cap=0)
        else:
            align = 128
            tight = max(align, -(-int(live_bound + 2) // align) * align)
            if tight < config.map_run_cap:
                config = dataclasses.replace(config, map_run_cap=tight)
    return config


def check_table_overflow(raw_nact, L: int, where: str = "sweep") -> None:
    """Raise if a sweep allocated labels past the table capacity L."""
    n = int(raw_nact)
    if n > L:
        raise RuntimeError(
            f"landmark table overflow in {where}: {n} labels allocated "
            f"but the table holds L={L}. Observations past the capacity "
            f"were silently discarded; rerun with a larger config.L "
            f"(or a higher cota / dist_thr to create fewer landmarks).")


def kept_count(state: MapState, cota) -> torch.Tensor:
    """Landmarks that survive the cota prune (pre-merge), on the device;
    (W,) for a fleet's maps."""
    L = state.pos.shape[-2]
    live = torch.arange(L, device=state.pos.device) < state.nact[..., None]
    return (live & (state.counts >= cota)).sum(dim=-1).to(torch.int32)


def check_witness(witness, config: ICMConfig, where: str = "sweep",
                  init_merge_cap: int = 0) -> None:
    """Host-side validation of a [raw_nact, kept_count] witness."""
    w = np.asarray(witness)
    check_table_overflow(w[0], config.L, where)
    if init_merge_cap and int(w[0]) > init_merge_cap:
        raise RuntimeError(
            f"cap-sliced init merge violated in {where}: {int(w[0])} labels "
            f"were allocated but the duplicate merge only covered the "
            f"first init_merge_cap={init_merge_cap} columns. Rerun with "
            f"init_merge_cap=0 (full-width merge) or a larger cap.")
    cap = config.map_run_cap
    if cap and int(w[1]) >= cap:
        raise RuntimeError(
            f"map_run_cap violated in {where}: {int(w[1])} landmarks "
            f"survive the cota prune but the fast paths only track "
            f"map_run_cap={cap} columns. Rerun with a larger map_run_cap "
            f"or map_run_cap=0 (exact full-width paths).")


def prepare(dataset: Dataset, config: ICMConfig, device) -> SweepData:
    """Preprocess + batch-filter the whole dataset on ``device``."""
    dtype = getattr(torch, config.dtype)
    scans = torch.as_tensor(np.asarray(dataset.scans), device=device).to(
        dtype)
    ranges = preprocess_ranges(scans, config.rango_laser_max, config.radio)
    dist, mask = filter_scans(ranges, config.rango_laser_max,
                              config.dist_thr, dataset.n_beams,
                              config.beam_step_deg, config.beam0_deg)
    ang = beam_angles(dataset.n_beams, config.beam_step_deg,
                      config.beam0_deg, dtype, device=device)
    return SweepData(
        dist=dist, mask=mask, ang=ang,
        odom=torch.as_tensor(np.asarray(dataset.odom), device=device).to(
            dtype),
        u=torch.as_tensor(np.asarray(dataset.u), device=device).to(dtype))


def seed_map(data: SweepData, x0, config: ICMConfig) -> MapState:
    """Cluster frame 0 on the host and seed the landmark table."""
    if data.ang.dim() != 1:
        raise ValueError("seed_map needs raw SweepData (1-D beam angles), "
                         "not the output of hoist_compaction")
    dev, dtype = data.dist.device, data.dist.dtype
    pts = beams_to_world(x0, data.dist[0], data.ang).cpu().numpy()
    mask0 = data.mask[0].cpu().numpy()
    pts_valid = pts[mask0]
    if pts_valid.shape[0] == 0:
        return empty_map(config.L, dtype, dev)
    labels = first_frame_labels(pts_valid, config.dist_thr)
    return seed_from_clusters(config.L, pts_valid, labels, dtype, dev)


def use_batched_init(config: ICMConfig) -> bool:
    """Iteration-0 engine choice: the batched Picard init needs the
    one-new-label-per-frame quirk and the default model; the sequential
    sweep mode, or ``init_mode="sequential"``, takes the causal sweep."""
    if config.init_mode == "sequential":
        return False
    if config.init_mode == "batched":
        return True
    return (config.sweep_mode != "sequential"
            and config.replicate_new_obs_quirk and config.model is None)


def _init_merge_cap(config: ICMConfig) -> int:
    """The init-witness merge cap to enforce: nonzero only when the batched
    init ran and its final duplicate merge was cap-sliced."""
    return resolve_init_merge_cap(config) if use_batched_init(config) else 0


def _init(data: SweepData, seed: MapState, x0, config: ICMConfig, w):
    """Iteration 0. Returns (map_state, poses (T, 3), raw_nact), or a
    fleet's (W, T, 3) poses and (W,) counts."""
    if use_batched_init(config):
        return init_sweep_batched(data, seed, x0, config, w)
    return init_sweep(data, seed, x0, config, w)


def _refine_step(data: SweepData, old_map: MapState, x, config: ICMConfig,
                 w):
    """One refinement sweep + map filtering.

    Returns (filtered map, poses, witness): witness = int32 [raw pre-filter
    live count, kept-after-prune count], validated by check_witness; a
    fleet's sweep (world axis W) returns (W, 2) witnesses.
    """
    if config.sweep_mode == "sequential":
        state, x = refine_sweep_sequential(data, old_map, x, config, w)
    elif config.sweep_mode == "ba":
        from icm_slam_tpu_torch.models.bundle_adjustment import ba_refine
        state, x = ba_refine(data, old_map, x, config, w,
                             gn_iters=config.ba_gn_iters,
                             cg_iters=config.ba_cg_iters)
    elif config.sweep_mode == "windowed_ba":
        from icm_slam_tpu_torch.models.windowed_ba import windowed_ba_refine
        state, x = windowed_ba_refine(data, old_map, x, config, w,
                                      window=config.ba_window)
    else:
        state, x = refine_sweep_batched(data, old_map, x, config, w)
    filtered = filter_map(state, config.cota, config.dist_thr,
                          live_cap=config.map_run_cap)
    witness = torch.stack([state.nact.to(torch.int32),
                           kept_count(state, config.cota)], dim=-1)
    return filtered, x, witness


def _compaction_cap(data: SweepData, config: ICMConfig) -> int:
    """Beam-compaction budget when it applies to ``data``, else 0: the
    sequential sweep keeps the shared 1-D beam angles, and compacted data
    (B == cap) is left as it is."""
    if config.sweep_mode == "sequential":
        return 0
    cap = config.obs_cap or 0
    return cap if cap and cap < data.dist.shape[-1] else 0


def hoist_compaction(data: SweepData, config: ICMConfig) -> SweepData:
    """Compact beams once for the batched refinement sweeps (loop-invariant).

    The result has per-frame (T, cap) ``ang``; seed_map and the init need
    the raw data.
    """
    cap = _compaction_cap(data, config)
    return compact_data(data, cap) if cap else data


def uses_graph(config: ICMConfig, device: torch.device) -> bool:
    """Whether ``refine_sweeps`` replays the sweeps from a CUDA graph: on
    a CUDA device, for the batched sweep with the default model.  The
    sequential, ``ba`` and ``windowed_ba`` sweeps and a model's hooks run
    eagerly; so does a time mesh's sweep (``refine_sweep_batched(...,
    mesh=)``, which no loop here runs)."""
    return (device.type == "cuda" and config.sweep_mode == "batched"
            and config.model is None)


def refine_sweeps(data: SweepData, cur_map: MapState, x, config: ICMConfig,
                  w, n_iters: int, change: bool = False, timings=None):
    """``n_iters`` refinement sweeps; yields (cur_map, x, witness, change)
    after each (change: ``map_change`` against the sweep's input map, or
    None without ``change``).  Nothing waits for the device.

    Where ``uses_graph``, the first sweep runs eagerly and the others are
    replays of one CUDA graph that captures a sweep (``_refine_step`` and
    the change) after it: the port's counterpart of JAX's fused
    ``_refine_loop_jit``.  The yielded map and poses are then the graph's
    static buffers, which the next replay overwrites (the witness and the
    change are copies); ``data`` and ``w`` stay in place meanwhile.  A
    capture that fails raises: the card never falls back to eager sweeps.
    The capture's seconds go to ``timings["capture_s"]`` when given (0
    without a capture).
    """
    def sweep(cur_map, x):
        new_map, x, wit = _refine_step(data, cur_map, x, config, w)
        return new_map, x, wit, (map_change(new_map, cur_map,
                                            live_cap=config.map_run_cap)
                                 if change else None)

    graphed, graph = uses_graph(config, x.device), None
    timings = {} if timings is None else timings
    timings["capture_s"] = 0.0
    for k in range(n_iters):
        if k == 0 or not graphed:
            cur_map, x, wit, chg = sweep(cur_map, x)
            yield cur_map, x, wit, chg
            continue
        if graph is None:
            t0 = time.perf_counter()
            graph = CapturedSweep(sweep, cur_map, x)
            timings["capture_s"] = time.perf_counter() - t0
        graph.replay()
        wit, chg = graph.outs
        yield (graph.map, graph.x, wit.clone(),
               None if chg is None else chg.clone())


def refine_loop(data: SweepData, cur_map: MapState, x, config: ICMConfig, w,
                n_iters: int, stride: int = 0, first: int = 0,
                on_segment=None, timings=None):
    """``n_iters`` refinement sweeps (``refine_sweeps``) in segments of
    ``stride`` sweeps (0: one segment).  At the end of each segment its
    witnesses are checked on the host, then ``on_segment(k, cur_map, x)``
    fires on copies of the state, with k the index of the segment's last
    sweep (sweeps are numbered from ``first``).

    Returns (cur_map, x, changes (n_iters, 3) NumPy).  Within a segment
    nothing waits for the device; ``timings`` gets ``capture_s``.
    """
    stride = stride if stride > 0 else max(n_iters, 1)
    sweeps = refine_sweeps(data, cur_map, x, config, w, n_iters, change=True,
                           timings=timings)
    changes = []
    k = first
    while k < first + n_iters:
        seg = min(stride, first + n_iters - k)
        wits, chgs = [], []
        for _ in range(seg):
            cur_map, x, wit, chg = next(sweeps)
            wits.append(wit)
            chgs.append(chg)
        for j, wv in enumerate(torch.stack(wits).cpu().numpy()):
            check_witness(wv, config, f"refinement sweep {k + j}")
        changes.append(torch.stack(chgs).cpu().numpy())
        k += seg
        if on_segment is not None:
            on_segment(k - 1, MapState(*(a.clone() for a in cur_map)),
                       x.clone())
    changes = (np.concatenate(changes) if changes
               else np.zeros((0, 3), np.float32))
    return cur_map, x, changes


def map_change(new_map: MapState, old_map: MapState, live_cap: int = 0):
    """min/max/mean nearest-landmark displacement (ICM_SLAM.py:490-495),
    zeros when either map is empty; on the first ``live_cap`` rows.
    Returns (3,), or (W, 3) for a fleet's maps."""
    L = new_map.pos.shape[-2]
    K = live_cap if 0 < live_cap < L else L
    idx = torch.arange(K, device=new_map.pos.device)
    live_new = idx < new_map.nact[..., None]
    live_old = idx < old_map.nact[..., None]
    d = torch.linalg.vector_norm(
        old_map.pos[..., :K, None, :] - new_map.pos[..., None, :K, :],
        dim=-1)
    d = torch.where(live_old[..., :, None] & live_new[..., None, :], d,
                    float("inf"))
    md = d.amin(dim=-2)
    mn = torch.where(live_new, md, float("inf")).amin(dim=-1)
    mx = torch.where(live_new, md, float("-inf")).amax(dim=-1)
    mean = (torch.where(live_new, md, 0.0).sum(dim=-1)
            / torch.clamp(live_new.sum(dim=-1), min=1))
    stats = torch.stack([mn, mx, mean], dim=-1).to(d.dtype)
    empty = (new_map.nact == 0) | (old_map.nact == 0)
    return torch.where(empty[..., None], torch.zeros_like(stats), stats)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(dataset: Dataset, config: ICMConfig, device,
        n_iters: Optional[int] = None, verbose: bool = False,
        callback=None, on_init=None, callback_stride: int = 1) -> ICMResult:
    """Full pipeline on ``device``: init + N ICM iterations.

    ``on_init(x_init)`` fires right after the init (before any
    refinement).  ``callback(k, cur_map, x)`` fires after sweep k, or,
    with ``callback_stride`` > 1, only at the end of each segment of that
    many sweeps (k = the segment's last sweep); the witnesses of the
    sweeps before it are checked first.  ``verbose`` prints one line per
    sweep (and makes the callback fire every sweep).  Observers read the
    device, so each costs a host sync.
    """
    check_supported(config)
    device = resolve_device(device)
    n_iters = config.N if n_iters is None else n_iters
    timings = {}

    t0 = time.perf_counter()
    data = prepare(dataset, config, device)
    config = resolve_config(config, data)
    x0 = torch.as_tensor(np.asarray(dataset.x0), device=device).to(
        data.dist.dtype)
    seed = seed_map(data, x0, config)
    w = weights(config, device)
    _sync(device)
    timings["prepare_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    state, x, raw_nact = _init(data, seed, x0, config, w)
    cur_map = filter_map(state, config.cota, config.dist_thr,
                         live_cap=config.map_run_cap)
    _sync(device)
    timings["init_s"] = time.perf_counter() - t0
    check_witness(torch.stack([raw_nact.to(torch.int32),
                               kept_count(state, config.cota)]).cpu(),
                  config, "init sweep",
                  init_merge_cap=_init_merge_cap(config))
    x_init = x.cpu().numpy()
    if on_init is not None:
        on_init(x_init)

    t0 = time.perf_counter()
    data = hoist_compaction(data, config)
    _sync(device)
    timings["hoist_s"] = time.perf_counter() - t0

    def observe(k, cur_map, x):
        if callback is not None:
            callback(k, cur_map, x)
        if verbose:
            corr = float(torch.linalg.vector_norm(
                x.cpu() - torch.from_numpy(x_init), dim=1).sum())
            print(f"[icm] iter {k + 1}/{n_iters} "
                  f"landmarks={int(cur_map.nact)} correction={corr:.4f}",
                  flush=True)

    t0 = time.perf_counter()
    if verbose:
        stride = 1
    elif callback is not None:
        stride = max(int(callback_stride), 1)
    else:
        stride = 0
    cur_map, x, changes = refine_loop(
        data, cur_map, x, config, w, n_iters, stride=stride,
        on_segment=observe if (callback is not None or verbose) else None,
        timings=timings)
    _sync(device)
    timings["refine_s"] = time.perf_counter() - t0
    timings["refine_per_iter_s"] = timings["refine_s"] / max(n_iters, 1)

    nact = int(cur_map.nact)
    return ICMResult(
        x_init=x_init, x=x.cpu().numpy(),
        map_pos=cur_map.pos[:nact].cpu().numpy(),
        map_counts=cur_map.counts[:nact].cpu().numpy(),
        changes=changes, timings=timings)


# ---------------------------------------------------------------------------
# fleet mode: W worlds through the engines at once
# ---------------------------------------------------------------------------

def resolve_fleet_config(config: ICMConfig, datas) -> ICMConfig:
    """Merge the per-world data-dependent resolutions into one config.

    As ``icm_slam_tpu.solver.icm.resolve_fleet_config``: the widest beam
    cap of any world; the association cap only if every world proves one
    (else 0), marked checked, so that ``run(world, merged)`` keeps the
    merged width.  A world's fleet result reproduces ``run(world,
    merged)``, not ``run(world, config)``: the caps set the f32 reduction
    widths.
    """
    shapes = {tuple(d.dist.shape) for d in datas}
    if len(shapes) != 1:
        raise ValueError(f"run_batched needs identical dataset shapes; "
                         f"got {sorted(shapes)}")
    resolved = [resolve_config(config, d) for d in datas]
    obs_cap = max(r.obs_cap for r in resolved)
    caps = [r.map_run_cap for r in resolved]
    run_cap = 0 if any(c == 0 for c in caps) else max(caps)
    return dataclasses.replace(resolved[0], obs_cap=obs_cap,
                               map_run_cap=run_cap,
                               map_run_cap_checked=run_cap > 0)


def _stack(items):
    """One SweepData or MapState with a leading world axis from W of them."""
    return type(items[0])(*(torch.stack(f) for f in zip(*items)))


def prepare_fleet(datasets, config: ICMConfig, device, worlds=None):
    """Prepare and seed each world on the host, then stack them: returns
    (data, seed, x0, merged config, weights), data and seed with a leading
    world axis W and x0 (W, 3), all on ``device``, as the batched engine
    takes a fleet.  ``worlds`` (indices into ``datasets``, repeats allowed)
    stacks only those; the config is merged over every world."""
    datas = [prepare(ds, config, device) for ds in datasets]
    config = resolve_fleet_config(config, datas)
    if worlds is not None:
        datasets = [datasets[i] for i in worlds]
        datas = [datas[i] for i in worlds]
    dtype = datas[0].dist.dtype
    x0 = torch.stack([torch.as_tensor(np.asarray(ds.x0), device=device).to(
        dtype) for ds in datasets])
    seed = _stack([seed_map(d, x, config) for d, x in zip(datas, x0)])
    return _stack(datas), seed, x0, config, weights(config, device)


def run_batched(datasets, config: ICMConfig, device,
                n_iters: Optional[int] = None, mesh=None) -> list:
    """The full pipeline on W same-shape worlds at once, on ``device``.

    Port of ``icm_slam_tpu.solver.icm.run_batched``: each world is
    prepared and seeded on the host, then the worlds are stacked and the
    init (batched or causal, as ``run()`` picks it), the map filter and
    the N refinement sweeps (any ``sweep_mode``) run once on the stack
    (``solver.sweeps`` and ``models`` on a leading world axis): the
    kernels see W worlds in one launch, and one LM batch solves every
    world's poses, a frame at a time in the causal engines.  The init's
    and every sweep's witnesses are checked per world after the run,
    naming the world.  Returns one ``ICMResult`` per world (``changes``
    empty), each with the shared timings ``prepare_s``, ``init_s``,
    ``hoist_s``, ``refine_s`` (with ``capture_s``, ``refine_sweeps``'s
    CUDA-graph capture), ``refine_per_iter_s``, ``pipeline_s`` (init to
    the last sweep) and ``per_world_s``.

    Every world has the same (T, n_beams) shape and runs under the merged
    config of ``resolve_fleet_config``.

    ``mesh``: a fleet mesh (``parallel.mesh.make_fleet_mesh``) shards the
    worlds over its ranks.  Every rank calls this with all W worlds and
    merges the config over all of them; W is padded to a multiple of the
    mesh size by repeating the last world, and rank r runs the r-th block
    through the engine above on its own (worlds exchange nothing).  Then
    the per-world outputs go to every rank, one ``all_gather`` each, the
    padded worlds are dropped, and every rank checks every world's
    witnesses and returns the whole list (a world's result is the
    unsharded fleet's, bit for bit); the init, hoist and refine timings
    are the rank's own, and ``pipeline_s`` ends after the gather.
    """
    if not datasets:
        return []
    check_supported(config)
    device = resolve_device(device)
    n_iters = config.N if n_iters is None else n_iters
    W = len(datasets)
    timings = {}

    worlds = None
    if mesh is not None:
        from icm_slam_tpu_torch.parallel.mesh import FLEET_AXIS, check_axis
        check_axis(mesh, FLEET_AXIS)
        if mesh.device_type != device.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot run a fleet "
                             f"on {device}")
        per = -(-W // mesh.size())
        r = mesh.get_local_rank()
        worlds = [min(i, W - 1) for i in range(r * per, (r + 1) * per)]
    t0 = time.perf_counter()
    data, seed, x0, config, w = prepare_fleet(datasets, config, device,
                                              worlds)
    _sync(device)
    timings["prepare_s"] = time.perf_counter() - t0

    t_pipe = t0 = time.perf_counter()
    state, x, raw_nact = _init(data, seed, x0, config, w)
    init_wit = torch.stack([raw_nact.to(torch.int32),
                            kept_count(state, config.cota)], dim=-1)
    cur_map = filter_map(state, config.cota, config.dist_thr,
                         live_cap=config.map_run_cap)
    x_init = x
    _sync(device)
    timings["init_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    data = hoist_compaction(data, config)
    _sync(device)
    timings["hoist_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    wits = []
    for cur_map, x, wit, _ in refine_sweeps(data, cur_map, x, config, w,
                                            n_iters, timings=timings):
        wits.append(wit)
    _sync(device)
    timings["refine_s"] = time.perf_counter() - t0
    timings["refine_per_iter_s"] = timings["refine_s"] / max(n_iters, 1)

    wits = (torch.stack(wits, dim=1) if wits
            else init_wit.new_zeros((init_wit.shape[0], 0, 2)))
    out = [x_init, x, cur_map.pos, cur_map.counts, cur_map.nact, init_wit,
           wits]
    if mesh is not None:
        from icm_slam_tpu_torch.parallel.mesh import gather_blocks
        out = [gather_blocks(mesh, a)[:W] if a.numel() else
               a.new_zeros((W,) + tuple(a.shape[1:])) for a in out]
        _sync(device)
    timings["pipeline_s"] = time.perf_counter() - t_pipe
    timings["per_world_s"] = timings["pipeline_s"] / W

    x_init, x, pos, counts, nacts, init_wit, wits = (a.cpu().numpy()
                                                     for a in out)
    merge_cap = _init_merge_cap(config)
    results = []
    for wdx in range(W):
        check_witness(init_wit[wdx], config, f"init sweep (world {wdx})",
                      init_merge_cap=merge_cap)
        for k in range(n_iters):
            check_witness(wits[wdx, k], config,
                          f"refinement sweep {k} (world {wdx})")
        nact = int(nacts[wdx])
        results.append(ICMResult(
            x_init=x_init[wdx], x=x[wdx], map_pos=pos[wdx, :nact],
            map_counts=counts[wdx, :nact], changes=np.zeros((0, 3)),
            timings=dict(timings)))
    return results
