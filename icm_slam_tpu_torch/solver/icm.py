"""ICM outer loop: init sweep + N refinement sweeps + map filtering.

Port of ``icm_slam_tpu.solver.icm.run`` on the default batched engine
(the reference __main__ pipeline, ICM_ROS.py:280-316): scan filtering,
first-frame clustering on the host, the batched Picard init, then N
refinement sweeps, each followed by the map filter.  The per-sweep
witnesses and map changes stay on the device during the loop and are
checked once after it, as the fused JAX loop does.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from icm_slam_tpu_torch.config import ICMConfig
from icm_slam_tpu_torch.core.energy import weights
from icm_slam_tpu_torch.core.geometry import beam_angles, beams_to_world
from icm_slam_tpu_torch.data.datasets import Dataset
from icm_slam_tpu_torch.frontend.scan_filter import (filter_scans,
                                                     preprocess_ranges)
from icm_slam_tpu_torch.mapping.landmark_map import (MapState, empty_map,
                                                     filter_map,
                                                     seed_from_clusters)
from icm_slam_tpu_torch.solver.sweeps import (SweepData, auto_obs_cap,
                                              compact_data,
                                              init_sweep_batched,
                                              refine_sweep_batched,
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
    """Raise NotImplementedError on configurations the port does not run."""
    unsupported = [
        (config.model is not None, "custom EnergyModel hooks (model)"),
        (config.sweep_mode != "batched",
         f"sweep_mode={config.sweep_mode!r}"),
        (not config.replicate_new_obs_quirk, "replicate_new_obs_quirk=False"),
        (config.init_mode == "sequential", "init_mode='sequential'"),
        (config.pose_update != "redblack",
         f"pose_update={config.pose_update!r}"),
    ]
    for bad, what in unsupported:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported; only the default batched engine is")


def resolve_config(config: ICMConfig, data) -> ICMConfig:
    """Data-dependent config resolution + safety guards.

    As ``icm_slam_tpu.solver.icm.resolve_config``: ``obs_cap`` 0 resolves
    to the dataset's largest per-frame valid count (a smaller explicit
    value is an error); ``map_run_cap`` is dropped when the provable live
    bound total_obs / cota reaches it, and otherwise shrinks to the
    tightest 128-aligned width above that bound.
    """
    if config.obs_cap:
        cap_needed = auto_obs_cap(data.mask)
        if config.obs_cap < cap_needed:
            raise ValueError(
                f"obs_cap={config.obs_cap} is below this dataset's max "
                f"per-frame valid-beam count ({cap_needed}); beam "
                f"compaction would silently drop real observations. "
                f"Use obs_cap=0 (auto) or >= {cap_needed}.")
    else:
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
    """Landmarks that survive the cota prune (pre-merge), on the device."""
    L = state.pos.shape[0]
    live = torch.arange(L, device=state.pos.device) < state.nact
    return (live & (state.counts >= cota)).sum().to(torch.int32)


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


def _refine_step(data: SweepData, old_map: MapState, x, config: ICMConfig,
                 w):
    """One refinement sweep + map filtering.

    Returns (filtered map, poses, witness): witness = int32 [raw pre-filter
    live count, kept-after-prune count], validated by check_witness.
    """
    state, x = refine_sweep_batched(data, old_map, x, config, w)
    filtered = filter_map(state, config.cota, config.dist_thr,
                          live_cap=config.map_run_cap)
    witness = torch.stack([state.nact.to(torch.int32),
                           kept_count(state, config.cota)])
    return filtered, x, witness


def hoist_compaction(data: SweepData, config: ICMConfig) -> SweepData:
    """Compact beams once for the refinement sweeps (loop-invariant).

    The result has per-frame (T, cap) ``ang``; seed_map and the init need
    the raw data.
    """
    cap = config.obs_cap or 0
    return compact_data(data, cap) if 0 < cap < data.dist.shape[1] else data


def map_change(new_map: MapState, old_map: MapState, live_cap: int = 0):
    """min/max/mean nearest-landmark displacement (ICM_SLAM.py:490-495),
    zeros when either map is empty; on the first ``live_cap`` rows."""
    L = new_map.pos.shape[0]
    K = live_cap if 0 < live_cap < L else L
    idx = torch.arange(K, device=new_map.pos.device)
    live_new = idx < new_map.nact
    live_old = idx < old_map.nact
    d = torch.linalg.vector_norm(
        old_map.pos[:K, None, :] - new_map.pos[None, :K, :], dim=-1)
    d = torch.where(live_old[:, None] & live_new[None, :], d, float("inf"))
    md = d.min(dim=0).values
    mn = torch.where(live_new, md, float("inf")).min()
    mx = torch.where(live_new, md, float("-inf")).max()
    mean = (torch.where(live_new, md, 0.0).sum()
            / torch.clamp(live_new.sum(), min=1))
    stats = torch.stack([mn, mx, mean]).to(d.dtype)
    empty = (new_map.nact == 0) | (old_map.nact == 0)
    return torch.where(empty, torch.zeros_like(stats), stats)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(dataset: Dataset, config: ICMConfig, device,
        n_iters: Optional[int] = None, verbose: bool = False,
        callback=None) -> ICMResult:
    """Full pipeline on ``device``: init + N ICM iterations.

    ``callback(k, cur_map, x)`` fires after every sweep k (after its
    witness is checked); ``verbose`` prints one line per sweep.  Both read
    the device, so they cost a host sync per sweep.
    """
    check_supported(config)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but "
                           f"torch.cuda.is_available() is False")
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
    state, x, raw_nact = init_sweep_batched(data, seed, x0, config, w)
    cur_map = filter_map(state, config.cota, config.dist_thr,
                         live_cap=config.map_run_cap)
    _sync(device)
    timings["init_s"] = time.perf_counter() - t0
    check_witness(torch.stack([raw_nact.to(torch.int32),
                               kept_count(state, config.cota)]).cpu(),
                  config, "init sweep",
                  init_merge_cap=resolve_init_merge_cap(config))
    x_init = x.cpu().numpy()

    t0 = time.perf_counter()
    data = hoist_compaction(data, config)
    _sync(device)
    timings["hoist_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    witnesses, changes = [], []
    for k in range(n_iters):
        prev_map = cur_map
        cur_map, x, witness = _refine_step(data, prev_map, x, config, w)
        changes.append(map_change(cur_map, prev_map,
                                  live_cap=config.map_run_cap))
        witnesses.append(witness)
        if callback is not None or verbose:
            check_witness(witness.cpu(), config, f"refinement sweep {k}")
        if callback is not None:
            callback(k, cur_map, x)
        if verbose:
            corr = float(torch.linalg.vector_norm(
                x.cpu() - torch.from_numpy(x_init), dim=1).sum())
            print(f"[icm] iter {k + 1}/{n_iters} "
                  f"landmarks={int(cur_map.nact)} correction={corr:.4f}",
                  flush=True)
    _sync(device)
    timings["refine_s"] = time.perf_counter() - t0
    timings["refine_per_iter_s"] = timings["refine_s"] / max(n_iters, 1)
    if n_iters:
        witnesses = torch.stack(witnesses).cpu().numpy()
        changes = torch.stack(changes).cpu().numpy()
    else:
        changes = np.zeros((0, 3), np.float32)
    for k, wv in enumerate(witnesses):
        check_witness(wv, config, f"refinement sweep {k}")

    nact = int(cur_map.nact)
    return ICMResult(
        x_init=x_init, x=x.cpu().numpy(),
        map_pos=cur_map.pos[:nact].cpu().numpy(),
        map_counts=cur_map.counts[:nact].cpu().numpy(),
        changes=changes, timings=timings)
