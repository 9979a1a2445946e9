"""High-level user API on ``device``: the reference's entry points.

Port of ``icm_slam_tpu.api``:

``run_offline`` — the offline pipeline (init + N ICM iterations) on a
                  Dataset or a dataset name/path, with optional
                  checkpoint/resume and JSON-lines metrics.
``run_online``  — consume a frame stream causally, then refine offline.
``run_batched`` — fleet mode, re-exported from ``solver.icm``: W same-shape
                  worlds through the batched engine at once.

Both take reference-format YAML configs (``ICMConfig.from_yaml``).
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from icm_slam_tpu_torch.config import ICMConfig
from icm_slam_tpu_torch.core.energy import weights
from icm_slam_tpu_torch.data.datasets import Dataset, load
from icm_slam_tpu_torch.mapping.landmark_map import MapState
from icm_slam_tpu_torch.solver import icm
from icm_slam_tpu_torch.solver.icm import run_batched  # noqa: F401
from icm_slam_tpu_torch.utils import checkpoint as ckpt
from icm_slam_tpu_torch.utils.metrics import JsonlLogger, ate


def run_offline(dataset, config: Optional[ICMConfig] = None,
                device="cuda", checkpoint_dir: Optional[str] = None,
                resume: bool = False, log_path: Optional[str] = None,
                verbose: bool = False, live_plot=None,
                checkpoint_every: int = 5) -> icm.ICMResult:
    """Full offline pipeline on a Dataset (or dataset name/path).

    ``live_plot``: a ``utils.viz.LivePlot`` (or True for a default one;
    False means none), or anything with its ``update(x, landmarks,
    odom=None)``: after every sweep it gets the poses and the live
    landmarks as NumPy arrays, the reference's per-iteration graficar2
    loop (ICM_ROS.py:304,313-315).  It only reads: the result is the
    same, bit for bit, without it.

    ``checkpoint_every``: when only ``checkpoint_dir`` is set (no logger,
    no live plot), the refinement runs in segments of that many sweeps
    with a checkpoint at each segment's end; a per-sweep observer (a
    logger, from ``log_path`` or ``verbose``, or a live plot) makes the
    observer fire, and checkpoints land, after every sweep.  ``resume``
    continues from the newest checkpoint in ``checkpoint_dir`` (with no
    live plot, as in the JAX package).
    """
    if isinstance(dataset, str):
        dataset = load(dataset)
    if live_plot is True:
        from icm_slam_tpu_torch.utils.viz import LivePlot
        live_plot = LivePlot()
    elif live_plot is False:
        live_plot = None
    config = config or ICMConfig()
    logger = JsonlLogger(log_path) if (log_path or verbose) else None
    try:
        return _run_offline(dataset, config, device, checkpoint_dir, resume,
                            logger, verbose, live_plot, checkpoint_every)
    finally:
        if logger:
            logger.close()


def _observer(checkpoint_dir, logger, live_plot=None, odom=None):
    """The segment-end observer: checkpoint, log and plot sweep k's
    state."""
    def observe(k, cur_map: MapState, x):
        nact = int(cur_map.nact)
        if checkpoint_dir:
            ckpt.save(os.path.join(checkpoint_dir, f"icm_ckpt_{k}.npz"), k,
                      x.cpu().numpy(), cur_map.pos[:nact].cpu().numpy(),
                      cur_map.counts[:nact].cpu().numpy(), nact)
        if logger:
            logger.log("iteration", k=k, landmarks=nact)
        if live_plot is not None:
            live_plot.update(x.cpu().numpy(),
                             cur_map.pos[:nact].cpu().numpy(), odom=odom)
    return observe


def _run_offline(dataset, config, device, checkpoint_dir, resume, logger,
                 verbose, live_plot, checkpoint_every) -> icm.ICMResult:
    if resume and checkpoint_dir:
        path = ckpt.latest(checkpoint_dir)
        if path:
            state = ckpt.load(path)
            start_iter = int(state["iteration"]) + 1
            if logger:
                logger.log("resume", path=path, start_iter=start_iter)
            return _resume_run(dataset, config, device, state, start_iter,
                               checkpoint_dir, logger, checkpoint_every)

    # an observer only when it has work to do: without one the refinement
    # runs as one segment with one witness check at its end; a per-sweep
    # observer (logger, live plot) makes every segment one sweep
    per_sweep = bool(logger or live_plot is not None)
    needs_cb = bool(checkpoint_dir or per_sweep)
    stride = 1 if per_sweep else max(int(checkpoint_every), 1)

    def on_init(x_init):
        # the iteration-0 trajectory, persisted before any refinement, so
        # a resume after a crash still reports corrections against it
        if checkpoint_dir:
            os.makedirs(checkpoint_dir, exist_ok=True)
            np.savez_compressed(os.path.join(checkpoint_dir, "x_init.npz"),
                                x_init=x_init)

    result = icm.run(dataset, config, device, verbose=verbose,
                     callback=_observer(checkpoint_dir, logger, live_plot,
                                        dataset.odom)
                     if needs_cb else None, on_init=on_init,
                     callback_stride=stride)
    if logger:
        logger.log("done", landmarks=result.map_pos.shape[0],
                   timings=result.timings,
                   ate_vs_odom=ate(result.x, dataset.odom))
    return result


def _resume_run(dataset: Dataset, config: ICMConfig, device, state: dict,
                start_iter: int, checkpoint_dir, logger,
                checkpoint_every: int = 5) -> icm.ICMResult:
    """The remaining sweeps from a checkpoint's map and poses."""
    icm.check_supported(config)
    device = icm.resolve_device(device)
    data = icm.prepare(dataset, config, device)
    config = icm.resolve_config(config, data)
    data = icm.hoist_compaction(data, config)
    dtype = data.dist.dtype
    L = config.L
    pos = torch.zeros((L, 2), dtype=dtype, device=device)
    counts = torch.zeros((L,), dtype=dtype, device=device)
    n = state["map_pos"].shape[0]
    pos[:n] = torch.as_tensor(state["map_pos"], device=device).to(dtype)
    counts[:n] = torch.as_tensor(state["map_counts"], device=device).to(dtype)
    cur_map = MapState(pos, counts, torch.tensor(
        int(state["nact"]), dtype=torch.int32, device=device))
    x = torch.as_tensor(state["x"], device=device).to(dtype)
    x_init = state.get("x_init")
    if x_init is None and checkpoint_dir:
        init_path = os.path.join(checkpoint_dir, "x_init.npz")
        if os.path.exists(init_path):
            with np.load(init_path) as z:
                x_init = z["x_init"]
    if x_init is None:
        x_init = x.cpu().numpy()

    t0 = time.perf_counter()
    n_left = max(config.N - start_iter, 0)
    cur_map, x, changes = icm.refine_loop(
        data, cur_map, x, config, weights(config, device), n_left,
        stride=1 if logger else max(int(checkpoint_every), 1),
        first=start_iter, on_segment=_observer(checkpoint_dir, logger))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    refine_s = time.perf_counter() - t0

    nact = int(cur_map.nact)
    return icm.ICMResult(
        x_init=np.asarray(x_init), x=x.cpu().numpy(),
        map_pos=cur_map.pos[:nact].cpu().numpy(),
        map_counts=cur_map.counts[:nact].cpu().numpy(),
        changes=changes,
        timings={"refine_s": refine_s,
                 "refine_per_iter_s": refine_s / max(n_left, 1)})


def run_online(stream, config: Optional[ICMConfig] = None, device="cuda",
               refine: bool = True, verbose: bool = False) -> icm.ICMResult:
    """Causal init over a frame stream, then (optionally) offline refine.

    ``stream`` is any iterable of (ranges, odom, u) frame tuples, e.g.
    ``runtime.replay.stream_dataset``.
    """
    from icm_slam_tpu_torch.runtime.online import OnlineSLAM
    eng = OnlineSLAM(config or ICMConfig(), device, verbose=verbose)
    for frame in stream:
        eng.push(*frame)
    return eng.finish(refine=refine)
