"""Time the two Jacobian routes of a model's pose solves on one device.

* ``hybrid`` — the port's route: analytic Jacobians for the default
  terms, forward mode (``core.energy.hook_jacobian``) over a hook's own
  terms only (``one_sided_jacobian`` / ``two_sided_jacobian``);
* ``whole`` — forward mode over the whole residual, ``hook_jacobian`` of
  ``one_sided_residuals`` / ``two_sided_residuals``: the JAX package's
  route (``jacfwd`` of every residual).

Usage:
    python tools/time_jacobian_routes.py [--device cuda] [--big-frames N]
        [--small-frames N] [--out PATH]

Each turn (hybrid, whole, whole, hybrid, each route patched into
``solver.sweeps``) runs the two hook phases of ``chip_smoke.py``: the
hooks of tests/test_extensions.py on ``synthetic_world(T=1833, seed=0)``
with ``ICMConfig(N=2, init_mode="batched")`` (the batched init, then two
sweeps) and the robust ``obs_model`` on ``synthetic_world(T=240,
n_landmarks=12, seed=7)``, L=256, cota=20, N=1 (the causal init, a LM
solve a frame).  On a GPU each route is then profiled once: kernel
launches and device busy time of one refine sweep of the first world
from its run's final state, and of the causal init of the second
world's first 17 frames.  Prints one JSON line per turn, then a summary
line (also written to ``--out``) with the card's ``nvidia-smi`` name and
power limit.  ~6 min on an H100; ``--device cpu`` with a few frames
checks the script.
"""
import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)


@contextlib.contextmanager
def jacobian_route(route):
    """Patch the whole-residual route into ``solver.sweeps`` for the
    duration (``hybrid`` leaves the port as it is)."""
    from icm_slam_tpu_torch.core.energy import (hook_jacobian,
                                                one_sided_residuals,
                                                two_sided_residuals)
    from icm_slam_tpu_torch.solver import sweeps
    saved = sweeps._one_sided, sweeps._two_sided

    def whole(resid):
        def build(prob, w, config):
            model = sweeps._model_of(config)

            def fn(xx, pp):
                return resid(xx, pp, w, model)
            return (lambda xx: fn(xx, prob),
                    lambda xx: hook_jacobian(fn, xx, prob))
        return build

    if route == "whole":
        sweeps._one_sided = whole(one_sided_residuals)
        sweeps._two_sided = whole(two_sided_residuals)
    try:
        yield
    finally:
        sweeps._one_sided, sweeps._two_sided = saved


def worlds(big_frames, small_frames):
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.data.datasets import synthetic_world
    from chip_smoke import hooks_model, robust_obs_model
    big = synthetic_world(T=big_frames, seed=0)
    small = synthetic_world(T=small_frames, n_landmarks=12, seed=7)
    return (big, ICMConfig(N=2, init_mode="batched", model=hooks_model()),
            small, ICMConfig(L=256, cota=20.0, N=1,
                             model=robust_obs_model()))


def turn(device, big, big_cfg, small, small_cfg):
    from icm_slam_tpu_torch.solver import icm
    rb = icm.run(big, big_cfg, device)
    rs = icm.run(small, small_cfg, device)
    return dict(batched_init_s=rb.timings["init_s"],
                batched_sweep_s=rb.timings["refine_per_iter_s"],
                causal_init_s=rs.timings["init_s"],
                causal_init_ms_per_frame=rs.timings["init_s"]
                / (small.T - 1) * 1e3), (rb, rs)


def profiles(device, big, big_cfg, small, small_cfg, rb):
    """Launches and busy time of one batched refine sweep and of a
    17-frame causal init, per route."""
    import torch
    from chip_smoke import launches_and_syncs, map_state
    from icm_slam_tpu_torch.core.energy import weights
    from icm_slam_tpu_torch.data.datasets import Dataset
    from icm_slam_tpu_torch.solver import icm
    data = icm.prepare(big, big_cfg, device)
    rcfg = icm.resolve_config(big_cfg, data)
    data = icm.hoist_compaction(data, rcfg)
    w = weights(rcfg, device)
    cur = map_state(rb, rcfg.L)
    x = torch.from_numpy(rb.x).to(device)
    head = Dataset(small.scans[:17], small.odom[:17], small.u[:17],
                   small.x0, small.name)
    head_cfg = dataclasses.replace(small_cfg, N=0)
    out = {}
    for route in ("hybrid", "whole"):
        with jacobian_route(route):
            icm._refine_step(data, cur, x, rcfg, w)
            icm.run(head, head_cfg, device)
            sweep = launches_and_syncs(
                lambda: icm._refine_step(data, cur, x, rcfg, w))
            init = launches_and_syncs(lambda: icm.run(head, head_cfg,
                                                      device))
        out[route] = dict(
            sweep_launches=sweep["kernel_launches"],
            sweep_busy_ms=sweep["device_busy_ms"],
            causal_init_17_frames_launches=init["kernel_launches"],
            causal_init_17_frames_busy_ms=init["device_busy_ms"])
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--big-frames", type=int, default=1833)
    ap.add_argument("--small-frames", type=int, default=240)
    ap.add_argument("--out", default=os.path.join(
        REPO, "build", "jacobian_routes.json"))
    args = ap.parse_args()
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to check the "
                         "script on the CPU")
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
           if args.device == "cuda" else "cpu")
    big, big_cfg, small, small_cfg = worlds(args.big_frames,
                                            args.small_frames)
    from icm_slam_tpu_torch.solver import icm
    icm.run(small, dataclasses.replace(small_cfg, N=1), args.device)  # warm
    turns, results = [], {}
    for route in ("hybrid", "whole", "whole", "hybrid"):
        t0 = time.perf_counter()
        with jacobian_route(route):
            times, res = turn(args.device, big, big_cfg, small, small_cfg)
        row = dict(route=route, wall_s=time.perf_counter() - t0, **times)
        print(json.dumps(row), flush=True)
        turns.append(row)
        results.setdefault(route, res)
    (hb, hs), (wb, ws) = results["hybrid"], results["whole"]
    summary = dict(
        card=smi, turns=turns,
        max_abs_diff_whole_vs_hybrid=dict(
            batched_x=float(np.abs(hb.x - wb.x).max()),
            batched_x_init=float(np.abs(hb.x_init - wb.x_init).max()),
            causal_x=float(np.abs(hs.x - ws.x).max()),
            causal_x_init=float(np.abs(hs.x_init - ws.x_init).max()),
            census_equal=bool(hb.map_pos.shape == wb.map_pos.shape
                              and hs.map_pos.shape == ws.map_pos.shape)))
    if args.device == "cuda":
        summary["profiles"] = profiles(args.device, big, big_cfg, small,
                                       small_cfg, hb)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
