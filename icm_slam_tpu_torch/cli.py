"""Command-line interface of the port.

    python -m icm_slam_tpu_torch run --dataset synthetic --config <yaml> [...]
    python -m icm_slam_tpu_torch replay --dataset synthetic --hz 10 [...]
    python -m icm_slam_tpu_torch online --host H --port 9090 [...]

``run`` is the offline pipeline (reference entry point C / __main__);
``replay`` feeds a dataset's frames through the online engine (reference
entry points A+D); ``online`` captures live frames from a rosbridge for
``config.time`` seconds (or until the /icm_slam/iterative_flag SetBool
service fires), then refines (the reference's example.py workflow; it
needs ``roslibpy``, or a stand-in for it).  ``--device`` picks the device
(default ``cuda``; a missing GPU is an error, never a silent fallback to
the CPU; it replaces the JAX CLI's ``online --cpu``).  The flags are those
of ``python -m icm_slam_tpu``, except the TPU knobs (``--pallas``,
``--pallas-fused``) and plotting (``--plot``, ``--plot-live``), which the
port does not have.  ``run --loop-close``
detects loop closures in the refined trajectory and corrects it with the
pose graph on the same device.
"""
from __future__ import annotations

import argparse
import json


def _add_common(ap):
    ap.add_argument("--dataset", default="ijac2018",
                    help="ijac2018 | palomar | synthetic | /path/to.mat")
    ap.add_argument("--config", default=None, help="reference-format YAML")
    ap.add_argument("--iters", type=int, default=None, help="override N")
    ap.add_argument("--frames", type=int, default=0, help="truncate frames")
    ap.add_argument("--mode", default=None,
                    choices=["sequential", "batched", "ba", "windowed_ba"],
                    help="sweep mode")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="torch device (default cuda)")
    ap.add_argument("--out", default=None, help="write result .npz here")
    ap.add_argument("--log", default=None, help="JSON-lines metrics path")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--profile",
                    choices=["fast", "default", "turbo", "ultra", "max"],
                    default=None,
                    help="knob preset (pose_passes x pose_gn_iters): fast "
                         "1 x 6, default 2 x 8, turbo 1 x 3, ultra 1 x 2, "
                         "max 1 x 1")
    ap.add_argument("--jacobi", action="store_true",
                    help="pose_update=jacobi: full Jacobi passes instead "
                         "of red-black half-pass pairs")
    ap.add_argument("--map-cap", type=int, default=None, metavar="K",
                    help="map_run_cap override; with --checked-cap the cap "
                         "is kept under a runtime witness")
    ap.add_argument("--checked-cap", action="store_true",
                    help="verify map_run_cap at runtime instead of the "
                         "provable total_obs/cota bound")
    ap.add_argument("--loop-close", action="store_true",
                    help="run: detect loop closures (scan ICP) and "
                         "pose-graph correct the refined trajectory")
    ap.add_argument("--export-map", default=None, metavar="PGM",
                    help="write the landmark map as an occupancy-grid PGM")
    ap.add_argument("--export-tum", default=None, metavar="TXT",
                    help="write the trajectory in TUM format")


def _config(args):
    """ICMConfig from --config YAML (reference format) + flag overrides."""
    from icm_slam_tpu_torch.config import ICMConfig

    overrides = {}
    if args.iters is not None:
        overrides["N"] = args.iters
    if args.mode:
        overrides["sweep_mode"] = args.mode
    if args.map_cap is not None:
        overrides["map_run_cap"] = args.map_cap
    if args.checked_cap:
        overrides["map_run_cap_checked"] = True
    if args.profile:
        p, g = {"fast": (1, 6), "default": (2, 8), "turbo": (1, 3),
                "ultra": (1, 2), "max": (1, 1)}[args.profile]
        overrides.setdefault("pose_passes", p)
        overrides.setdefault("pose_gn_iters", g)
    if args.jacobi:
        overrides.setdefault("pose_update", "jacobi")
    return (ICMConfig.from_yaml(args.config, **overrides) if args.config
            else ICMConfig(**overrides))


def _build(args):
    from icm_slam_tpu_torch.data.datasets import load

    cfg = _config(args)
    ds = load(args.dataset)
    if args.frames:
        ds = ds.slice(args.frames)
    return ds, cfg


def _save(args, res, ds, cfg):
    """Write what the flags ask for; the summary line compares with the
    dataset's odometry when there is a dataset (``online`` has none)."""
    import numpy as np
    if args.export_map:
        from icm_slam_tpu_torch.utils.export import save_map_pgm
        save_map_pgm(args.export_map, res.map_pos, trajectory=res.x)
    if args.export_tum:
        from icm_slam_tpu_torch.utils.export import save_trajectory_tum
        save_trajectory_tum(args.export_tum, res.x, deltat=cfg.deltat)
    if args.out:
        np.savez_compressed(args.out, x=res.x, x_init=res.x_init,
                            map_pos=res.map_pos, map_counts=res.map_counts,
                            changes=res.changes)
    if not args.quiet:
        from icm_slam_tpu_torch.utils.metrics import ate
        summary = {
            "frames": int(res.x.shape[0]),
            "landmarks": int(res.map_pos.shape[0]),
            "timings": {k: round(v, 4) for k, v in res.timings.items()}}
        if ds is not None:
            summary["ate_vs_odom"] = ate(res.x, ds.odom)
        print(json.dumps(summary))


def cmd_run(args):
    ds, cfg = _build(args)
    from icm_slam_tpu_torch.api import run_offline
    res = run_offline(ds, cfg, args.device,
                      checkpoint_dir=args.checkpoint_dir, resume=args.resume,
                      log_path=args.log, verbose=not args.quiet)
    if args.loop_close:
        import torch
        from icm_slam_tpu_torch.models.loop_closure import close_loops
        from icm_slam_tpu_torch.solver.icm import prepare
        data = prepare(ds, cfg, args.device)
        x_fix, cl = close_loops(data, torch.as_tensor(res.x).to(
            device=data.dist.device, dtype=data.dist.dtype), cfg)
        res.x = x_fix.cpu().numpy()
        if not args.quiet:
            print(f"# loop closures accepted: {cl.pairs.shape[0]}")
    _save(args, res, ds, cfg)


def cmd_replay(args):
    ds, cfg = _build(args)
    from icm_slam_tpu_torch.api import run_online
    from icm_slam_tpu_torch.runtime.replay import stream_dataset
    res = run_online(stream_dataset(ds, hz=args.hz), cfg, args.device,
                     refine=not args.no_refine, verbose=not args.quiet)
    _save(args, res, ds, cfg)


def cmd_online(args):
    """The reference's live workflow (ICM_ROS.py:280-316 / example.py):
    connect to a rosbridge, run the causal init over the incoming frames
    for the capture window (``--duration``, else ``config.time``; the
    SetBool service stops it earlier once the buffer drains), then refine
    and write the outputs."""
    cfg = _config(args)
    from icm_slam_tpu_torch.api import run_online
    from icm_slam_tpu_torch.runtime.ingest import RosBridgeSource

    src = RosBridgeSource(cfg, host=args.host, port=args.port)
    src.connect()
    try:
        dur = args.duration if args.duration is not None else cfg.time
        res = run_online(src.frames(duration=dur), cfg, args.device,
                         refine=not args.no_refine, verbose=not args.quiet)
    finally:
        src.disconnect()
    if not args.quiet:
        print(json.dumps({"sync": src.sync.stats}))
    _save(args, res, None, cfg)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="icm_slam_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="offline pipeline on a dataset")
    _add_common(p_run)
    p_run.set_defaults(fn=cmd_run)

    p_rep = sub.add_parser("replay",
                           help="stream frames through the online engine")
    _add_common(p_rep)
    p_rep.add_argument("--hz", type=float, default=0.0,
                       help="replay rate (0 = as fast as possible)")
    p_rep.add_argument("--no-refine", action="store_true")
    p_rep.set_defaults(fn=cmd_replay)

    p_on = sub.add_parser(
        "online", help="live capture from a rosbridge, then refine "
                       "(the reference's example.py workflow)")
    p_on.add_argument("--host", default="localhost")
    p_on.add_argument("--port", type=int, default=9090,
                      help="rosbridge websocket port (reference default)")
    p_on.add_argument("--duration", type=float, default=None,
                      help="capture window seconds (default: config.time, "
                           "275 s in the reference YAML); the SetBool "
                           "service stops earlier, as in the reference")
    p_on.add_argument("--no-refine", action="store_true",
                      help="stop after the causal init (iteration 0)")
    p_on.add_argument("--config", default=None,
                      help="reference-format YAML")
    p_on.add_argument("--iters", type=int, default=None, help="override N")
    p_on.add_argument("--mode", default=None,
                      choices=["sequential", "batched", "ba", "windowed_ba"])
    p_on.add_argument("--profile",
                      choices=["fast", "default", "turbo", "ultra", "max"],
                      default=None)
    p_on.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                      help="torch device (default cuda)")
    p_on.add_argument("--out", default=None, help="write result .npz here")
    p_on.add_argument("--quiet", action="store_true")
    p_on.add_argument("--export-map", default=None, metavar="PGM")
    p_on.add_argument("--export-tum", default=None, metavar="TXT")
    p_on.set_defaults(fn=cmd_online, map_cap=None, checked_cap=False,
                      jacobi=False)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
