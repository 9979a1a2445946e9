"""Offline pipeline (entry point C equivalent) on the PyTorch port.

    python examples_torch/01_offline_pipeline.py [--iters N] [--device cuda]

The default dataset is ``synthetic`` (``synthetic_world()``, 600 frames):
the reference's ``.mat`` files ship with neither this repository nor its
test machines.  ``--dataset ijac2018`` reads them from the directory in
``$ICM_REFERENCE_DIR``.  Writes slam_result.png and convergence.png into
the working directory (needs matplotlib).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from icm_slam_tpu_torch import ICMConfig
from icm_slam_tpu_torch.api import run_offline
from icm_slam_tpu_torch.data.datasets import load
from icm_slam_tpu_torch.utils.metrics import ate
from icm_slam_tpu_torch.utils.viz import plot_convergence, plot_slam

ap = argparse.ArgumentParser()
ap.add_argument("--iters", type=int, default=10)
ap.add_argument("--dataset", default="synthetic")
ap.add_argument("--frames", type=int, default=0, help="truncate frames")
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

ds = load(args.dataset)
if args.frames:
    ds = ds.slice(args.frames)
cfg = ICMConfig(N=args.iters)
res = run_offline(ds, cfg, args.device, verbose=True)

print(f"{res.map_pos.shape[0]} landmarks, "
      f"{res.timings['refine_per_iter_s']*1e3:.0f} ms / ICM iteration")
print("ATE vs odometry:", ate(res.x, ds.odom))
plot_slam(res.x, res.map_pos, ds.odom, path="slam_result.png")
plot_convergence(res.changes, path="convergence.png")
print("wrote slam_result.png, convergence.png")
