"""Fleet mode on the PyTorch port: W independent SLAM worlds through the
engine at once.

``run_batched`` stacks W same-shape worlds on a leading world axis: every
kernel launch and every LM batch serves all of them, so on a GPU, where a
sweep's cost is the host issuing ~8,800 small launches, W worlds take
about the time of one.  It is the tool for multi-robot mapping,
Monte-Carlo noise studies and parameter ensembles.  With a fleet mesh
(``parallel.mesh.make_fleet_mesh``) the world axis is also sharded over
the ranks of a process group (worlds never communicate; the results are
gathered at the end); a one-process run makes a group of one rank.

Run: python examples_torch/06_fleet_mode.py [--device cuda]

The worlds are ``synthetic_world`` draws, as in the JAX example.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch.distributed as dist

from icm_slam_tpu_torch.config import ICMConfig
from icm_slam_tpu_torch.data.datasets import synthetic_world
from icm_slam_tpu_torch.parallel.mesh import make_fleet_mesh
from icm_slam_tpu_torch.solver.icm import run_batched

ap = argparse.ArgumentParser()
ap.add_argument("--frames", type=int, default=500)
ap.add_argument("--iters", type=int, default=10)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

# a small Monte-Carlo study: the same world under different sensor-noise
# draws (same shapes -> one fleet; per-world semantics identical to solo
# run())
worlds = [synthetic_world(T=args.frames, n_landmarks=30, world_size=30.0,
                          seed=s) for s in range(4)]
cfg = ICMConfig(N=args.iters, L=256, cota=10.0, dtype="float32")

results = run_batched(worlds, cfg, args.device)

print(f"{len(results)} worlds in one fleet; "
      f"pipeline {results[0].timings['pipeline_s']:.2f}s total, "
      f"{results[0].timings['per_world_s']:.2f}s/world")
for i, (ds, r) in enumerate(zip(worlds, results)):
    err = float(np.mean(np.linalg.norm(r.x[:, :2] - ds.odom[:, :2],
                                       axis=1)))
    print(f"  world {i}: {r.map_pos.shape[0]} landmarks, "
          f"mean |x - odom| = {err:.3f} m")

# the same fleet SHARDED across the ranks of a process group (data
# parallelism over worlds; a one-process run is a group of one rank,
# which runs the same engine)
mesh = make_fleet_mesh(device=args.device)
sharded = run_batched(worlds, cfg, args.device, mesh=mesh)
assert all(a.map_pos.shape == b.map_pos.shape
           for a, b in zip(sharded, results))
print(f"fleet sharded over {mesh.size()} rank(s): same censuses "
      f"{[r.map_pos.shape[0] for r in sharded]}, "
      f"pipeline {sharded[0].timings['pipeline_s']:.2f}s")
dist.destroy_process_group()
