"""Pose-graph optimization with loop closures on a synthetic drifting
loop, on the PyTorch port.

    python examples_torch/04_pose_graph_loop_closure.py [--device cuda]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from icm_slam_tpu_torch.models.pose_graph import (from_trajectory, optimize,
                                                  relative_se2)
from icm_slam_tpu_torch.solver.icm import resolve_device
from icm_slam_tpu_torch.utils.metrics import ate

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
dev = resolve_device(args.device)


def tensor(a):
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


T = 400
rng = np.random.default_rng(0)
th = np.linspace(0, 2 * np.pi, T)
gt = np.stack([12 * np.cos(th), 12 * np.sin(th), th + np.pi / 2], 1)
est = gt + np.cumsum(rng.normal(0, [0.01, 0.01, 0.001], (T, 3)), 0)

odom_rel = relative_se2(tensor(gt[:-1]), tensor(gt[1:]))
loops = np.array([[0, T - 1], [50, T - 50]])
loop_rel = relative_se2(tensor(gt[loops[:, 0]]), tensor(gt[loops[:, 1]]))

g = from_trajectory(tensor(est), odom_rel_noise=odom_rel, loop_pairs=loops,
                    loop_rel=loop_rel)
x_opt, norms = optimize(g, gn_iters=12, cg_iters=250)
print("ATE before:", ate(est, gt, align=True)["mean"])
print("ATE after :", ate(x_opt.cpu().numpy(), gt, align=True)["mean"])
print("residual norm:", float(norms[0]), "->", float(norms[-1]))
