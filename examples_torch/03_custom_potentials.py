"""Custom energy hooks on the PyTorch port: the reference's example.py
subclass mechanism.

    python examples_torch/03_custom_potentials.py [--device cuda]

A hook is torch code in the port's batched convention: ``x`` is (P, 3)
poses and every ``PoseProblem`` field has the same leading P (the JAX
package's hooks see one pose at a time under ``vmap``).  The default
dataset is ``synthetic`` (``synthetic_world()``, its first 600 frames):
the reference's ``.mat`` files ship with neither this repository nor its
test machines.  ``--dataset ijac2018`` reads them from the directory in
``$ICM_REFERENCE_DIR``.
"""
import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

from icm_slam_tpu_torch import ICMConfig
from icm_slam_tpu_torch.core.energy import EnergyModel
from icm_slam_tpu_torch.data.datasets import load
from icm_slam_tpu_torch.solver.icm import run

ap = argparse.ArgumentParser()
ap.add_argument("--dataset", default="synthetic")
ap.add_argument("--frames", type=int, default=600)
ap.add_argument("--iters", type=int, default=5)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()


def range_weighted_h(dist, ang):
    """Downweight long-range beams (sensor noise grows with distance)."""
    return 1.0 / (1.0 + 0.1 * dist)


def soft_odometry_anchor(x, prob):
    """Extra residual pulling each pose toward raw odometry."""
    return 0.5 * (x[:, :2] - prob.odo_cur[:, :2])


model = EnergyModel(obs_scale=range_weighted_h,
                    extra_one_sided=soft_odometry_anchor,
                    extra_two_sided=soft_odometry_anchor)

ds = load(args.dataset).slice(args.frames)
res = run(ds, ICMConfig(N=args.iters, model=model), args.device,
          verbose=True)
print(f"custom-model run: {res.map_pos.shape[0]} landmarks")


# --- full replacement (the reference's fun_x_/h_ subclass override power) ---

def robust_obs_model(x, prob, sqrt_q):
    """REPLACE the whole observation potential h with a robust variant:
    Geman-McClure-style soft gating bounds each beam's influence."""
    a = prob.ang + x[:, 2:3] - math.pi / 2.0
    pts = x[:, None, :2] + prob.dist[..., None] * torch.stack(
        [torch.cos(a), torch.sin(a)], dim=-1)
    r = (pts - prob.matched) * sqrt_q
    n2 = torch.sum(r * r, dim=-1, keepdim=True)
    return torch.where(prob.mask[..., None], r / torch.sqrt(1.0 + n2), 0.0)


robust = EnergyModel(obs_model=robust_obs_model)
res2 = run(ds, ICMConfig(N=args.iters, model=robust), args.device,
           verbose=True)
print(f"robust-h run: {res2.map_pos.shape[0]} landmarks")
