"""Shard one ICM refinement sweep's frames over the ranks of a process
group, on the PyTorch port (JAX's example shards it over a device mesh).

Every rank runs this script.  The rank count comes from torchrun or from
``ICM_COORDINATOR`` / ``ICM_NUM_PROCESSES`` / ``ICM_PROCESS_ID``; with
neither, one process forms a group of one rank.  On the CPU the ranks
talk gloo, on GPUs NCCL (one GPU each; on a machine with one GPU, run one
rank):

    python examples_torch/05_multichip_sharding.py [--device cuda]
    torchrun --nproc-per-node 2 examples_torch/05_multichip_sharding.py \\
        --device cpu

Each rank takes the init and the filtered map from ``run(...,
n_iters=0)``, holds its block of the frames (``shard_sweep_inputs``), and
runs one ``refine_sweep_batched(..., mesh=...)``: the label and running-
mean prefixes over earlier frames cross ranks as scans, a block's edge
poses as halos.  The default dataset is ``synthetic``
(``synthetic_world()``, its first 400 frames): the reference's ``.mat``
files ship with neither this repository nor its test machines.
``--dataset ijac2018`` reads them from the directory in
``$ICM_REFERENCE_DIR``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch
import torch.distributed as dist

from icm_slam_tpu_torch import ICMConfig
from icm_slam_tpu_torch.core.energy import weights
from icm_slam_tpu_torch.data.datasets import load
from icm_slam_tpu_torch.mapping.landmark_map import MapState, filter_map
from icm_slam_tpu_torch.parallel.distributed import initialize, is_primary
from icm_slam_tpu_torch.parallel.mesh import (gather_time_sharded,
                                              make_mesh, mesh_device,
                                              shard_sweep_inputs)
from icm_slam_tpu_torch.solver.icm import prepare, resolve_config, run
from icm_slam_tpu_torch.solver.sweeps import refine_sweep_batched

ap = argparse.ArgumentParser()
ap.add_argument("--dataset", default="synthetic")
ap.add_argument("--frames", type=int, default=400)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

initialize(device=args.device)
mesh = make_mesh(device=args.device)
dev = mesh_device(mesh)

ds = load(args.dataset).slice(args.frames)
cfg = ICMConfig(N=1, L=256)
start = run(ds, cfg, dev, n_iters=0)          # init + filtered map
data = prepare(ds, cfg, dev)
cfg = resolve_config(cfg, data)
n = start.map_pos.shape[0]
pos = torch.zeros((cfg.L, 2), device=dev)
counts = torch.zeros((cfg.L,), device=dev)
pos[:n] = torch.as_tensor(start.map_pos, device=dev)
counts[:n] = torch.as_tensor(start.map_counts, device=dev)
cur = MapState(pos, counts, torch.tensor(n, dtype=torch.int32, device=dev))
x0 = torch.as_tensor(start.x_init, device=dev)

data_s, x_s, T = shard_sweep_inputs(mesh, data, x0)
st, x_s = refine_sweep_batched(data_s, cur, x_s, cfg, weights(cfg, dev),
                               last_t=T - 1, mesh=mesh)
fm = filter_map(st, cfg.cota, cfg.dist_thr, live_cap=cfg.map_run_cap)
x_out = gather_time_sharded(mesh, x_s, T)
if is_primary():
    print(f"sharded sweep over {mesh.size()} rank(s): "
          f"{int(fm.nact)} landmarks, poses {tuple(x_out.shape)}")
dist.destroy_process_group()
