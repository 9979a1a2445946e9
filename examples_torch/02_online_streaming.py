"""Online mode on the PyTorch port: stream frames causally, then refine
(entry point A).

    python examples_torch/02_online_streaming.py [--hz 0] [--device cuda]

The default dataset is ``synthetic`` (``synthetic_world()``, its first
600 frames): the reference's ``.mat`` files ship with neither this
repository nor its test machines.  ``--dataset ijac2018`` reads them from
the directory in ``$ICM_REFERENCE_DIR``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from icm_slam_tpu_torch import ICMConfig
from icm_slam_tpu_torch.data.datasets import load
from icm_slam_tpu_torch.runtime.online import OnlineSLAM
from icm_slam_tpu_torch.runtime.replay import stream_dataset

ap = argparse.ArgumentParser()
ap.add_argument("--hz", type=float, default=0.0, help="0 = full speed")
ap.add_argument("--dataset", default="synthetic")
ap.add_argument("--frames", type=int, default=600)
ap.add_argument("--iters", type=int, default=5)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

ds = load(args.dataset).slice(args.frames)
engine = OnlineSLAM(ICMConfig(N=args.iters), args.device, chunk_size=64,
                    verbose=True)
for ranges, odom, u in stream_dataset(ds, hz=args.hz):
    engine.push(ranges, odom, u)
res = engine.finish(refine=True)
print(f"online run: {res.x.shape[0]} poses, {res.map_pos.shape[0]} landmarks")
