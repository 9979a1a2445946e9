"""The live workflow end-to-end on the PyTorch port, with zero
infrastructure.

The reference's primary operating mode is a live rosbridge feed
(ICM_SLAM.py:276-341: websocket client, topic subscriptions, the
/icm_slam/iterative_flag SetBool stop service) with a publisher
replaying a .mat dataset (createbag.py).  This example runs that whole
loop in one process using the in-tree loopback bridge
(runtime/fake_rosbridge.py) — a real TCP socket speaking the rosbridge
JSON op protocol — so you can see the transport path work without
Docker, roscore, or even roslibpy installed:

    publisher thread -> loopback bridge -> RosBridgeSource -> OnlineSLAM

Against a REAL robot or simulator, replace the fake bridge with an
actual rosbridge endpoint and install roslibpy; `RosBridgeSource` and
the `python -m icm_slam_tpu_torch online` CLI are identical in both
worlds.

Run: python examples_torch/07_live_rosbridge.py [--device cuda]

The default dataset is ``synthetic`` (``synthetic_world()``, its first
200 frames): the reference's ``.mat`` files ship with neither this
repository nor its test machines.  ``--dataset ijac2018`` reads them
from the directory in ``$ICM_REFERENCE_DIR``.
"""
import argparse
import os
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from icm_slam_tpu_torch.config import ICMConfig
from icm_slam_tpu_torch.data.datasets import load
from icm_slam_tpu_torch.runtime import fake_rosbridge as frb


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="synthetic")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # 1. a loopback "rosbridge" + the roslibpy-compatible shim
    server = frb.FakeRosBridgeServer().start()
    sys.modules["roslibpy"] = frb.client_module()
    from icm_slam_tpu_torch.api import run_online
    from icm_slam_tpu_torch.runtime.ingest import RosBridgeSource
    from icm_slam_tpu_torch.runtime.replay import publish_to_rosbridge

    cfg = ICMConfig(N=3, L=256)
    ds = load(args.dataset).slice(args.frames)

    # 2. subscriber first (rosbridge only fans out to live subscriptions)
    src = RosBridgeSource(cfg, host=server.host, port=server.port)
    src.connect()

    # 3. replay the dataset as live LaserScan/Odometry topics (the
    #    createbag.py role), then flip the reference's stop service
    def feed():
        publish_to_rosbridge(ds, cfg, hz=10.0, speedup=100.0,
                             host=server.host, port=server.port)
        time.sleep(0.5)
        lib = sys.modules["roslibpy"]
        client = lib.Ros(host=server.host, port=server.port)
        client.run()
        lib.Service(client, "/icm_slam/iterative_flag",
                    "std_srvs/SetBool").call({"data": True}, timeout=10)
        client.terminate()

    threading.Thread(target=feed, daemon=True).start()

    # 4. causal init over the live frames, then offline refinement
    res = run_online(src.frames(duration=30.0), cfg, args.device)
    src.disconnect()
    server.stop()

    print(f"frames paired: {res.x.shape[0]}  sync: {src.sync.stats}")
    print(f"landmarks: {res.map_pos.shape[0]}")
    print(f"bridge stats: {server.stats}")


if __name__ == "__main__":
    main()
