"""Write the JAX package's results on two synthetic worlds as the golden file
for the PyTorch port's run on the GPU (``chip_smoke.py``).

Usage:
    python tools/make_torch_golden.py [--out PATH]

Runs ``icm_slam_tpu.solver.icm.run`` on the CPU for two cases, stored
under key prefixes in one file:

* ``main_`` — ``synthetic_world(T=1833, seed=0)`` with ``ICMConfig()``
  defaults (N=30, L=1024, cota=300): the port's main path at full size;
* ``small_`` — ``synthetic_world(T=240, n_landmarks=12, seed=7)`` with
  L=256, cota=20, N=3: the world of tests/test_torch_slice.py, small
  enough that the port stays within the 1e-3 pose band of JAX.

Both resolve to the capped association branch, and JAX runs with
``use_pallas_fused_assoc=True``: the route through the fused association
kernel the port's capped branch replaces (Pallas interpret mode off the
TPU, ~20 s for both cases here), with the same d^2 form of the distance
gate.  The file holds outputs only — poses, map, census, map changes,
the resolved caps, the ATE against the world's truth — plus a checksum of
each world, which the reader must reproduce before it compares anything.
"""
import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

# prefix -> (synthetic_world kwargs, ICMConfig kwargs)
CASES = {
    "main": (dict(T=1833, seed=0), dict(N=30)),
    "small": (dict(T=240, n_landmarks=12, seed=7), dict(L=256, cota=20.0,
                                                        N=3)),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        REPO, "tests", "golden", "torch_slice_synth_T1833_N30.npz"))
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    from icm_slam_tpu.config import ICMConfig
    from icm_slam_tpu.data.datasets import synthetic_world
    from icm_slam_tpu.solver.icm import prepare, resolve_config, run
    from icm_slam_tpu_torch.data.datasets import world_checksum

    out = {"jax_path": "use_pallas_fused_assoc=True (Pallas interpret)"}
    for prefix, (world_kw, cfg_kw) in CASES.items():
        ds, x_true, _ = synthetic_world(**world_kw, return_truth=True)
        cfg = ICMConfig(**cfg_kw, use_pallas_fused_assoc=True)
        resolved = resolve_config(cfg, prepare(ds, cfg))
        t0 = time.time()
        res = run(ds, cfg)
        dt = time.time() - t0
        ate = float(np.sqrt(((res.x[:, :2] - x_true[:, :2]) ** 2)
                            .sum(1).mean()))
        fields = dict(
            world_checksum=world_checksum(ds), obs_cap=resolved.obs_cap,
            map_run_cap=resolved.map_run_cap, x_init=res.x_init, x=res.x,
            map_pos=res.map_pos, map_counts=res.map_counts,
            changes=res.changes, census=res.map_pos.shape[0], ate_rmse=ate,
            wall_seconds=dt)
        out.update({f"{prefix}_{k}": v for k, v in fields.items()})
        print(f"{prefix}: {dt:.1f}s, census={res.map_pos.shape[0]}, "
              f"obs_cap={resolved.obs_cap}, "
              f"map_run_cap={resolved.map_run_cap}, ate_rmse={ate:.4f}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
