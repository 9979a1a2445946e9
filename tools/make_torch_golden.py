"""Write the JAX package's results on synthetic worlds as golden files for
the PyTorch port's runs on the GPU (``chip_smoke.py``).

Usage:
    python tools/make_torch_golden.py [NAME ...] [--dir DIR]

NAME is a golden file's name below (default: all of them).  Each file
holds cases under key prefixes, each the output of
``icm_slam_tpu.solver.icm.run`` on the CPU:

``torch_slice_synth_T1833_N30.npz`` (JAX with ``use_pallas_fused_assoc=
True``: the route through the fused association kernel the port's capped
branch replaces, with the same d^2 form of the distance gate; Pallas
interpret mode off the TPU, ~20 s):

* ``main_`` — ``synthetic_world(T=1833, seed=0)`` with ``ICMConfig()``
  defaults (N=30, L=1024, cota=300): the port's main path at full size;
* ``small_`` — ``synthetic_world(T=240, n_landmarks=12, seed=7)`` with
  L=256, cota=20, N=3: the world of tests/test_torch_slice.py, small
  enough that the port stays within the 1e-3 pose band of JAX.

``torch_engines_synth_T1833.npz`` (JAX's default paths, ~15 s):

* ``seq_`` — the T=1833 world with ``sweep_mode="sequential"``, N=2: the
  causal init and the reference-faithful sequential refine;
* ``nqj_`` — the same world with ``replicate_new_obs_quirk=False`` and
  ``pose_update="jacobi"``, N=3, L=2048: the causal init, then the
  batched refine with connected-component labels and Jacobi passes (at
  L=1024 the first sweep allocates 1,083 labels and overflows the table).

The files hold outputs only — poses, map, census, map changes, the
resolved caps, the ATE against the world's truth — plus a checksum of
each world, which the reader must reproduce before it compares anything.
"""
import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

_BIG = dict(T=1833, seed=0)
_SMALL = dict(T=240, n_landmarks=12, seed=7)
# file -> (ICMConfig kwargs of every case, {prefix: (synthetic_world
# kwargs, ICMConfig kwargs)})
GOLDENS = {
    "torch_slice_synth_T1833_N30.npz": (
        dict(use_pallas_fused_assoc=True),
        {"main": (_BIG, dict(N=30)),
         "small": (_SMALL, dict(L=256, cota=20.0, N=3))}),
    "torch_engines_synth_T1833.npz": (
        {},
        {"seq": (_BIG, dict(sweep_mode="sequential", N=2)),
         "nqj": (_BIG, dict(replicate_new_obs_quirk=False,
                            pose_update="jacobi", N=3, L=2048))}),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*", choices=list(GOLDENS),
                    help="golden files to write (default: all)")
    ap.add_argument("--dir", default=os.path.join(REPO, "tests", "golden"))
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    from icm_slam_tpu.config import ICMConfig
    from icm_slam_tpu.data.datasets import synthetic_world
    from icm_slam_tpu.solver.icm import prepare, resolve_config, run
    from icm_slam_tpu_torch.data.datasets import world_checksum

    for name in args.names or GOLDENS:
        common, cases = GOLDENS[name]
        out = {"jax_path": repr(common) if common else "default"}
        for prefix, (world_kw, cfg_kw) in cases.items():
            ds, x_true, _ = synthetic_world(**world_kw, return_truth=True)
            cfg = ICMConfig(**cfg_kw, **common)
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
                changes=res.changes, census=res.map_pos.shape[0],
                ate_rmse=ate, wall_seconds=dt)
            out.update({f"{prefix}_{k}": v for k, v in fields.items()})
            print(f"{name} {prefix}: {dt:.1f}s, "
                  f"census={res.map_pos.shape[0]}, "
                  f"obs_cap={resolved.obs_cap}, "
                  f"map_run_cap={resolved.map_run_cap}, ate_rmse={ate:.4f}",
                  flush=True)
        os.makedirs(args.dir, exist_ok=True)
        path = os.path.join(args.dir, name)
        np.savez_compressed(path, **out)
        print(f"saved {path}")


if __name__ == "__main__":
    main()
