#!/usr/bin/env python3
"""Bring-up check of the PyTorch port (icm_slam_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises, so the exit code is
nonzero and the final line is not printed:

1. device: the card, its power limit, and the kernels' build from
   ``icm_slam_tpu_torch/csrc`` (nvcc, sm_90a) with its seconds;
2. K1 (fused association + sums) against its plain PyTorch version on the
   card at the main path's shapes (T=1833, B=48, K=128), nact in
   {0, 1, 37, 128}: labels exact, d2min bitwise, sums atol 1e-4; times;
3. K2 (nearest landmark) against its plain version at (1833, 48, 1024),
   nact in {0, 1, 37, 1024}: labels exact, distances atol 1e-5; times;
4. the main path: ``run(synthetic_world(T=1833, seed=0), ICMConfig(),
   "cuda")`` (N=30, L=1024), held against the JAX package's golden file
   (tests/golden/torch_slice_synth_T1833_N30.npz, made by
   tools/make_torch_golden.py): the world's checksum must match, the
   census must be exact, the ATE against the world's truth within 10% of
   JAX's; the pose difference to JAX is printed;
5. the uncapped branch: the same world with map_run_cap=0 and N=3;
   launch counts: K1 exactly 30 in run 4 and K2 exactly 3 in run 5;
6. the small world of tests/test_torch_slice.py on the card against its
   golden: census exact, poses and map within 1e-3;
7. warm timings of the main path, and the kernel launches
   (torch.profiler) and host syncs (PyTorch's sync debug mode) of the
   init and of one refine sweep.

Then the kernels' JSON line, the card's ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.  Without CUDA the script fails.
"""
import json
import os
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden",
                      "torch_slice_synth_T1833_N30.npz")


def emit(**kw):
    print(json.dumps(kw), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps):
    """Mean device milliseconds per call over ``reps`` calls (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_pair(kernel, plain, reps):
    """Times in turns (plain, kernel, kernel, plain); returns (ms, plain_ms)."""
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def kernel_inputs(T, B, K, seed):
    """Beam points scattered around a random map, as on the main path."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    mp = rng.uniform(-15.0, 15.0, (K, 2)).astype(np.float32)
    pick = rng.integers(0, K, (T, B))
    pts = (mp[pick] + rng.normal(0.0, 0.8, (T, B, 2))).astype(np.float32)
    mask = rng.uniform(size=(T, B)) < 0.7
    dev = torch.device("cuda")
    return (torch.from_numpy(pts).to(dev), torch.from_numpy(mp).to(dev),
            torch.from_numpy(mask).to(dev))


def phase_k1(T=1833, B=48, K=128, dist_thr=1.0):
    import torch
    from icm_slam_tpu_torch.ops import assoc_sums as k1
    pts, mp, mask = kernel_inputs(T, B, K, seed=1)
    err = 0.0
    for n in (0, 1, 37, K):
        nact = torch.tensor(n, dtype=torch.int32, device="cuda")
        lab, d2, sums = k1.associate_and_sums(pts, mp, mask, nact, dist_thr)
        lab_p, d2_p, sums_p = k1.associate_and_sums_plain(pts, mp, mask,
                                                          nact, dist_thr)
        torch.cuda.synchronize()
        check(torch.equal(lab, lab_p), f"K1 labels differ at nact={n}")
        check(torch.equal(d2, d2_p), f"K1 d2min not bitwise at nact={n}")
        e = float((sums - sums_p).abs().max())
        check(e <= 1e-4, f"K1 sums differ by {e} at nact={n}")
        err = max(err, e)
    nact = torch.tensor(K, dtype=torch.int32, device="cuda")
    ms, plain_ms = time_pair(
        lambda: k1.associate_and_sums(pts, mp, mask, nact, dist_thr),
        lambda: k1.associate_and_sums_plain(pts, mp, mask, nact, dist_thr),
        reps=50)
    emit(phase="k1_vs_plain", shape=[T, B, K], nact=[0, 1, 37, K],
         labels="exact", d2min="bitwise", sums_max_abs_err=err, ms=ms,
         plain_ms=plain_ms)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def phase_k2(T=1833, B=48, L=1024):
    import torch
    from icm_slam_tpu_torch.ops import assoc as k2
    pts, mp, _ = kernel_inputs(T, B, L, seed=2)
    err = 0.0
    for n in (0, 1, 37, L):
        nact = torch.tensor(n, dtype=torch.int32, device="cuda")
        lab, dist = k2.nearest_landmark(pts, mp, nact)
        lab_p, dist_p = k2.nearest_landmark_plain(pts, mp, nact)
        torch.cuda.synchronize()
        check(torch.equal(lab, lab_p), f"K2 labels differ at nact={n}")
        fin = torch.isfinite(dist_p)
        check(torch.equal(fin, torch.isfinite(dist)),
              f"K2 infinite distances differ at nact={n}")
        e = float((dist - dist_p)[fin].abs().max()) if bool(fin.any()) \
            else 0.0
        check(e <= 1e-5, f"K2 distances differ by {e} at nact={n}")
        err = max(err, e)
    nact = torch.tensor(L, dtype=torch.int32, device="cuda")
    ms, plain_ms = time_pair(lambda: k2.nearest_landmark(pts, mp, nact),
                             lambda: k2.nearest_landmark_plain(pts, mp, nact),
                             reps=20)
    emit(phase="k2_vs_plain", shape=[T, B, L], nact=[0, 1, 37, L],
         labels="exact", dist_max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def ate_rmse(x, x_true):
    import numpy as np
    return float(np.sqrt(((x[:, :2] - x_true[:, :2]) ** 2).sum(1).mean()))


def golden_case(g, prefix):
    return {k[len(prefix) + 1:]: g[k] for k in g.files
            if k.startswith(prefix + "_")}


def phase_main(g, smi):
    """Run 4 and 5 with the launch counters reset just before them."""
    import numpy as np
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.data.datasets import (synthetic_world,
                                                  world_checksum)
    from icm_slam_tpu_torch.ops import assoc as k2
    from icm_slam_tpu_torch.ops import assoc_sums as k1
    from icm_slam_tpu_torch.solver.icm import prepare, resolve_config, run

    gm = golden_case(g, "main")
    ds, x_true, _ = synthetic_world(T=1833, seed=0, return_truth=True)
    check(world_checksum(ds) == str(gm["world_checksum"]),
          "synthetic_world(T=1833, seed=0) differs from the world the "
          "golden file was made on (NumPy build or CPU differ); the "
          "comparison would be meaningless")
    cfg = ICMConfig()
    resolved = resolve_config(cfg, prepare(ds, cfg, "cuda"))
    check(resolved.map_run_cap != 0 and resolved.obs_cap < 181,
          f"main path not on the capped branch: {resolved}")
    check(resolved.map_run_cap == int(gm["map_run_cap"])
          and resolved.obs_cap == int(gm["obs_cap"]),
          "resolved caps differ from the golden's")

    k1.LAUNCHES = 0
    k2.LAUNCHES = 0
    res = run(ds, cfg, "cuda")
    main_k1, main_k2 = k1.LAUNCHES, k2.LAUNCHES
    res_u = run(ds, ICMConfig(N=3, map_run_cap=0), "cuda")
    launches = {"k1": k1.LAUNCHES, "k2": k2.LAUNCHES}
    check(main_k1 == cfg.N and main_k2 == 0,
          f"main run launched K1 {main_k1}x, K2 {main_k2}x; want "
          f"{cfg.N} and 0")
    check(launches["k1"] == main_k1 and launches["k2"] == 3,
          f"uncapped run launched K1 {launches['k1'] - main_k1}x, K2 "
          f"{launches['k2']}x; want 0 and 3")

    census = res.map_pos.shape[0]
    check(all(np.isfinite(a).all() for a in
              (res.x, res.x_init, res.map_pos, res.changes)),
          "non-finite output in the main run")
    check(res.x.shape == (1833, 3), f"pose shape {res.x.shape}")
    check(census == int(gm["census"]),
          f"census {census} != JAX golden {int(gm['census'])}")
    ate_port, ate_jax = ate_rmse(res.x, x_true), float(gm["ate_rmse"])
    check(abs(ate_port - ate_jax) <= 0.1 * ate_jax,
          f"ATE {ate_port} not within 10% of JAX's {ate_jax}")
    dx = np.abs(res.x - gm["x"]).max(axis=1)
    t = res.timings
    emit(phase="main_path", world="synthetic_world(T=1833, seed=0)",
         config="ICMConfig() N=30 L=1024", obs_cap=resolved.obs_cap,
         map_run_cap=resolved.map_run_cap, k1_launches=main_k1,
         census=census, census_jax=int(gm["census"]),
         ate_rmse_port=ate_port, ate_rmse_jax=ate_jax,
         x_max_abs_diff_vs_jax=float(dx.max()),
         x_frac_frames_within_1e3=float((dx <= 1e-3).mean()),
         x_init_max_abs_diff_vs_jax=float(
             np.abs(res.x_init - gm["x_init"]).max()),
         map_pos_max_abs_diff_vs_jax=float(
             np.abs(res.map_pos - gm["map_pos"]).max()),
         prepare_s=t["prepare_s"], init_s=t["init_s"],
         refine_per_iter_s=t["refine_per_iter_s"],
         refine_frames_per_s=1833 / t["refine_per_iter_s"],
         note="first run in the process (cold)", card=smi)
    check(all(np.isfinite(a).all() for a in (res_u.x, res_u.map_pos)),
          "non-finite output in the uncapped run")
    emit(phase="uncapped_branch", config="ICMConfig(N=3, map_run_cap=0)",
         k2_launches=launches["k2"], census=res_u.map_pos.shape[0],
         init_s=res_u.timings["init_s"],
         refine_per_iter_s=res_u.timings["refine_per_iter_s"], card=smi)
    return launches


def phase_small(g):
    import numpy as np
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.data.datasets import (synthetic_world,
                                                  world_checksum)
    from icm_slam_tpu_torch.solver.icm import run

    gs = golden_case(g, "small")
    ds = synthetic_world(T=240, n_landmarks=12, seed=7)
    check(world_checksum(ds) == str(gs["world_checksum"]),
          "small world differs from the golden's")
    res = run(ds, ICMConfig(L=256, cota=20.0, N=3), "cuda")
    check(res.map_pos.shape[0] == int(gs["census"]),
          f"small census {res.map_pos.shape[0]} != {int(gs['census'])}")
    errs = {k: float(np.abs(getattr(res, k) - gs[k]).max())
            for k in ("x_init", "x", "map_pos", "changes")}
    for k, e in errs.items():
        check(e <= 1e-3, f"small world: {k} differs from JAX by {e}")
    emit(phase="small_world_vs_jax", census=res.map_pos.shape[0],
         max_abs_diff=errs, tolerance=1e-3)


def launches_and_syncs(fn):
    """Run ``fn`` twice: once with PyTorch's sync debug mode, which warns
    at every synchronizing CUDA operation (host syncs by source line),
    once under torch.profiler (kernel launches and device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sync_sites = {}
    for wrn in caught:
        if "synchroniz" in str(wrn.message):
            line = f"{os.path.relpath(wrn.filename, HERE)}:{wrn.lineno}"
            sync_sites[line] = sync_sites.get(line, 0) + 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    launches = sum(e.count for e in events if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
        "cuLaunchKernelEx"))

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: -dev_us(e))
    return dict(
        kernel_launches=launches, host_syncs=sum(sync_sites.values()),
        sync_sites=sync_sites, wall_ms_profiled=wall * 1e3,
        device_busy_ms=sum(dev_us(e) for e in kernels) / 1e3,
        top_kernels_ms_count=[[e.key[:70], dev_us(e) / 1e3, e.count]
                              for e in kernels[:6]])


def phase_profile(smi):
    """Launches and syncs of the init and of one refine sweep; warm
    main-path timings."""
    import torch
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.core.energy import weights
    from icm_slam_tpu_torch.data.datasets import synthetic_world
    from icm_slam_tpu_torch.mapping.landmark_map import filter_map
    from icm_slam_tpu_torch.solver import icm
    from icm_slam_tpu_torch.solver.sweeps import init_sweep_batched

    ds = synthetic_world(T=1833, seed=0)
    res = icm.run(ds, ICMConfig(), "cuda")
    t = res.timings
    emit(phase="main_path_warm", prepare_s=t["prepare_s"],
         init_s=t["init_s"], refine_per_iter_s=t["refine_per_iter_s"],
         refine_frames_per_s=1833 / t["refine_per_iter_s"],
         census=res.map_pos.shape[0], card=smi)

    cfg = ICMConfig()
    data = icm.prepare(ds, cfg, "cuda")
    cfg = icm.resolve_config(cfg, data)
    x0 = torch.as_tensor(ds.x0, device="cuda").float()
    w = weights(cfg, "cuda")
    seed = icm.seed_map(data, x0, cfg)
    state, x, _ = init_sweep_batched(data, seed, x0, cfg, w)
    emit(phase="init_profile", **launches_and_syncs(
        lambda: init_sweep_batched(data, seed, x0, cfg, w)),
        note="init_sweep_batched (58 chunks of 32 frames, R=2)", card=smi)

    cur = filter_map(state, cfg.cota, cfg.dist_thr, live_cap=cfg.map_run_cap)
    data = icm.hoist_compaction(data, cfg)
    cur, x, _ = icm._refine_step(data, cur, x, cfg, w)
    emit(phase="refine_sweep_profile", **launches_and_syncs(
        lambda: icm._refine_step(data, cur, x, cfg, w)),
        note="one refine sweep + map filter, after one warm sweep",
        card=smi)


def main():
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check runs only on a GPU")
    from icm_slam_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    _build.library()
    emit(phase="device", device=name, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         numpy=np.__version__, build_s=time.perf_counter() - t0,
         library=os.path.relpath(_build.library_path(), HERE))

    k1 = phase_k1()
    k2 = phase_k2()
    g = np.load(GOLDEN)
    launches = phase_main(g, smi)
    phase_small(g)
    phase_profile(smi)

    kernels = [
        dict(name="associate_and_sums", route="cuda",
             source="icm_slam_tpu_torch/csrc/assoc_sums.cu",
             replaces="icm_slam_tpu/ops/assoc_sums_pallas.py:70",
             launches=launches["k1"], **k1),
        dict(name="nearest_landmark", route="cuda",
             source="icm_slam_tpu_torch/csrc/nearest_landmark.cu",
             replaces="icm_slam_tpu/ops/assoc_pallas.py:76",
             launches=launches["k2"], **k2),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
