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
   {0, 1, 7, 9, 37, 128}, and at shapes with more beams than one round of
   either pass, a width that is no multiple of 4 and duplicated columns:
   labels exact, d2min bitwise, sums atol 1e-4 and bitwise between two
   runs; the wrapper's issue interval;
3. K2 (nearest landmark) against its plain version at the batched shapes
   the paths give it, (1833, 48, 1024) and (1833, 48, 128) (the first 128
   rows of a table of 2048, where the grouped kernel turns from its
   groups of 32 columns to a column-by-column scan), nact in {0, 1, 37,
   127, 128, 1000, 1024}, through the wrapper and with every variant of
   its launch plan (32 lanes a point, the grouped kernel at three block
   sizes); then a table wider than a block keeps in shared memory (two
   chunks, the last ragged) and exact d^2 ties that straddle lanes and
   chunks: labels exact, distances atol 1e-5 (ties: exact); the wrapper's
   issue interval;
4. the main path: ``run(synthetic_world(T=1833, seed=0), ICMConfig(),
   "cuda")`` (N=30, L=1024), held against the JAX package's golden file
   (tests/golden/torch_slice_synth_T1833_N30.npz, made by
   tools/make_torch_golden.py): the world's checksum must match, the
   census must be exact, the ATE against the world's truth within 10% of
   JAX's; the pose difference to JAX is printed;
5. the uncapped branch: the same world with map_run_cap=0 and N=3;
   launch counts: K1 exactly 30 in run 4 and K2 exactly 3 in run 5 (on
   the card every batched sweep after a run's first is a CUDA-graph
   replay, ``solver.cuda_graph``, which counts the launches it replays);
6. the small world of tests/test_torch_slice.py on the card against its
   golden: census exact, poses and map within 1e-3;
7. warm timings of the main path, and the kernel launches
   (torch.profiler) and host syncs (PyTorch's sync debug mode) of the
   init's first 8 chunks and of one refine sweep;
8. the sequential engine: ``run(world, ICMConfig(sweep_mode="sequential",
   N=1), "cuda")`` against the JAX golden
   tests/golden/torch_engines_synth_T1833.npz (case ``seq1_``): census
   exact, ATE within 10%; K2 launched exactly (T-1) + N*T times (once per
   frame through ``landmark_map.update``), K1 never; its init and sweep
   times; launches and host syncs of one sequential sweep over the
   world's first 8 frames (16 until PR 6);
9. the non-quirk Jacobi engine: ``ICMConfig(replicate_new_obs_quirk=
   False, pose_update="jacobi", N=3, L=2048)`` (the causal init, then
   batched sweeps with connected-component labels; at L=1024 the first
   sweep overflows the table, in JAX as here) against the same golden:
   census exact, ATE within 10%, K2 exactly (T-1) + N, K1 never;
10. K2 at the per-frame shapes (1, 181, 1024) and (1, 48, 2048) against
   its plain version, the wrapper and every variant, nact in {0, 1, 31,
   33, 37, 127, 128, L - 1, L}, and on the tie tables: labels exact,
   distances atol 1e-5; the plan must spread one frame over more than one
   block;
11. the entry points: ``api.run_offline`` with checkpoints (N=6, every 2)
   and a resume after deleting the last two checkpoints (census equal,
   poses atol 1e-3: the card's scatters add in no fixed order);
   ``api.run_online`` over ``stream_dataset`` of the world's first 400
   frames with the sequential init against the offline causal init from
   the same first pose (census equal, x_init atol 1e-3; the whole world
   until PR 5, 600 frames in PR 5); ``python -m icm_slam_tpu_torch run`` and
   ``replay`` as subprocesses on the card, each file they write checked;
12. the kernel table: the card's launch floor, then for every shape a
   path above gave a kernel (KERNEL_SHAPES; the runs' launches are
   counted by shape, and a shape that is not in the table fails the
   script), each at nact = the table's width and at the live counts the
   runs above left, the kernel's own duration (``graph_us``: launches captured in a
   CUDA graph, the replay timed; beside it torch.profiler's self device
   time), the wrapper's issue interval (``cuda_ms``: back-to-back calls,
   which for a short kernel measures the host), the bound and what bounds
   it; then both variants of K2 at each of its shapes, so that the one
   ``launch_plan`` picks stands beside the other.  Where a checkout of
   another commit's package lies under build/parent/ (never committed;
   ``mkdir -p build/parent && git archive HEAD~1 icm_slam_tpu_torch | tar
   -x -C build/parent``), the same table of both, in turns old, new, new,
   old, each turn a process of its own.  K3's rows (W, K) are in the same
   table, at n = K and at the fewest live rows the runs left, each held
   bitwise to the plain walk on its inputs.

13. custom energy hooks on the batched engines: the T=1833 world with
   ``ICMConfig(N=3, init_mode="batched")`` and the hooks of
   tests/test_extensions.py (``obs_scale = 1/(1+dist)``, ``extra_one_sided
   = extra_two_sided = 5 (x[:2] - odo_cur[:2])``), against the JAX golden
   tests/golden/torch_models_synth.npz (made by tools/make_torch_golden.py):
   census exact, ATE within 10%, K1 exactly N times;
14. a replaced observation model (the robust soft-gated h of
   tests/test_extensions.py) on the small world, L=256, cota=20, N=3: a
   model sends the init to the causal sweep (K2 once per frame), then N
   capped sweeps (K1 N times): census exact, poses and map within 1e-3;
15. ``sweep_mode="ba"``, N=3, on the T=1833 world: census exact, ATE within
   10%, K1 exactly N times; then one ``ba_refine`` call from the run's
   state reports its energy after each GN step, which must not increase;
16. ``sweep_mode="windowed_ba"``, N=3, ``ba_window=64``: the same checks;
   the global BA energy before and after one ``windowed_ba_refine`` call
   from the run's state must not increase;
17. loop closure on the default world of benchmarks/loop_closure_eval.py
   (``drifted_world(T=2000, ...)``): ``close_loops`` on the golden's JAX
   ICM trajectory (N=15, L=1024, cota=10) with the golden's arguments
   (3 rounds of detect -> pose-graph correct): each round's applied flag
   and closure count, and the final accepted pairs, equal JAX's; the ATE
   after closure within 10% of JAX's; then ``python -m
   icm_slam_tpu_torch run --dataset synthetic --frames 600 --iters 3
   --loop-close`` as a subprocess, its file and its printed closure count
   checked.
   Phases 13, 15 and 16 also profile one sweep from the run's state
   (kernel launches, host syncs), as phase 7 does.
18. fleet mode (``solver.icm.run_batched``): (a) both kernels with a world
   axis against their plain versions, K1 at (8, 1833, 48, 128) and
   (8, 1833, 152, 128), K2 at (4, 1833, 48, 1024) and (4, 1833, 104, 1024)
   through the wrapper and every variant, another live count in every
   world (0, 1, ragged, the width): labels exact, d2min bitwise, K2
   distances within 1e-5, sums within 1e-4 and bitwise run to run, each
   world's slice bitwise the launch on that world alone; (b) two small
   fleets against JAX's ``run_batched`` (tests/golden/
   torch_fleet_synth.npz): the worlds of tests/test_torch_fleet.py (census
   exact, poses and map within 1e-3) and the rounding-sensitive worlds of
   tests/test_fleet.py (census exact, ATE within 10%); (c) the fleet curve,
   ``synthetic_world(T=1833, seed=s)`` for s < W with ``ICMConfig()``,
   W = 1, 2, 4, 8, each timed after a warm run: the merged config's
   branch, prepare_s, init_s, refine_per_iter_s, pipeline_s, per_world_s
   and the aggregate refine frames/s W * T / refine_per_iter_s; K1
   exactly N times at every W; W=2's worlds against JAX's run_batched
   (census exact, ATE within 10%), W=8's first and last world against
   ``run()`` with the merged config (census exact, ATE within 10%, poses
   bitwise), and the last world's ``run()`` twice (bitwise: every scatter
   adds in a fixed order, ``landmark_map.add_rows``); (d)
   kernel launches, host syncs and busy time of one fleet sweep and of
   the init's first 8 chunks at W=8 against W=1's (phase 7's profiles:
   ``run()`` is the fleet of one): launches within 5%, the same syncs,
   none in a sweep (one before K3: ``filter_map``'s walk on the host);
   (e) an uncapped fleet of four (map_run_cap=0, N=3): K2 exactly N
   times, each world's census and poses those of ``run()``.
   The fleet shapes have rows in the kernel table (phase 12), their bound
   W times a world's.
19. ``python -m icm_slam_tpu_torch online`` as a subprocess on the card
   against a rosbridge loopback (``runtime.fake_rosbridge``) that this
   script serves, its ``roslibpy`` the loopback's client (a one-line
   module on its PYTHONPATH), fed 600 frames of ``synthetic_world()`` by
   ``publish_to_rosbridge`` at 50 times real time and stopped by the
   SetBool service: its file against ``api.run_online`` over the same
   frames (census equal, x_init within 1e-3); the synchronizer's stats.

20. fleet mode in every configuration (``run_batched`` with the world axis
   through the causal engines and ``models/``): (a) K2 at the per-frame
   fleet shapes (4, 1, 181, 1024), (4, 1, 104, 2048), (4, 1, 104, 1024) and
   the small fleets' (3, 1, 181, 256), (3, 1, 16, 256), at the sweep shapes
   (4, 400, 104, 128 of 2048) and (3, 120, 16, 256), K1 at (4, 1833, 104,
   128) and (4, 400, 104, 128 of 1024), another live count in every world:
   against their plain versions (labels exact, distances within 1e-5) and
   each world bitwise its launch alone, K2 at the per-frame shapes with
   the d^2 and the sqrt key (``landmark_map.update``'s);
   (b) the small fleets of
   ``synthetic_world(T=120, n_landmarks=10, seed=s)``, s = 7, 10, 11, in
   six configurations (hooks on the batched init, ``ba``, ``windowed_ba``,
   non-quirk labels, ``init_mode="sequential"``, ``sweep_mode=
   "sequential"``) against JAX's ``run_batched`` (tests/golden/
   torch_fleet_modes_synth.npz): census exact, poses and map within 1e-3
   (the one cell JAX's own rounding moves past it: census and ATE); (c)
   the same six at W=4 at full width: hooks, ``ba``, ``windowed_ba`` (N=3)
   on ``synthetic_world(T=1833, seed=s)``, s < 4, the causal-init ones
   (non-quirk Jacobi at L=2048, ``init_mode="sequential"`` (N=3),
   ``sweep_mode="sequential"`` (N=1)) on their first 400 frames: launches
   exact (K2 T - 1 times for a causal init and T times for a sequential
   sweep, whatever W), worlds 0 and 3 (causal: world 0) against
   ``run()`` with the merged config (census equal, ATE within 10%), the
   init's and a sweep's time against world 0's ``run()`` (W = 1),
   launches and host syncs of a sweep (``ba``: one GN step; sequential: 4
   frames) and of the init's first 4 frames at W=4 against W=1 (within
   5%, the same syncs); (d) phases 15-16's runs, phase 17's ``close_loops``
   and the ``ba`` fleet a second time: bitwise the first (the models'
   sums add in a fixed order, ``landmark_map.add_rows``).

21. ``parallel/`` on the card, a process group of one rank: (a)
   ``parallel.distributed.initialize()`` from the environment
   (``ICM_COORDINATOR`` on a free local port, ``ICM_NUM_PROCESSES=1``,
   ``ICM_PROCESS_ID=0``) forms an NCCL group; (b) worlds 0-3 of phase 18's
   curve through ``run_batched(..., mesh=make_fleet_mesh())``: each world
   bitwise phase 18's W=4 result, its ``pipeline_s`` beside phase 18's,
   K1 exactly N times, the collectives it issued; (c) the T=1833 world's
   init and filtered map from ``run(..., n_iters=0)``, then 3 sweeps of
   ``refine_sweep_batched(..., mesh=make_mesh())`` on
   ``shard_sweep_inputs(..., pad_to=8)`` (T padded to 1840, ``last_t``
   1832), each followed by ``filter_map``, against 3 unsharded sweeps from
   the same start: census exact, poses within 1e-3 (the difference
   printed; bitwise expected), K1 exactly 3 times at (1840, 48, 128),
   where it is first held against its plain version (its last 7 frames
   all-masked, as the padding is);
   launches, host syncs and collectives of a sharded sweep beside an
   unsharded one; (d) ``pipeline_stages`` at one stage on the NCCL group,
   exact; ``pipelined_refine_pass`` needs three ranks and is not run (its
   line says so; tests/test_torch_parallel_pipeline.py holds it on gloo
   CPU ranks).

22. the profiling and plotting modules around the main path: (a)
   ``api.run_offline(world, ICMConfig(N=3), "cuda", live_plot=recorder)`` on
   the T=1833 world (a recorder with ``LivePlot.update``'s signature: the
   card's machine has no matplotlib): exactly 3 updates of NumPy (1833, 3)
   poses and (n, 2) landmarks, the last bitwise the result, the result
   bitwise the run without the live plot (runs in turns live, plain, plain,
   live, each ``refine_per_iter_s`` printed), K1 exactly 3 times; (c)
   ``PhaseTimer`` around 100 launches of K2 at (4, 1833, 104, 1024) with
   ``block_on`` reads at least 0.9 of their CUDA-event time (the phase
   without it beside); then, as processes at once: (b)
   ``utils.profiling.device_trace`` of one refine sweep + map filter
   (``--trace-sweep``, a process of its own) into build/chip_smoke/trace/:
   its kernel events within 1% of the profiler's launch count for the same
   sweep, K1 and K3 once, no host sync, the file's size and its export's
   seconds; (d) ``python -m
   icm_slam_tpu_torch run --dataset synthetic --frames 200 --iters 1 --plot
   DIR``: without matplotlib it exits non-zero naming it and prints no
   summary, with it both PNGs are over 1,000 bytes (the branch taken is
   printed); (e) examples_torch/06_fleet_mode.py and 02_online_streaming.py
   (200 frames) with ``--device cuda``: exit 0 and a census.

23. K3 and the sweeps replayed from one CUDA graph: (a) K3
   (``ops.relabel.relabel_walk``, ``csrc/relabel_walk.cu``) against its
   plain walk at every (W, K) of KERNEL_SHAPES (all that the counted runs
   give it: W in {1, 2, 3, 4, 8}, K in {128, 256, 1024}) and at (1, 2048),
   world 0 walking n in {0, 1, 37, K} rows (the other worlds
   other counts), random and chained close rows: labels bitwise; (b) one
   batched sweep + map filter + ``map_change`` under PyTorch's sync
   debug mode "error" on the T=1833 world capped and uncapped and on the
   fleet of eight (phase 18's worlds): no host sync; (c) N=30 sweeps of
   the main world and of that fleet through ``icm.refine_sweeps`` (one
   eager sweep, the capture, 29 replays, the replays under "error")
   against the same sweeps one by one, in turns eager, graph, graph,
   eager: map, poses, witnesses and changes bitwise between every turn,
   29 replays a graph run, K1 and K3 exactly 30 times and K2 never in
   each; each turn's seconds a sweep, each capture's seconds and a graph
   turn's seconds a replay; then one replay's device time and launches
   under the profiler (its idle share against the replay's seconds).

``--time-kernels ROOT K1NACTS K2NACTS`` prints phase 12's table for the
package under ROOT (what each of those turns runs); ``--trace-sweep``
runs phase 22 (b).

Every run of a main path (phases 4, 5, 8, 9, 11, 13-16, 18, 20-23) counts the
kernel launches with the counters set to 0 just before it and read just
after; the kernels' JSON line sums them.  A ``wall_seconds`` line gives
each phase's seconds (standard error has each as it ends).  Then the
card's ``nvidia-smi`` line and, last, ``{"ok": true, "device": {...}}``.
Without CUDA the script fails.
"""
import functools
import json
import os
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden",
                      "torch_slice_synth_T1833_N30.npz")
GOLDEN_ENGINES = os.path.join(HERE, "tests", "golden",
                              "torch_engines_synth_T1833.npz")
GOLDEN_MODELS = os.path.join(HERE, "tests", "golden",
                             "torch_models_synth.npz")
# scratch files of phases 11 and 19, inside the checkout (build/ is not
# committed)
WORK = os.path.join(HERE, "build", "chip_smoke")
# frames of the T=1833 world that phase 11 streams through run_online and
# the offline causal init it is held to (the whole world until PR 5, 600
# frames in PR 5; cut to keep the script's time as phases 18-20 joined)
ONLINE_FRAMES = 400


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


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def graph_us(fn, reps, replays=7):
    """A kernel's own duration in microseconds: ``reps`` calls of the
    wrapper captured into one CUDA graph (the launchers take PyTorch's
    current stream, which is the capturing stream), the replay timed with
    CUDA events, divided by ``reps``; the median of ``replays`` replays.
    No host work lies between two launches of a replay, so this is the
    kernel plus the card's node-to-node gap (see ``launch_floor``)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) * 1e3 / reps)
    return median(out)


def profiler_us(fn, name_part, reps):
    """Mean self device time in microseconds of the kernels whose name
    holds ``name_part`` over ``reps`` calls (torch.profiler): the
    cross-check of ``graph_us``.  None when the trace holds no such kernel
    (a short window after a long trace in the same process can come back
    empty); nothing else is derived from this figure."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and name_part in e.key:
            total += getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
            count += e.count
    return total / count if count else None


# published peaks of one H100 SXM: f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def kernel_bound_us(kind, T, B, K, nact, W=1):
    """The least time the card could take, in microseconds, and what
    bounds it: 5 flops per point and live column (two subtractions, two
    products, one sum) over the f32 peak, against every input byte read
    once (points, the live columns, the mask for K1, nact) and every
    output byte written once (labels, distances, K1's (T, 3, K) sums)
    over the memory rate."""
    n, live = T * B, min(nact, K)
    flops = 5 * n * live
    byts = n * (8 + 4 + 4) + 8 * live + 4
    if kind == "k1":
        byts += n + 12 * T * K
    ops_us = W * flops / PEAK_F32_FLOPS * 1e6
    bytes_us = W * byts / PEAK_BYTES_PER_S * 1e6
    return max(ops_us, bytes_us), ("operations" if ops_us >= bytes_us
                                   else "bytes")


def dims(shape):
    """(W, T, B, K) of a shape; a shape of three is one world."""
    return (1, *shape) if len(shape) == 3 else tuple(shape)


def shape_bound_us(kind, shape, nact):
    """The bound of a call at ``shape``: a fleet's is W times one
    world's (every world reads and writes its own); K3's is its inputs'
    (``k3_bound_us``)."""
    if kind == "k3":
        return k3_bound_us(*k3_inputs(shape, nact))
    W, T, B, K = dims(shape)
    return kernel_bound_us(kind, T, B, K, nact, W)


# the shapes the paths give the kernels, each with the seed of its inputs:
# K1 on the capped sweep (the T=1833 world, and the small world of phase
# 14); K2 on the uncapped sweep, on the non-quirk sweep (the first 128
# rows of a table of 2048) and once per frame in landmark_map.update (all
# beams at L=1024, compacted beams at L=2048 and, on the small world, at
# L=256); then the fleets of phase 18, (W, T, B, K), B the widest beam
# cap of the fleet's worlds: K1 on the fleet curve's capped sweeps at
# W = 2, 4, 8 (and phase 20's hooks and BA fleets at W = 4) and on the
# small capped fleet, K2 on the uncapped fleet of four and on the small
# uncapped fleet; then phase 20's: K2 once a frame for all worlds of the
# causal fleets (the sequential one on all 181 beams at L=1024, the
# non-quirk and the init_mode="sequential" ones on 104 compacted beams at
# L=2048 and 1024), K2 on the non-quirk fleet's sweeps (the first 128
# columns of 2048), K1 on the causal-init fleet's capped sweeps, and the
# small fleets' K2 (per frame on 181 and 16 beams, per sweep uncapped);
# then K3, (W, K): the map filter of every sweep capped (K = map_run_cap)
# and uncapped (K = L) and the init's merge (K = L), for one world and the
# fleets of 2, 3, 4 and 8 (the small fleets' L = 256)
KERNEL_SHAPES = (("k1", (1833, 48, 128), 1), ("k2", (1833, 48, 1024), 2),
                 ("k2", (1833, 48, 128), 7), ("k2", (1, 181, 1024), 3),
                 ("k2", (1, 48, 2048), 8), ("k1", (240, 16, 128), 14),
                 ("k2", (1, 16, 256), 15),
                 ("k1", (2, 1833, 96, 128), 20),
                 ("k1", (4, 1833, 104, 128), 30),
                 ("k1", (8, 1833, 152, 128), 40),
                 ("k2", (4, 1833, 104, 1024), 50),
                 ("k1", (3, 240, 48, 128), 60),
                 ("k2", (3, 300, 136, 256), 70),
                 ("k2", (4, 1, 181, 1024), 80),
                 ("k2", (4, 1, 104, 2048), 84),
                 ("k2", (4, 1, 104, 1024), 88),
                 ("k2", (4, 400, 104, 128), 92),
                 ("k1", (4, 400, 104, 128), 96),
                 ("k2", (3, 1, 181, 256), 100),
                 ("k2", (3, 1, 16, 256), 104),
                 ("k2", (3, 120, 16, 256), 108),
                 ("k1", (1840, 48, 128), 112),
                 ("k3", (1, 128), 120), ("k3", (1, 1024), 121),
                 ("k3", (2, 128), 122), ("k3", (2, 1024), 123),
                 ("k3", (3, 128), 124), ("k3", (3, 256), 125),
                 ("k3", (4, 128), 126), ("k3", (4, 1024), 127),
                 ("k3", (8, 128), 128), ("k3", (8, 1024), 129))
# tables whose first K columns a kernel searches, as the paths pass them:
# the non-quirk sweep's K2, and a fleet's K1 (the first map_run_cap
# columns of each world's L)
TABLE_WIDTH = {("k2", (1833, 48, 128)): 2048,
               ("k1", (2, 1833, 96, 128)): 1024,
               ("k1", (4, 1833, 104, 128)): 1024,
               ("k1", (8, 1833, 152, 128)): 1024,
               ("k1", (3, 240, 48, 128)): 256,
               ("k2", (4, 400, 104, 128)): 2048,
               ("k1", (4, 400, 104, 128)): 1024}
KERNEL_NAME_PART = {"k1": "assoc_sums", "k2": "nearest_landmark",
                    "k3": "relabel_walk"}


def shape_inputs(kind, shape):
    """The inputs of one row of KERNEL_SHAPES (any other shape: seed 9);
    a table in TABLE_WIDTH is the first rows of a wider one.  A fleet's
    worlds take seeds seed, seed + 1, ..."""
    import torch
    seed = {s[:2]: s[2] for s in KERNEL_SHAPES}.get((kind, shape), 9)
    W, T, B, K = dims(shape)
    wide = TABLE_WIDTH.get((kind, shape), K)
    worlds = [kernel_inputs(T, B, wide, seed=seed + w, pick_from=K)
              for w in range(W)]
    if len(shape) == 3:
        pts, mp, mask = worlds[0]
        return pts, mp[:K], mask
    pts, mp, mask = (torch.stack(f) for f in zip(*worlds))
    return pts, mp[:, :K], mask


def kernel_call(kind, shape, nact, plain=False):
    """A closure that calls the kernel's wrapper (``plain``: its plain
    version) at ``shape`` with ``nact`` live columns, on inputs that stay
    where they are (warm in L2, as the callers find them).  K2 at a
    per-frame shape (one frame, T = 1) takes the sqrt key, as
    ``landmark_map.update``, its one caller there, does.  K3 walks
    ``nact`` rows in world 0 (``k3_inputs``)."""
    import torch
    from icm_slam_tpu_torch.ops import assoc as k2
    from icm_slam_tpu_torch.ops import assoc_sums as k1
    from icm_slam_tpu_torch.ops import relabel as k3
    if kind == "k3":
        ins = k3_inputs(shape, nact)
        walk = k3.relabel_walk_plain if plain else k3.relabel_walk
        return lambda: walk(*ins)
    pts, mp, mask = shape_inputs(kind, shape)
    n = count_tensor(nact, None if len(shape) == 3 else dims(shape)[0])
    if kind == "k1":
        if plain:
            return lambda: k1.associate_and_sums_plain(pts, mp, mask, n, 1.0)
        return lambda: k1.associate_and_sums(pts, mp, mask, n, 1.0)
    sqrt_key = dims(shape)[1] == 1
    if plain:
        return lambda: k2.nearest_landmark_plain(pts, mp, n,
                                                 sqrt_key=sqrt_key)
    return lambda: k2.nearest_landmark(pts, mp, n, sqrt_key)


def kernel_variant(kind, shape):
    """The launch variant the wrapper takes at this shape, as a string."""
    from icm_slam_tpu_torch.ops import assoc as k2
    from icm_slam_tpu_torch.ops import assoc_sums as k1
    from icm_slam_tpu_torch.ops import relabel as k3
    if kind == "k3":
        return " ".join(f"{k}={v}" for k, v in
                        k3.launch_plan(shape[1])._asdict().items())
    mod = k2 if kind == "k2" else k1
    if not hasattr(mod, "launch_plan"):
        return "one launch shape"
    W, T, B, K = dims(shape)
    plan = mod.launch_plan(T * B, K, T == 1) if kind == "k2" \
        else mod.launch_plan(T, B, K)
    worlds = f"{W} worlds, each " if W > 1 else ""
    key = ", sqrt key" if kind == "k2" and T == 1 else ""
    return worlds + " ".join(f"{k}={v}" for k, v in
                             plan._asdict().items()) + key


def kernel_row(kind, shape, nact, profiled=True):
    """One row of the kernel table, every time measured here; K3's labels
    are held bitwise to the plain walk's on the row's inputs."""
    import torch
    fn = kernel_call(kind, shape, nact)
    if kind == "k3":
        check(torch.equal(fn(), kernel_call(kind, shape, nact, True)()),
              f"K3 labels differ from the plain walk at {shape} n={nact}")
    small = kind == "k3" or dims(shape)[1] == 1
    own = graph_us(fn, reps=400 if small else 100)
    issue = cuda_ms(fn, reps=400 if small else 100) * 1e3
    bound, by = shape_bound_us(kind, shape, nact)
    plain_ms = cuda_ms(kernel_call(kind, shape, nact, plain=True), reps=10)
    row = dict(kernel=kind, shape=list(shape), nact=nact,
               variant=kernel_variant(kind, shape), own_us=own,
               issue_us=issue, bound_us=bound, bound_by=by,
               share_of_bound=bound / own, plain_ms=plain_ms)
    if profiled:
        row["profiler_us"] = profiler_us(fn, KERNEL_NAME_PART[kind], 50)
    return row


def launch_floor():
    """The card's floor for one launch: K2 on one point against a table of
    one column, none of them live, timed like every row."""
    fn = kernel_call("k2", (1, 1, 1), 0)
    return dict(own_us=graph_us(fn, reps=400),
                issue_us=cuda_ms(fn, reps=400) * 1e3,
                profiler_us=profiler_us(fn, KERNEL_NAME_PART["k2"], 50))


def kernel_table(nacts_as_run, profiled=True, worlds=True):
    """Rows for every shape at nact = the table's width and at each live
    count the runs left (``nacts_as_run``: kind -> counts, or (kind,
    shape) -> counts for a shape of its own; a fleet's row gives every
    world the same count; a kind without counts has no rows).
    ``worlds=False`` leaves out the fleets' shapes (a package from before
    fleet mode has none)."""
    rows = []
    for kind, shape, _ in KERNEL_SHAPES:
        if kind not in nacts_as_run or (len(shape) == 4 and not worlds):
            continue
        counts = nacts_as_run.get((kind, shape), nacts_as_run[kind])
        for nact in [shape[-1]] + sorted(set(counts), reverse=True):
            rows.append(kernel_row(kind, shape, nact, profiled))
    return rows


def time_kernels_main(root, nacts):
    """``--time-kernels ROOT K1NACTS K2NACTS``: the kernel table of the
    package under ROOT as one JSON line.  The old-against-new turns run
    this in a process of its own for each turn, so a checkout of another
    commit can be timed on the same card in the same call."""
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no GPU")
    from icm_slam_tpu_torch.ops import _build
    _build.library()
    print(json.dumps(dict(root=os.path.relpath(root, HERE),
                          floor=launch_floor(),
                          rows=kernel_table(nacts, worlds=False))),
          flush=True)


def k2_variants_timed(nacts):
    """Own duration of both variants of K2 (32 lanes a point at 256
    threads a block, the grouped kernel at 128) at each of its shapes, at
    nact = the table's width and at the live counts the runs left, with
    the variant ``launch_plan`` picks: the choice, shown where it is made."""
    from icm_slam_tpu_torch.ops import assoc as k2
    out = []
    for kind, shape, _ in KERNEL_SHAPES:
        if kind != "k2":
            continue
        W, T, B, L = dims(shape)
        pts, mp, _ = shape_inputs(kind, shape)
        counts = [L] + sorted({n for n in nacts.get((kind, shape),
                                                    nacts["k2"]) if n < L},
                              reverse=True)
        row = dict(shape=list(shape), nact=counts,
                   picked=k2.launch_plan(T * B, L).lanes, own_us={})
        for lanes, threads in ((32, 256), (1, 128)):
            plan = k2.plan_for(T * B, L, lanes=lanes, threads=threads)
            times = []
            for n in counts:
                nact = count_tensor(n, None if len(shape) == 3 else W)
                times.append(graph_us(
                    lambda: k2.launch(pts, mp, nact, plan),
                    reps=400 if T == 1 else 100, replays=5))
            row["own_us"][f"lanes={lanes} threads={threads}"] = times
        out.append(row)
    return out


def kernel_inputs(T, B, K, seed, pick_from=None):
    """Beam points scattered around a random map, as on the main path
    (``pick_from``: around its first columns only)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    mp = rng.uniform(-15.0, 15.0, (K, 2)).astype(np.float32)
    pick = rng.integers(0, pick_from or K, (T, B))
    pts = (mp[pick] + rng.normal(0.0, 0.8, (T, B, 2))).astype(np.float32)
    mask = rng.uniform(size=(T, B)) < 0.7
    dev = torch.device("cuda")
    return (torch.from_numpy(pts).to(dev), torch.from_numpy(mp).to(dev),
            torch.from_numpy(mask).to(dev))


def count_tensor(n, W=None):
    """``n`` as a live count on the card: 0-d, or (W,) with each world's
    count (``n`` a number is every world's)."""
    import torch
    if W is None:
        return torch.tensor(n, dtype=torch.int32, device="cuda")
    return torch.as_tensor(n, dtype=torch.int32, device="cuda").expand(
        W).contiguous()


def hold_k1(pts, mp, mask, n, dist_thr, what):
    """K1 against its plain version: labels exact, d2min bitwise, sums
    within 1e-4 (f32 sums in another order), and the sums of a second run
    bitwise those of the first (no atomics).  Returns the sums' error."""
    import torch
    from icm_slam_tpu_torch.ops import assoc_sums as k1
    nact = count_tensor(n)
    lab, d2, sums = k1.associate_and_sums(pts, mp, mask, nact, dist_thr)
    again = k1.associate_and_sums(pts, mp, mask, nact, dist_thr)[2]
    lab_p, d2_p, sums_p = k1.associate_and_sums_plain(pts, mp, mask, nact,
                                                      dist_thr)
    torch.cuda.synchronize()
    check(torch.equal(lab, lab_p), f"K1 labels differ, {what} nact={n}")
    check(torch.equal(d2, d2_p), f"K1 d2min not bitwise, {what} nact={n}")
    check(torch.equal(sums, again),
          f"K1 sums differ between two runs, {what} nact={n}")
    e = float((sums - sums_p).abs().max()) if sums.numel() else 0.0
    check(e <= 1e-4, f"K1 sums differ by {e}, {what} nact={n}")
    return e


def phase_k1(T=1833, B=48, K=128, dist_thr=1.0):
    import torch
    from icm_slam_tpu_torch.ops import assoc_sums as k1
    pts, mp, mask = kernel_inputs(T, B, K, seed=1)
    err = 0.0
    for n in (0, 1, 7, 9, 37, K):
        err = max(err, hold_k1(pts, mp, mask, n, dist_thr, "main shape"))
    # beams beyond one round of either pass, a width that is no multiple
    # of 4 (scalar stores) and duplicated columns in different lanes
    # the small world's capped sweep (phase 14)
    p14, m14, mask14 = shape_inputs("k1", (240, 16, 128))
    for n in (0, 1, 7, 37, 128):
        err = max(err, hold_k1(p14, m14, mask14, n, dist_thr,
                               "(240, 16, 128)"))
    odd = [[240, 16, 128]]
    for (t, b, k), seed in (((65, 181, 128), 11), ((33, 48, 130), 12),
                            ((9, 5, 8), 13)):
        p2, m2, k2mask = kernel_inputs(t, b, k, seed=seed)
        m2[k // 2] = m2[1]
        m2[k - 1] = m2[1]
        for n in (0, 3, k - 1, k):
            err = max(err, hold_k1(p2, m2, k2mask, n, 2.0, f"{(t, b, k)}"))
        odd.append([t, b, k])
    nact = count_tensor(K)
    ms, plain_ms = time_pair(
        lambda: k1.associate_and_sums(pts, mp, mask, nact, dist_thr),
        lambda: k1.associate_and_sums_plain(pts, mp, mask, nact, dist_thr),
        reps=50)
    emit(phase="k1_vs_plain", shape=[T, B, K], nact=[0, 1, 7, 9, 37, K],
         other_shapes=odd, labels="exact", d2min="bitwise",
         sums_run_to_run="bitwise", sums_max_abs_err=err,
         issue_interval_ms=ms, plain_ms=plain_ms,
         plan=k1.launch_plan(T, B, K)._asdict())
    return dict(max_abs_err=err, plain_ms=plain_ms)


def hold_k2(pts, mp, n, plan, what, sqrt_key=False):
    """K2 with ``plan`` (None: the wrapper's own choice) against its plain
    version, with the d^2 or the sqrt key: labels exact, distances within
    1e-5.  Returns the error."""
    import torch
    from icm_slam_tpu_torch.ops import assoc as k2
    nact = count_tensor(n)
    what = f"{what}{' sqrt key' if sqrt_key else ''}"
    if plan is None:
        lab, dist = k2.nearest_landmark(pts, mp, nact, sqrt_key)
    else:
        lab, dist = k2.launch(pts, mp, nact, plan, sqrt_key)
    lab_p, dist_p = k2.nearest_landmark_plain(pts, mp, nact,
                                              sqrt_key=sqrt_key)
    torch.cuda.synchronize()
    check(torch.equal(lab, lab_p), f"K2 labels differ, {what} nact={n}")
    fin = torch.isfinite(dist_p)
    check(torch.equal(fin, torch.isfinite(dist)),
          f"K2 infinite distances differ, {what} nact={n}")
    e = float((dist - dist_p)[fin].abs().max()) if bool(fin.any()) else 0.0
    check(e <= 1e-5, f"K2 distances differ by {e}, {what} nact={n}")
    return e


def k2_variants(n_pts, L, columns=None):
    """Every variant of K2 as a plan for ``n_pts`` points: 32 lanes a
    point, and the grouped kernel at three block sizes; ``columns`` narrows
    the shared-memory chunk."""
    from icm_slam_tpu_torch.ops import assoc as k2
    kw = {} if columns is None else dict(columns=columns)
    return [k2.plan_for(n_pts, L, lanes=32, **kw),
            k2.plan_for(n_pts, L, lanes=1, threads=64, **kw),
            k2.plan_for(n_pts, L, lanes=1, threads=128, **kw),
            k2.plan_for(n_pts, L, lanes=1, threads=256, **kw)]


def k2_plans(n_pts, L, sqrt_key, columns=None):
    """The wrapper's own choice (None) and every variant that takes the
    key: the sqrt key has the 32-lane kernel only."""
    return [p for p in [None] + k2_variants(n_pts, L, columns)
            if not sqrt_key or p is None or p.lanes == 32]


def sqrt_tie_inputs():
    """Two live columns around a point at the origin whose float32 d^2
    differ by an ulp (the first larger) while their sqrt rounds equal,
    then 38 columns farther off (the points: the origin, a ulp off it):
    the d^2 key takes column 1, the sqrt key column 0, as JAX's
    ``associate`` does."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    while True:
        b = rng.uniform(0.5, 0.9, 2).astype(np.float32)
        r, a = np.float32(np.hypot(*b)), rng.uniform(0, 2 * np.pi)
        ref = np.stack([np.array([r * np.cos(a), r * np.sin(a)],
                                 np.float32), b])
        d2 = torch.from_numpy(ref).pow(2).sum(-1)
        if d2[0] > d2[1] and torch.sqrt(d2[0]) == torch.sqrt(d2[1]):
            break
    far = rng.uniform(3, 9, (38, 2)).astype(np.float32)
    pts = np.zeros((1, 2, 2), np.float32)
    pts[0, 1, 0] = 1e-7
    return (torch.from_numpy(pts).cuda(),
            torch.from_numpy(np.concatenate([ref, far])).cuda())


def tie_inputs():
    """Two tables on which d^2 ties exactly, each with its points.

    The first is built of one block of 40 columns, its mirror image (equal
    d^2 from the origin) and copies of both, with three points at and an
    ulp off the origin.  The second holds 64 distinct columns four times
    each: as neighbouring pairs, then shuffled, then in order, so that
    every one of 181 random points meets a four-way tie whose columns lie
    in neighbouring lanes, in lanes any distance apart and, with a chunk
    of 32 or 64 columns, in different chunks."""
    import numpy as np
    import torch
    rng = np.random.default_rng(6)
    base = rng.uniform(0.5, 0.9, (40, 2)).astype(np.float32)
    mirror = np.concatenate([base, -base, base, base[::-1], -base[:13],
                             base, -base[::-1]])
    origin = np.zeros((1, 3, 2), np.float32)
    origin[0, 1] = 1e-7
    origin[0, 2, 0] = -1e-7
    cols = rng.uniform(-15, 15, (64, 2)).astype(np.float32)
    order = np.concatenate([np.repeat(np.arange(64), 2),
                            rng.permutation(64), np.arange(64)])
    pts = (cols[rng.integers(0, 64, (1, 181))]
           + rng.normal(0, 0.8, (1, 181, 2))).astype(np.float32)
    return [(torch.from_numpy(p).cuda(),
             torch.from_numpy(np.ascontiguousarray(m)).cuda())
            for p, m in ((origin, mirror), (pts, cols[order]))]


def hold_k2_ties(what):
    """Every variant, resident and in chunks of 128, 64 and 32 columns
    (the grouped kernel scans a chunk under 128 column by column), with
    the d^2 and the sqrt key (its variants), on the tie tables: labels and
    distances equal to the plain version's; on the sqrt tie of unequal d^2
    the d^2 key takes column 1 and the sqrt key column 0."""
    import torch
    from icm_slam_tpu_torch.ops import assoc as k2
    sq_pts, sq_map = sqrt_tie_inputs()
    for tie_pts, tie_map in tie_inputs() + [(sq_pts, sq_map)]:
        L, n_pts = tie_map.shape[0], tie_pts.shape[1]
        for sqrt_key in (False, True):
            for columns in (None, 128, 64, 32):
                for plan in k2_plans(n_pts, L, sqrt_key, columns):
                    for n in (1, 2, 39, 40, 41, 80, 120, 173, L):
                        if n > L:
                            continue
                        nact = count_tensor(n)
                        lab, dist = (
                            k2.nearest_landmark(tie_pts, tie_map, nact,
                                                sqrt_key)
                            if plan is None else
                            k2.launch(tie_pts, tie_map, nact, plan,
                                      sqrt_key))
                        lab_p, dist_p = k2.nearest_landmark_plain(
                            tie_pts, tie_map, nact, sqrt_key=sqrt_key)
                        check(torch.equal(lab, lab_p)
                              and torch.equal(dist, dist_p),
                              f"K2 breaks a tie otherwise than its plain "
                              f"version: {what} plan={plan} nact={n} "
                              f"sqrt_key={sqrt_key}")
                        if tie_map is sq_map and n >= 2:
                            check(lab[0, 0].item() == (0 if sqrt_key
                                                       else 1),
                                  f"K2 sqrt_key={sqrt_key} took column "
                                  f"{lab[0, 0].item()} on the sqrt tie")


def hold_k2_shape(shape, nacts):
    """K2 at one of KERNEL_SHAPES, through the wrapper and with every
    variant whichever the wrapper picks; at a per-frame shape (T = 1,
    ``landmark_map.update``'s) with the sqrt key too.  Returns the largest
    error."""
    T, B, L = shape
    pts, mp, _ = shape_inputs("k2", shape)
    err = 0.0
    for sqrt_key in (False, True) if T == 1 else (False,):
        for plan in k2_plans(T * B, L, sqrt_key):
            for n in nacts:
                err = max(err, hold_k2(pts, mp, n, plan, f"{shape} {plan}",
                                       sqrt_key))
    return err


def phase_k2(T=1833, B=48, L=1024):
    from icm_slam_tpu_torch.ops import assoc as k2
    pts, mp, _ = shape_inputs("k2", (T, B, L))
    err = hold_k2_shape((T, B, L), (0, 1, 37, 127, 128, 1000, L))
    # the non-quirk sweep's shape: the first 128 rows of a wider table,
    # where the grouped kernel turns to its column-by-column scan
    check(k2.launch_plan(T * B, 128).lanes == 1, "(1833, 48, 128) not grouped")
    err = max(err, hold_k2_shape((T, B, 128), (0, 1, 37, 96, 127, 128)))
    # a table wider than a block keeps in shared memory: two chunks, the
    # last one ragged
    W = k2.RESIDENT_COLUMNS + 904
    pw, mw, _ = kernel_inputs(16, 181, W, seed=5)
    for plan in [None] + k2_variants(16 * 181, W):
        for n in (k2.RESIDENT_COLUMNS + 1, W - 3, W):
            err = max(err, hold_k2(pw, mw, n, plan, f"wide table {plan}"))
    hold_k2_ties("phase 3")
    nact = count_tensor(L)
    ms, plain_ms = time_pair(lambda: k2.nearest_landmark(pts, mp, nact),
                             lambda: k2.nearest_landmark_plain(pts, mp, nact),
                             reps=20)
    emit(phase="k2_vs_plain", shape=[T, B, L], nact=[0, 1, 37, 127, 128,
                                                      1000, L],
         variants=[p._asdict() for p in k2_variants(T * B, L)],
         other_shapes=[[T, B, 128], [16, 181, W]], labels="exact",
         ties="exact", dist_max_abs_err=err, issue_interval_ms=ms,
         plain_ms=plain_ms, plan=k2.launch_plan(T * B, L)._asdict())
    return dict(max_abs_err=err, plain_ms=plain_ms)


@functools.lru_cache(maxsize=None)
def world_1833():
    """``synthetic_world(T=1833, seed=0)`` and its true poses, made once
    (every phase reads it, none writes it)."""
    from icm_slam_tpu_torch.data.datasets import synthetic_world
    ds, x_true, _ = synthetic_world(T=1833, seed=0, return_truth=True)
    return ds, x_true


def ate_rmse(x, x_true):
    import numpy as np
    return float(np.sqrt(((x[:, :2] - x_true[:, :2]) ** 2).sum(1).mean()))


def golden_case(g, prefix):
    return {k[len(prefix) + 1:]: g[k] for k in g.files
            if k.startswith(prefix + "_")}


def phase_main(g, smi):
    """Run 4 and 5 with the launch counters reset just before each."""
    import numpy as np
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.data.datasets import world_checksum
    from icm_slam_tpu_torch.solver.icm import prepare, resolve_config, run

    gm = golden_case(g, "main")
    ds, x_true = world_1833()
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

    res, n_main = counted(lambda: run(ds, cfg, "cuda"))
    res_u, n_unc = counted(
        lambda: run(ds, ICMConfig(N=3, map_run_cap=0), "cuda"))
    main_k1 = n_main["k1"]
    launches = {"main": n_main, "uncapped": n_unc}
    check(main_k1 == cfg.N and n_main["k2"] == 0,
          f"main run launched K1 {main_k1}x, K2 {n_main['k2']}x; want "
          f"{cfg.N} and 0")
    check(n_unc["k1"] == 0 and n_unc["k2"] == 3,
          f"uncapped run launched K1 {n_unc['k1']}x, K2 {n_unc['k2']}x; "
          f"want 0 and 3")

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
         k2_launches=n_unc["k2"], census=res_u.map_pos.shape[0],
         init_s=res_u.timings["init_s"],
         refine_per_iter_s=res_u.timings["refine_per_iter_s"], card=smi)
    # the live counts the kernels met at the end of these runs
    return launches, {"k1": [census], "k2": [res_u.map_pos.shape[0]]}


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
    from icm_slam_tpu_torch.mapping.landmark_map import filter_map
    from icm_slam_tpu_torch.solver import icm
    from icm_slam_tpu_torch.solver.sweeps import init_sweep_batched

    ds, _ = world_1833()
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
    raw_init = int(state.nact)
    # the init's first 8 chunks: the profiler needs minutes to sum the
    # whole init's ~200k launches, and every chunk runs the same ops
    F = 8 * cfg.init_chunk_len
    head = data._replace(dist=data.dist[:F], mask=data.mask[:F],
                         odom=data.odom[:F], u=data.u[:F])
    init = launches_and_syncs(
        lambda: init_sweep_batched(head, seed, x0, cfg, w))
    emit(phase="init_profile", frames=F, **init,
         note=f"init_sweep_batched over frames 0-{F - 1} (8 chunks of "
              f"{cfg.init_chunk_len} frames, R=2)", card=smi)

    cur = filter_map(state, cfg.cota, cfg.dist_thr, live_cap=cfg.map_run_cap)
    data = icm.hoist_compaction(data, cfg)
    first_nact = int(cur.nact)
    cur, x, wit = icm._refine_step(data, cur, x, cfg, w)
    sweep = launches_and_syncs(lambda: icm._refine_step(data, cur, x, cfg, w))
    emit(phase="refine_sweep_profile", **sweep,
         note="one refine sweep + map filter, after one warm sweep",
        live_columns=dict(raw_after_init=raw_init,
                          first_sweep_sees=first_nact,
                          raw_after_first_sweep=int(wit[0]),
                          second_sweep_sees=int(cur.nact)),
        card=smi)
    # the live counts K1 meets in the first sweeps, before the map settles,
    # and the raw count an init leaves, which the per-frame K2 of a causal
    # init grows towards; the profiles are also phase 18's fleet of one
    # (run() is the batched engine with W = 1)
    return ({"k1": [first_nact, int(cur.nact)], "k2": [raw_init]},
            dict(init_8_chunks=init, sweep=sweep))


def counted(fn):
    """``fn()`` with the kernels' launch counters set to 0 just before it;
    returns (result, {"k1": n, "k2": n, "k3": n, "shapes": {(kernel,
    shape): n}}) read just after.  A sweep replayed from a CUDA graph
    counts the launches its capture made (``solver.cuda_graph``)."""
    from icm_slam_tpu_torch.ops import _build
    _build.LAUNCHES.clear()
    out = fn()
    kinds = {name: kind for kind, name in KERNEL_NAME_PART.items()}
    shapes = {(kinds[name], shape): n
              for (name, shape), n in _build.LAUNCHES.items()}
    return out, {**{kind: _build.launches(name)
                    for kind, name in KERNEL_NAME_PART.items()},
                 "shapes": shapes}


def big_world(golden, prefix):
    """The T=1833 world with its truth, checked against the golden's."""
    from icm_slam_tpu_torch.data.datasets import world_checksum
    ds, x_true = world_1833()
    check(world_checksum(ds) == str(golden[f"{prefix}_world_checksum"]),
          "synthetic_world(T=1833, seed=0) differs from the golden's world")
    return ds, x_true


def hold_to_golden(res, x_true, gc, what):
    """Census exact and ATE within 10% of JAX's; returns the agreement."""
    import numpy as np
    check(all(np.isfinite(a).all() for a in
              (res.x, res.x_init, res.map_pos, res.changes)),
          f"non-finite output in the {what} run")
    check(res.x.shape == gc["x"].shape, f"{what}: pose shape {res.x.shape}")
    census = res.map_pos.shape[0]
    check(census == int(gc["census"]),
          f"{what}: census {census} != JAX golden {int(gc['census'])}")
    ate_port, ate_jax = ate_rmse(res.x, x_true), float(gc["ate_rmse"])
    check(abs(ate_port - ate_jax) <= 0.1 * ate_jax,
          f"{what}: ATE {ate_port} not within 10% of JAX's {ate_jax}")
    return dict(census=census, census_jax=int(gc["census"]),
                ate_rmse_port=ate_port, ate_rmse_jax=ate_jax,
                x_max_abs_diff_vs_jax=float(np.abs(res.x - gc["x"]).max()),
                x_init_max_abs_diff_vs_jax=float(
                    np.abs(res.x_init - gc["x_init"]).max()))


def map_state(res, L):
    """A result's map as a MapState of width L on the card."""
    return map_of(res.map_pos, res.map_counts, L)


def map_of(map_pos, map_counts, L):
    """A map's (n, 2) positions and (n,) counts as a MapState of width L
    on the card."""
    import torch
    from icm_slam_tpu_torch.mapping.landmark_map import MapState
    n = map_pos.shape[0]
    pos = torch.zeros((L, 2), device="cuda")
    counts = torch.zeros((L,), device="cuda")
    pos[:n] = torch.from_numpy(map_pos).cuda()
    counts[:n] = torch.from_numpy(map_counts).cuda()
    return MapState(pos, counts,
                    torch.tensor(n, dtype=torch.int32, device="cuda"))


def phase_sequential(ge, smi):
    """The reference-faithful sequential engine at full width."""
    import torch
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.core.energy import weights
    from icm_slam_tpu_torch.solver import icm

    ds, x_true = big_world(ge, "seq1")
    T, cfg = ds.T, ICMConfig(sweep_mode="sequential", N=1)
    res, n = counted(lambda: icm.run(ds, cfg, "cuda"))
    want = (T - 1) + cfg.N * T
    check(n["k2"] == want and n["k1"] == 0,
          f"sequential run launched K2 {n['k2']}x, K1 {n['k1']}x; want "
          f"{want} and 0")
    agree = hold_to_golden(res, x_true, golden_case(ge, "seq1"),
                           "sequential")
    t = res.timings
    emit(phase="sequential_engine", world="synthetic_world(T=1833, seed=0)",
         config="ICMConfig(sweep_mode='sequential', N=1) L=1024",
         k2_launches=n["k2"], k1_launches=n["k1"], **agree,
         prepare_s=t["prepare_s"], init_s=t["init_s"],
         refine_per_iter_s=t["refine_per_iter_s"],
         init_frames_per_s=(T - 1) / t["init_s"],
         refine_frames_per_s=T / t["refine_per_iter_s"], card=smi)

    # one sequential sweep (+ map filter) over the first 8 frames, from
    # the run's map and poses: launches per frame, host syncs per sweep
    F = 8
    data = icm.prepare(ds.slice(F), cfg, "cuda")
    rcfg = icm.resolve_config(cfg, data)
    w = weights(rcfg, "cuda")
    cur = map_state(res, rcfg.L)
    x = torch.from_numpy(res.x[:F]).cuda()
    icm._refine_step(data, cur, x, rcfg, w)
    prof = launches_and_syncs(lambda: icm._refine_step(data, cur, x, rcfg, w))
    emit(phase="sequential_sweep_profile", frames=F,
         kernel_launches_per_frame=prof["kernel_launches"] / F, **prof,
         note="one sequential sweep + map filter over frames 0-7 of the "
              "T=1833 world, after one warm sweep", card=smi)
    return n, res


def phase_nonquirk_jacobi(ge, smi):
    """Connected-component labels and Jacobi passes at full width."""
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.solver import icm

    ds, x_true = big_world(ge, "nqj")
    gc = golden_case(ge, "nqj")
    cfg = ICMConfig(replicate_new_obs_quirk=False, pose_update="jacobi",
                    N=3, L=2048)
    resolved = icm.resolve_config(cfg, icm.prepare(ds, cfg, "cuda"))
    check(resolved.map_run_cap == int(gc["map_run_cap"])
          and resolved.obs_cap == int(gc["obs_cap"]),
          "non-quirk run: resolved caps differ from the golden's")
    res, n = counted(lambda: icm.run(ds, cfg, "cuda"))
    want = (ds.T - 1) + cfg.N
    check(n["k2"] == want and n["k1"] == 0,
          f"non-quirk run launched K2 {n['k2']}x, K1 {n['k1']}x; want "
          f"{want} and 0")
    agree = hold_to_golden(res, x_true, gc, "non-quirk jacobi")
    t = res.timings
    emit(phase="nonquirk_jacobi_engine",
         config="ICMConfig(replicate_new_obs_quirk=False, "
                "pose_update='jacobi', N=3, L=2048)",
         obs_cap=resolved.obs_cap, map_run_cap=resolved.map_run_cap,
         k2_launches=n["k2"], k1_launches=n["k1"], **agree,
         init_s=t["init_s"], refine_per_iter_s=t["refine_per_iter_s"],
         card=smi)
    return n, res


def phase_k2_per_frame(B=181, L=1024):
    """K2 at the shapes every update() gives it (with either key; update
    takes the sqrt key), and on the tie tables."""
    from icm_slam_tpu_torch.ops import assoc as k2
    pts, mp, _ = shape_inputs("k2", (1, B, L))
    err = 0.0
    for shape in ((1, B, L), (1, 48, 2048), (1, 16, 256)):
        plan = k2.launch_plan(shape[1], shape[2])
        check(plan.lanes == 32 and plan.blocks > 1,
              f"per-frame shape {shape} not spread over blocks: {plan}")
        width = shape[2]
        err = max(err, hold_k2_shape(
            shape, (0, 1, 31, 33, 37, 127, 128, width - 1, width)))
    hold_k2_ties("phase 10")
    nact = count_tensor(L)
    ms, plain_ms = time_pair(lambda: k2.nearest_landmark(pts, mp, nact),
                             lambda: k2.nearest_landmark_plain(pts, mp, nact),
                             reps=200)
    emit(phase="k2_per_frame_vs_plain", shape=[1, B, L],
         other_shapes=[[1, 48, 2048], [1, 16, 256]],
         nact=[0, 1, 31, 33, 37, 127, 128, L - 1, L], labels="exact",
         ties="exact", dist_max_abs_err=err, issue_interval_ms=ms,
         plain_ms=plain_ms, plan=k2.launch_plan(B, L)._asdict())
    return dict(max_abs_err=err, plain_ms=plain_ms)


def _files_written(paths, what):
    for p in paths:
        check(os.path.isfile(p) and os.path.getsize(p) > 0,
              f"{what} did not write {os.path.relpath(p, HERE)}")


def phase_entry_points(seq_res, smi):
    """run_offline with checkpoint/resume, run_online, the CLI."""
    import shutil
    import numpy as np
    from icm_slam_tpu_torch import api
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.data.datasets import Dataset
    from icm_slam_tpu_torch.runtime.replay import stream_dataset
    from icm_slam_tpu_torch.solver import icm

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    ds, _ = world_1833()
    out, totals = {}, {"k1": 0, "k2": 0, "k3": 0, "shapes": {}}

    def tally(n):
        for k in ("k1", "k2", "k3"):
            totals[k] += n[k]
        for key, count in n["shapes"].items():
            totals["shapes"][key] = totals["shapes"].get(key, 0) + count

    # offline, checkpointed every 2 sweeps, then resumed from sweep 1
    ck = os.path.join(WORK, "ckpt")
    cfg = ICMConfig(N=6)
    full, n = counted(lambda: api.run_offline(
        ds, cfg, "cuda", checkpoint_dir=ck, checkpoint_every=2))
    check(n["k1"] == cfg.N, f"run_offline launched K1 {n['k1']}x")
    tally(n)
    ckpts = sorted(f for f in os.listdir(ck) if f.startswith("icm_ckpt_"))
    check(ckpts == ["icm_ckpt_1.npz", "icm_ckpt_3.npz", "icm_ckpt_5.npz"]
          and os.path.isfile(os.path.join(ck, "x_init.npz")),
          f"checkpoints written: {sorted(os.listdir(ck))}")
    for f in ckpts[1:]:
        os.remove(os.path.join(ck, f))
    res, n = counted(lambda: api.run_offline(
        ds, cfg, "cuda", checkpoint_dir=ck, resume=True, checkpoint_every=2))
    check(n["k1"] == cfg.N - 2, f"resume launched K1 {n['k1']}x")
    tally(n)
    check(res.map_pos.shape == full.map_pos.shape,
          f"resume census {res.map_pos.shape[0]} != uninterrupted "
          f"{full.map_pos.shape[0]}")
    check(np.array_equal(res.x_init, full.x_init),
          "resume did not restore x_init")
    out["resume_x_max_abs_diff"] = float(np.abs(res.x - full.x).max())
    out["resume_map_max_abs_diff"] = float(
        np.abs(res.map_pos - full.map_pos).max())
    check(max(out["resume_x_max_abs_diff"],
              out["resume_map_max_abs_diff"]) <= 1e-3,
          f"resume differs from the uninterrupted run: {out}")
    out.update(offline_census=full.map_pos.shape[0],
               offline_refine_per_iter_s=full.timings["refine_per_iter_s"],
               resume_refine_per_iter_s=res.timings["refine_per_iter_s"])

    # online: the streamed causal init against the offline one from the
    # same first pose (the stream starts at the first odometry reading),
    # on the world's first ONLINE_FRAMES frames
    seq0 = ICMConfig(init_mode="sequential", N=0)
    ds = ds.slice(ONLINE_FRAMES)
    t0 = time.perf_counter()
    onl, n = counted(lambda: api.run_online(stream_dataset(ds), seq0, "cuda",
                                            refine=False))
    online_s = time.perf_counter() - t0
    check(n["k2"] == ds.T - 1, f"run_online launched K2 {n['k2']}x")
    tally(n)
    ds_odo = Dataset(ds.scans, ds.odom, ds.u, ds.odom[0].copy(), ds.name)
    off = icm.run(ds_odo, ICMConfig(sweep_mode="sequential", N=0), "cuda")
    check(onl.map_pos.shape == off.map_pos.shape,
          f"run_online census {onl.map_pos.shape[0]} != offline causal "
          f"init's {off.map_pos.shape[0]}")
    out["online_x_init_max_abs_diff"] = float(
        np.abs(onl.x_init - off.x_init).max())
    check(out["online_x_init_max_abs_diff"] <= 1e-3,
          f"run_online x_init differs by {out['online_x_init_max_abs_diff']}")
    out.update(online_census=onl.map_pos.shape[0], online_s=online_s,
               online_frames_per_s=ds.T / online_s,
               online_frames=ds.T,
               online_vs_phase8_x_init_max_abs_diff=float(
                   np.abs(onl.x_init - seq_res.x_init[:ds.T]).max()))

    # the CLI, as a user runs it, in processes of its own
    files = {k: os.path.join(WORK, f) for k, f in (
        ("out", "run.npz"), ("tum", "run_tum.txt"), ("pgm", "run_map.pgm"),
        ("log", "run.jsonl"), ("rout", "replay.npz"))}
    cli = [sys.executable, "-m", "icm_slam_tpu_torch"]
    cmds = [
        ("run", cli + ["run", "--dataset", "synthetic", "--config",
                       os.path.join(HERE, "configs", "reference.yaml"),
                       "--iters", "3", "--out", files["out"],
                       "--export-tum", files["tum"], "--export-map",
                       files["pgm"], "--log", files["log"]],
         [files[k] for k in ("out", "tum", "pgm", "log")]
         + [os.path.join(WORK, "run_map.yaml")]),
        ("replay", cli + ["replay", "--dataset", "synthetic", "--iters", "3",
                          "--out", files["rout"]], [files["rout"]])]
    for name, cmd, written in cmds:
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                              timeout=300)
        check(proc.returncode == 0,
              f"cli {name} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
        _files_written(written, f"cli {name}")
        with np.load(written[0]) as z:
            check(z["x"].shape == (600, 3) and np.isfinite(z["x"]).all()
                  and z["changes"].shape == (3, 3),
                  f"cli {name}: bad result {z['x'].shape}")
        out[f"cli_{name}_s"] = time.perf_counter() - t0
    emit(phase="entry_points", **out, card=smi)
    return totals


def hooks_model():
    """The hooks of tests/test_extensions.py in the port's batched
    convention (x (P, 3), every problem field with a leading P)."""
    from icm_slam_tpu_torch.core.energy import EnergyModel

    def anchor_to_odom(x, prob):
        return 5.0 * (x[:, :2] - prob.odo_cur[:, :2])

    return EnergyModel(obs_scale=lambda dist, ang: 1.0 / (1.0 + dist),
                       extra_one_sided=anchor_to_odom,
                       extra_two_sided=anchor_to_odom)


def robust_obs_model():
    """tests/test_extensions.py's robust soft-gated observation model."""
    import math
    import torch
    from icm_slam_tpu_torch.core.energy import EnergyModel

    def robust_obs(x, p, sqrt_q):
        a = p.ang + x[:, 2:3] - math.pi / 2.0
        pts = x[:, None, :2] + p.dist[..., None] * torch.stack(
            [torch.cos(a), torch.sin(a)], dim=-1)
        r = (pts - p.matched) * sqrt_q
        n2 = (r * r).sum(dim=-1, keepdim=True)
        return torch.where(p.mask[..., None], r / torch.sqrt(1.0 + n2), 0.0)

    return EnergyModel(obs_model=robust_obs)


# the golden names a case's model; these are the same hooks in torch
MODELS = {"hooks": hooks_model, "robust_obs": robust_obs_model}


def sweep_profile(res, cfg, smi, what):
    """Launches and host syncs of one refine sweep (+ map filter) of
    ``cfg`` from a run's final map and poses on the T=1833 world."""
    import torch
    from icm_slam_tpu_torch.core.energy import weights
    from icm_slam_tpu_torch.solver import icm
    ds, _ = world_1833()
    data = icm.prepare(ds, cfg, "cuda")
    rcfg = icm.resolve_config(cfg, data)
    data = icm.hoist_compaction(data, rcfg)
    w = weights(rcfg, "cuda")
    cur = map_state(res, rcfg.L)
    x = torch.from_numpy(res.x).cuda()
    icm._refine_step(data, cur, x, rcfg, w)
    emit(phase=f"{what}_sweep_profile", **launches_and_syncs(
        lambda: icm._refine_step(data, cur, x, rcfg, w)),
        note="one refine sweep + map filter from the run's final state, "
             "after one warm sweep", card=smi)
    return data, cur, x, rcfg, w


def phase_hooks_batched(gm, smi):
    """Custom hooks through the batched init and the batched refine."""
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.solver import icm

    ds, x_true = big_world(gm, "hooks")
    gc = golden_case(gm, "hooks")
    cfg = ICMConfig(N=3, init_mode="batched",
                    model=MODELS[str(gc["model"])]())
    res, n = counted(lambda: icm.run(ds, cfg, "cuda"))
    check(n["k1"] == cfg.N and n["k2"] == 0,
          f"hooks run launched K1 {n['k1']}x, K2 {n['k2']}x; want "
          f"{cfg.N} and 0")
    agree = hold_to_golden(res, x_true, gc, "hooks batched")
    t = res.timings
    emit(phase="hooks_batched", world="synthetic_world(T=1833, seed=0)",
         config="ICMConfig(N=3, init_mode='batched', model=hooks of "
                "tests/test_extensions.py)",
         k1_launches=n["k1"], k2_launches=n["k2"], **agree,
         init_s=t["init_s"], refine_per_iter_s=t["refine_per_iter_s"],
         card=smi)
    sweep_profile(res, cfg, smi, "hooks")
    return n, res


def phase_hooks_causal(gm, smi):
    """A replaced observation model on the small world: the causal init
    (K2 per frame), then capped batched sweeps (K1)."""
    import numpy as np
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.data.datasets import (synthetic_world,
                                                  world_checksum)
    from icm_slam_tpu_torch.solver import icm

    gc = golden_case(gm, "causal")
    ds = synthetic_world(T=240, n_landmarks=12, seed=7)
    check(world_checksum(ds) == str(gc["world_checksum"]),
          "small world differs from the golden's")
    cfg = ICMConfig(L=256, cota=20.0, N=3, model=MODELS[str(gc["model"])]())
    check(not icm.use_batched_init(cfg), "a model must take the causal init")
    res, n = counted(lambda: icm.run(ds, cfg, "cuda"))
    check(n["k2"] == ds.T - 1 and n["k1"] == cfg.N,
          f"causal hooks run launched K2 {n['k2']}x, K1 {n['k1']}x; want "
          f"{ds.T - 1} and {cfg.N}")
    check(res.map_pos.shape[0] == int(gc["census"]),
          f"causal hooks census {res.map_pos.shape[0]} != {int(gc['census'])}")
    errs = {k: float(np.abs(getattr(res, k) - gc[k]).max())
            for k in ("x_init", "x", "map_pos", "changes")}
    for k, e in errs.items():
        check(e <= 1e-3, f"causal hooks: {k} differs from JAX by {e}")
    t = res.timings
    emit(phase="hooks_causal", world="synthetic_world(T=240, "
         "n_landmarks=12, seed=7)", config="ICMConfig(L=256, cota=20, N=3, "
         "model=robust obs_model)", k2_launches=n["k2"], k1_launches=n["k1"],
         census=res.map_pos.shape[0], max_abs_diff=errs, tolerance=1e-3,
         init_s=t["init_s"], init_frames_per_s=(ds.T - 1) / t["init_s"],
         refine_per_iter_s=t["refine_per_iter_s"], card=smi)
    return n, res


# one backend call from JAX's start against JAX's call: poses (atol),
# the live count (exact) and the energy's drop (relative to JAX's drop).
# windowed_ba's (3W x 3W) f32 solves put the port's CPU run 1.8e-3 from
# JAX's poses at T=1833, full-chain BA's 3.8e-6.
ONE_CALL_TOL = {"ba": 1e-3, "windowed_ba": 5e-3}
ONE_CALL_DROP_RTOL = 0.01


def one_backend_call(gm, prefix, mode, data, rcfg, w):
    """``ba_refine`` / ``windowed_ba_refine`` once from the golden's start
    (JAX's final map, its poses perturbed) against JAX's same call: the
    poses, the map, the live count and the BA energy of the start's
    association before and after, so that a call whose steps are all
    rejected, or wrong, fails."""
    import numpy as np
    import torch
    from icm_slam_tpu_torch.models import bundle_adjustment as ba
    from icm_slam_tpu_torch.models.windowed_ba import windowed_ba_refine
    cur = map_of(gm[f"{prefix}_map_pos"], gm[f"{prefix}_map_counts"], rcfg.L)
    x0 = torch.from_numpy(gm[f"{prefix}_one_x_start"]).cuda()
    prob, amap = ba.ba_problem(data, cur, x0, rcfg)
    rep = {}
    if mode == "ba":
        m, x1 = ba.ba_refine(data, cur, x0, rcfg, w,
                             gn_iters=rcfg.ba_gn_iters,
                             cg_iters=rcfg.ba_cg_iters, report=rep)
        y1 = m.pos
        steps = [float(e) for e in rep["energies"]]
    else:
        m, x1 = windowed_ba_refine(data, cur, x0, rcfg, w,
                                   window=rcfg.ba_window)
        y1 = amap.pos
    e = [float(ba.energy(x0, amap.pos, prob, w)),
         float(ba.energy(x1, y1, prob, w))]
    e_jax = [float(v) for v in gm[f"{prefix}_one_energies"]]
    if mode == "ba":
        steps = [e[0]] + steps
    else:
        steps = e
    check(all(b <= a for a, b in zip(steps, steps[1:])),
          f"{mode}: the energy rose within one call: {steps}")
    x1 = x1.cpu().numpy()
    dx = float(np.abs(x1 - gm[f"{prefix}_one_x"]).max())
    dmap = float(np.abs(m.pos.cpu().numpy()
                        - gm[f"{prefix}_one_map_pos"]).max())
    nact, nact_jax = int(m.nact), int(gm[f"{prefix}_one_nact"])
    drop, drop_jax = e[0] - e[1], e_jax[0] - e_jax[1]
    check(nact == nact_jax, f"{mode} one call: nact {nact} != JAX's "
                            f"{nact_jax}")
    check(dx <= ONE_CALL_TOL[mode],
          f"{mode} one call: poses {dx} from JAX's (tolerance "
          f"{ONE_CALL_TOL[mode]})")
    check(dmap <= 1e-3, f"{mode} one call: map {dmap} from JAX's")
    check(abs(e[0] - e_jax[0]) <= 1e-5 * e_jax[0],
          f"{mode} one call: start energy {e[0]} against JAX's {e_jax[0]}")
    check(drop_jax > 0 and abs(drop - drop_jax) <= ONE_CALL_DROP_RTOL
          * drop_jax, f"{mode} one call: energy drop {drop} against "
                      f"JAX's {drop_jax}")
    return dict(one_call_energies=e, one_call_energies_jax=e_jax,
                one_call_energy_steps=steps, one_call_drop=drop,
                one_call_drop_jax=drop_jax, one_call_nact=nact,
                one_call_x_max_abs_diff_vs_jax=dx,
                one_call_map_max_abs_diff_vs_jax=dmap,
                one_call_moved=float(np.abs(
                    x1 - gm[f"{prefix}_one_x_start"]).max()),
                one_call_tolerance=dict(
                    x=ONE_CALL_TOL[mode], map=1e-3, start_energy_rtol=1e-5,
                    drop_rtol=ONE_CALL_DROP_RTOL))


def phase_ba(gm, smi, mode):
    """``sweep_mode="ba"`` or ``"windowed_ba"`` at full width, then one
    backend call held against JAX's (``one_backend_call``)."""
    import torch
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.solver import icm

    prefix = {"ba": "ba", "windowed_ba": "wba"}[mode]
    ds, x_true = big_world(gm, prefix)
    gc = golden_case(gm, prefix)
    cfg = ICMConfig(N=3, sweep_mode=mode)
    res, n = counted(lambda: icm.run(ds, cfg, "cuda"))
    check(n["k1"] == cfg.N and n["k2"] == 0,
          f"{mode} run launched K1 {n['k1']}x, K2 {n['k2']}x; want "
          f"{cfg.N} and 0")
    agree = hold_to_golden(res, x_true, gc, mode)
    data, _, _, rcfg, w = sweep_profile(res, cfg, smi, prefix)
    one = one_backend_call(gm, prefix, mode, data, rcfg, w)
    torch.cuda.synchronize()
    t = res.timings
    emit(phase=f"{mode}_engine", world="synthetic_world(T=1833, seed=0)",
         config=f"ICMConfig(N=3, sweep_mode={mode!r}) ba_gn_iters="
                f"{rcfg.ba_gn_iters} ba_cg_iters={rcfg.ba_cg_iters} "
                f"ba_window={rcfg.ba_window}",
         k1_launches=n["k1"], k2_launches=n["k2"], **agree, **one,
         init_s=t["init_s"], refine_per_iter_s=t["refine_per_iter_s"],
         card=smi)
    return n, res


def phase_loop_closure(gm, smi):
    """close_loops on JAX's ICM trajectory of the loop-closure benchmark's
    world, then the CLI's --loop-close as a user runs it.  Returns the
    call's inputs and its closed poses (data, x, config, arguments,
    closed), for phase 20 (d)."""
    import json as _json
    import numpy as np
    import torch
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.data.datasets import drifted_world, world_checksum
    from icm_slam_tpu_torch.models.loop_closure import close_loops
    from icm_slam_tpu_torch.solver import icm

    gc = golden_case(gm, "loop")
    ds, x_true, _ = drifted_world(T=2000, n_landmarks=150, world_size=50.0,
                                  seed=3, v_noise=0.03, w_noise=0.004,
                                  w_bias=0.001, laps=2)
    check(world_checksum(ds) == str(gc["world_checksum"]),
          "drifted_world(T=2000, seed=3) differs from the golden's world")
    cfg = ICMConfig(N=15, L=1024, cota=10.0)
    data = icm.prepare(ds, cfg, "cuda")
    rcfg = icm.resolve_config(cfg, data)
    kwargs = _json.loads(str(gc["loop_close_kwargs"]))
    report = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_icm = torch.from_numpy(gc["x"]).cuda()
    x, cl = close_loops(data, x_icm, rcfg, report=report, **kwargs)
    x = x.cpu().numpy()
    close_s = time.perf_counter() - t0
    rows = report["rounds"]
    got = [(r["applied"], r["n_closures"]) for r in rows]
    want = [(bool(a), int(c)) for a, c in zip(gc["rounds_applied"],
                                              gc["rounds_n_closures"])]
    check(got == want, f"closure rounds {got} != JAX's {want}")
    check(np.array_equal(cl.pairs, gc["pairs"]),
          f"accepted pairs differ from JAX's ({cl.pairs.shape[0]} against "
          f"{gc['pairs'].shape[0]})")
    check(np.isfinite(x).all() and x.shape == gc["x_closed"].shape,
          "non-finite or misshapen closed trajectory")
    ate_port = ate_rmse(x, x_true)
    ate_jax = float(gc["ate_rmse_closed"])
    check(abs(ate_port - ate_jax) <= 0.1 * ate_jax,
          f"ATE after closure {ate_port} not within 10% of JAX's {ate_jax}")
    out = dict(rounds=rows, pairs=int(cl.pairs.shape[0]),
               ate_rmse_icm=ate_rmse(gc["x"], x_true),
               ate_rmse_closed_port=ate_port, ate_rmse_closed_jax=ate_jax,
               x_closed_max_abs_diff_vs_jax=float(
                   np.abs(x - gc["x_closed"]).max()),
               close_loops_s=close_s)

    # the CLI, as a user runs it, in a process of its own, with the
    # arguments JAX's CLI ran with for the golden (600 frames of
    # synthetic_world(), 3 iterations, --loop-close)
    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, "loop.npz")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "icm_slam_tpu_torch",
         *_json.loads(str(gm["cliloop_args"])), "--out", path],
        cwd=HERE, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0,
          f"cli run --loop-close exited {proc.returncode}:\n"
          f"{proc.stderr[-3000:]}")
    _files_written([path], "cli run --loop-close")
    counts = [int(line.split(":")[1]) for line in proc.stdout.splitlines()
              if line.startswith("# loop closures accepted:")]
    check(len(counts) == 1, "cli run --loop-close printed no closure count")
    want = int(gm["cliloop_closures"])
    check(counts[0] == want, f"cli run --loop-close accepted {counts[0]} "
                             f"closures, JAX's CLI {want}")
    with np.load(path) as z:
        check(z["x"].shape == (600, 3) and np.isfinite(z["x"]).all(),
              f"cli run --loop-close: bad result {z['x'].shape}")
        census = z["map_pos"].shape[0]
        check(census == int(gm["cliloop_census"]),
              f"cli run --loop-close: census {census} != JAX's "
              f"{int(gm['cliloop_census'])}")
        dx = float(np.abs(z["x"] - gm["cliloop_x"]).max())
    out.update(cli_closures=counts[0], cli_closures_jax=want,
               cli_census=census, cli_x_max_abs_diff_vs_jax=dx,
               cli_s=time.perf_counter() - t0)
    emit(phase="loop_closure", world="drifted_world(T=2000, "
         "n_landmarks=150, world_size=50, seed=3, w_bias=0.001, laps=2)",
         close_loops_kwargs=kwargs, **out, card=smi)
    return data, x_icm, rcfg, kwargs, x


GOLDEN_FLEET = os.path.join(HERE, "tests", "golden", "torch_fleet_synth.npz")
FLEET_WS = (1, 2, 4, 8)


@functools.lru_cache(maxsize=None)
def fleet_worlds():
    """``synthetic_world(T=1833, seed=s)``, s = 0..7, with their truths:
    the fleet curve's worlds (world 0 is the main path's)."""
    from icm_slam_tpu_torch.data.datasets import synthetic_world
    return [world_1833()] + [
        tuple(synthetic_world(T=1833, seed=s, return_truth=True)[:2])
        for s in range(1, max(FLEET_WS))]


def hold_k1_worlds(shape, nacts, dist_thr=1.0):
    """K1 with a world axis at ``shape``, another live count in each world:
    against its plain version (labels exact, d2min bitwise, sums within
    1e-4, bitwise run to run) and, world by world, bitwise against the
    launch on that world alone.  Returns the sums' error."""
    import torch
    from icm_slam_tpu_torch.ops import assoc_sums as k1
    pts, mp, mask = shape_inputs("k1", shape)
    W = pts.shape[0]
    nact = count_tensor(nacts, W)
    out = k1.associate_and_sums(pts, mp, mask, nact, dist_thr)
    again = k1.associate_and_sums(pts, mp, mask, nact, dist_thr)
    plain = k1.associate_and_sums_plain(pts, mp, mask, nact, dist_thr)
    torch.cuda.synchronize()
    what = f"K1 {shape} nact={list(nacts)}"
    check(torch.equal(out[0], plain[0]), f"{what}: labels differ")
    check(torch.equal(out[1], plain[1]), f"{what}: d2min not bitwise")
    check(all(torch.equal(a, b) for a, b in zip(out, again)),
          f"{what}: two runs differ")
    err = float((out[2] - plain[2]).abs().max())
    check(err <= 1e-4, f"{what}: sums differ by {err}")
    for w in range(W):
        one = k1.associate_and_sums(pts[w], mp[w].contiguous(), mask[w],
                                    nact[w], dist_thr)
        check(all(torch.equal(a[w], b) for a, b in zip(out, one)),
              f"{what}: world {w} differs from its launch alone")
    return err


def hold_k2_worlds(shape, nacts, sqrt_key=False):
    """K2 with a world axis at ``shape``, with the d^2 or the sqrt key,
    through the wrapper and with every variant that takes the key,
    another live count in each world: against its plain version (labels
    exact, distances within 1e-5) and, world by world, bitwise against the
    same plan's launch on that world alone."""
    import torch
    from icm_slam_tpu_torch.ops import assoc as k2
    pts, mp, _ = shape_inputs("k2", shape)
    W, T, B, L = dims(shape)
    nact = count_tensor(nacts, W)
    lab_p, dist_p = k2.nearest_landmark_plain(pts, mp, nact,
                                              sqrt_key=sqrt_key)
    fin = torch.isfinite(dist_p)
    err = 0.0
    for plan in k2_plans(T * B, L, sqrt_key):
        what = (f"K2 {shape} nact={list(nacts)} plan={plan} "
                f"sqrt_key={sqrt_key}")
        lab, dist = (k2.nearest_landmark(pts, mp, nact, sqrt_key)
                     if plan is None
                     else k2.launch(pts, mp, nact, plan, sqrt_key))
        torch.cuda.synchronize()
        check(torch.equal(lab, lab_p), f"{what}: labels differ")
        check(torch.equal(fin, torch.isfinite(dist)),
              f"{what}: infinite distances differ")
        e = float((dist - dist_p)[fin].abs().max()) if bool(fin.any()) \
            else 0.0
        check(e <= 1e-5, f"{what}: distances differ by {e}")
        err = max(err, e)
        for w in range(W):
            one = (k2.nearest_landmark(pts[w], mp[w].contiguous(), nact[w],
                                       sqrt_key)
                   if plan is None else
                   k2.launch(pts[w], mp[w].contiguous(), nact[w], plan,
                             sqrt_key))
            check(torch.equal(lab[w], one[0]) and torch.equal(dist[w], one[1]),
                  f"{what}: world {w} differs from its launch alone")
    return err


def phase_fleet_kernels():
    """18 (a): both kernels with a world axis, at the issue's shapes and at
    the largest shapes the fleets give them."""
    k1_nacts = (0, 1, 7, 37, 64, 100, 127, 128)
    err1 = max(hold_k1_worlds(shape, k1_nacts)
               for shape in ((8, 1833, 48, 128), (8, 1833, 152, 128)))
    err2 = max(hold_k2_worlds(shape, (0, 1, 517, 1024))
               for shape in ((4, 1833, 48, 1024), (4, 1833, 104, 1024)))
    emit(phase="fleet_kernels_vs_plain",
         k1_shapes=[[8, 1833, 48, 128], [8, 1833, 152, 128]],
         k1_nact_per_world=list(k1_nacts),
         k2_shapes=[[4, 1833, 48, 1024], [4, 1833, 104, 1024]],
         k2_nact_per_world=[0, 1, 517, 1024], labels="exact",
         d2min_and_distances="bitwise (K2 within 1e-5 of plain)",
         sums_run_to_run="bitwise", each_world_vs_alone="bitwise",
         k1_sums_max_abs_err=err1, k2_dist_max_abs_err=err2)
    return dict(k1=err1, k2=err2)


def fleet_of(golden, prefix, worlds_kw, cfg):
    """The golden fleet ``prefix``: its worlds (checksums checked) and the
    port's run_batched of them, launches counted."""
    from icm_slam_tpu_torch.data.datasets import (synthetic_world,
                                                  world_checksum)
    from icm_slam_tpu_torch.solver.icm import run_batched
    worlds = [synthetic_world(**kw, return_truth=True)[:2]
              for kw in worlds_kw]
    for i, (ds, _) in enumerate(worlds):
        check(world_checksum(ds) == str(golden[f"{prefix}_w{i}_"
                                               f"world_checksum"]),
              f"fleet {prefix}: world {i} differs from the golden's")
    res, n = counted(lambda: run_batched([w[0] for w in worlds], cfg,
                                         "cuda"))
    return worlds, res, n


def add_counts(total, n):
    """Add one run's counts (``counted``) into ``total``."""
    for k in ("k1", "k2", "k3"):
        total[k] += n[k]
    for key, count in n["shapes"].items():
        total["shapes"][key] = total["shapes"].get(key, 0) + count
    return total


def phase_fleet_small(gf):
    """18 (b): two small fleets against JAX's run_batched.  Returns their
    launches and, per kernel shape, the live counts they left."""
    import numpy as np
    from icm_slam_tpu_torch.config import ICMConfig
    out, launches = {}, {"k1": 0, "k2": 0, "k3": 0, "shapes": {}}
    # the worlds of tests/test_torch_fleet.py: census exact, 1e-3
    worlds, res, n = fleet_of(
        gf, "slice3", [dict(T=240, n_landmarks=12, seed=s)
                       for s in (7, 10, 11)], ICMConfig(L=256, cota=20.0, N=3))
    check(n["k1"] == 3 and n["k2"] == 0,
          f"capped small fleet launched K1 {n['k1']}x, K2 {n['k2']}x")
    errs = {}
    for i, r in enumerate(res):
        gc = golden_case(gf, f"slice3_w{i}")
        check(r.map_pos.shape[0] == int(gc["census"])
              and np.array_equal(r.map_counts, gc["map_counts"]),
              f"small fleet world {i}: census {r.map_pos.shape[0]} != "
              f"JAX's {int(gc['census'])}")
        for k in ("x_init", "x", "map_pos"):
            e = float(np.abs(getattr(r, k) - gc[k]).max())
            check(e <= 1e-3, f"small fleet world {i}: {k} differs from "
                             f"JAX by {e}")
            errs[k] = max(errs.get(k, 0.0), e)
    out["slice3"] = dict(census=[r.map_pos.shape[0] for r in res],
                         max_abs_diff_vs_jax=errs, tolerance=1e-3)
    add_counts(launches, n)
    nacts = {("k1", (3, 240, 48, 128)): out["slice3"]["census"]}
    # the three worlds of tests/test_fleet.py, rounding-sensitive (their
    # runs alone differ from JAX's by up to 0.08): census and ATE
    worlds, res, n = fleet_of(
        gf, "fleet3", [dict(T=300, n_landmarks=25, seed=s)
                       for s in (0, 1, 2)], ICMConfig(L=256, cota=10.0, N=4))
    check(n["k1"] == 0 and n["k2"] == 4,
          f"uncapped small fleet launched K1 {n['k1']}x, K2 {n['k2']}x")
    rows = []
    for i, (r, (_, x_true)) in enumerate(zip(res, worlds)):
        gc = golden_case(gf, f"fleet3_w{i}")
        ate, ate_jax = ate_rmse(r.x, x_true), float(gc["ate_rmse"])
        check(r.map_pos.shape[0] == int(gc["census"]),
              f"fleet3 world {i}: census {r.map_pos.shape[0]} != JAX's "
              f"{int(gc['census'])}")
        check(abs(ate - ate_jax) <= 0.1 * ate_jax,
              f"fleet3 world {i}: ATE {ate} not within 10% of JAX's "
              f"{ate_jax}")
        rows.append(dict(census=r.map_pos.shape[0], ate_rmse_port=ate,
                         ate_rmse_jax=ate_jax,
                         x_max_abs_diff_vs_jax=float(
                             np.abs(r.x - gc["x"]).max())))
    out["fleet3"] = rows
    add_counts(launches, n)
    nacts[("k2", (3, 300, 136, 256))] = [r["census"] for r in rows]
    emit(phase="fleet_small_vs_jax", **out)
    return launches, nacts


def phase_fleet_curve(gf, smi):
    """18 (c): run_batched on W full-width worlds, W = 1, 2, 4, 8: a warm
    run (N=1) first, then the timed run (N=30, launches counted)."""
    import numpy as np
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.data.datasets import world_checksum
    from icm_slam_tpu_torch.solver import icm
    worlds = fleet_worlds()
    cfg = ICMConfig()
    curve, launches, nacts = [], {}, {}
    for W in FLEET_WS:
        dss = [w[0] for w in worlds[:W]]
        merged = icm.resolve_fleet_config(
            cfg, [icm.prepare(ds, cfg, "cuda") for ds in dss])
        icm.run_batched(dss, cfg, "cuda", n_iters=1)
        res, n = counted(lambda: icm.run_batched(dss, cfg, "cuda"))
        check(n["k1"] == cfg.N and n["k2"] == 0,
              f"W={W} fleet launched K1 {n['k1']}x, K2 {n['k2']}x; want "
              f"{cfg.N} and 0, one launch a sweep for every world")
        for r in res:
            check(np.isfinite(r.x).all() and np.isfinite(r.map_pos).all()
                  and r.x.shape == (1833, 3), f"W={W}: bad output")
        t = res[0].timings
        row = dict(W=W, branch="capped" if merged.map_run_cap else
                   "uncapped", obs_cap=merged.obs_cap,
                   map_run_cap=merged.map_run_cap, k1_launches=n["k1"],
                   census=[r.map_pos.shape[0] for r in res],
                   prepare_s=t["prepare_s"], init_s=t["init_s"],
                   refine_per_iter_s=t["refine_per_iter_s"],
                   pipeline_s=t["pipeline_s"], per_world_s=t["per_world_s"],
                   refine_frames_per_s=W * 1833 / t["refine_per_iter_s"])
        if W == 2:
            agree = []
            for i, (r, (ds, x_true)) in enumerate(zip(res, worlds)):
                gc = golden_case(gf, f"big2_w{i}")
                check(world_checksum(ds) == str(gc["world_checksum"]),
                      f"fleet world {i} differs from the golden's")
                agree.append(hold_to_golden(r, x_true, gc,
                                            f"W=2 fleet world {i}"))
            row["vs_jax_run_batched"] = agree
        if W == max(FLEET_WS):
            # the fleet against run() with the merged config: the same
            # function, and the scatters add in a fixed order, so the same
            # bits; and run() twice, the same bits
            fleet = res
            solo = [icm.run(dss[i], merged, "cuda") for i in (0, W - 1)]
            again = icm.run(dss[W - 1], merged, "cuda")
            check(np.array_equal(again.x, solo[1].x)
                  and np.array_equal(again.map_pos, solo[1].map_pos),
                  f"run() of world {W - 1} twice: poses "
                  f"{float(np.abs(again.x - solo[1].x).max())} apart")
            rows = []
            for i, r1 in zip((0, W - 1), solo):
                x_true = worlds[i][1]
                ate, ate_solo = ate_rmse(fleet[i].x, x_true), \
                    ate_rmse(r1.x, x_true)
                check(fleet[i].map_pos.shape == r1.map_pos.shape,
                      f"W={W} world {i}: census {fleet[i].map_pos.shape[0]} "
                      f"!= run()'s {r1.map_pos.shape[0]}")
                check(abs(ate - ate_solo) <= 0.1 * ate_solo,
                      f"W={W} world {i}: ATE {ate} not within 10% of "
                      f"run()'s {ate_solo}")
                dx = float(np.abs(fleet[i].x - r1.x).max())
                check(dx == 0.0 and np.array_equal(fleet[i].map_pos,
                                                   r1.map_pos),
                      f"W={W} world {i}: poses {dx} from run()'s")
                rows.append(dict(world=i, census=r1.map_pos.shape[0],
                                 ate_rmse_fleet=ate, ate_rmse_run=ate_solo,
                                 x_max_abs_diff=dx))
            row["vs_run_merged_config"] = rows
            row["run_twice"] = "bitwise"
        emit(phase="fleet_curve", **row, card=smi)
        row["results"] = res
        curve.append(row)
        launches[f"fleet_w{W}"] = n
        for key in n["shapes"]:
            nacts[key] = row["census"]
    base = curve[0]["refine_frames_per_s"]
    emit(phase="fleet_curve_summary",
         W=[r["W"] for r in curve],
         refine_frames_per_s=[r["refine_frames_per_s"] for r in curve],
         times_one_world=[r["refine_frames_per_s"] / base for r in curve],
         init_s=[r["init_s"] for r in curve],
         refine_per_iter_s=[r["refine_per_iter_s"] for r in curve],
         note="N=30, ICMConfig(); each W after a warm run of N=1",
         card=smi)
    return launches, nacts, curve


def phase_fleet_profile(curve, one_world, smi):
    """18 (d): launches, host syncs and busy time of one fleet sweep (+ map
    filter) and of the init's first 8 chunks at W = 8, against W = 1's:
    phase 7's profiles of run() (``one_world``), which runs the same
    batched engine with W = 1 on world 0."""
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.mapping.landmark_map import filter_map
    from icm_slam_tpu_torch.solver import icm
    from icm_slam_tpu_torch.solver.sweeps import init_sweep_batched
    worlds = fleet_worlds()
    per_iter = {r["W"]: r["refine_per_iter_s"] for r in curve}
    prof = {1: one_world}
    for W in (max(FLEET_WS),):
        data, seed, x0, cfg, w = icm.prepare_fleet(
            [ds for ds, _ in worlds[:W]], ICMConfig(), "cuda")
        state, x, _ = init_sweep_batched(data, seed, x0, cfg, w)
        cur = filter_map(state, cfg.cota, cfg.dist_thr,
                         live_cap=cfg.map_run_cap)
        F = 8 * cfg.init_chunk_len
        head = data._replace(dist=data.dist[:, :F], mask=data.mask[:, :F],
                             odom=data.odom[:, :F], u=data.u[:, :F])
        init = launches_and_syncs(
            lambda: init_sweep_batched(head, seed, x0, cfg, w))
        data = icm.hoist_compaction(data, cfg)
        cur, x, _ = icm._refine_step(data, cur, x, cfg, w)
        sweep = launches_and_syncs(
            lambda: icm._refine_step(data, cur, x, cfg, w))
        sweep["busy_share_of_timed_sweep"] = (
            sweep["device_busy_ms"] / (per_iter[W] * 1e3))
        prof[W] = dict(init_8_chunks=init, sweep=sweep)
        emit(phase="fleet_sweep_profile", W=W, obs_cap=cfg.obs_cap,
             **sweep, card=smi)
        emit(phase="fleet_init_profile", W=W, frames=F, **init,
             note=f"init_sweep_batched over frames 0-{F - 1} of each world",
             card=smi)
    one, many = prof[1], prof[max(FLEET_WS)]
    one["sweep"]["busy_share_of_timed_sweep"] = (
        one["sweep"]["device_busy_ms"] / (per_iter[1] * 1e3))
    emit(phase="fleet_one_world_profile", W=1,
         sweep_launches=one["sweep"]["kernel_launches"],
         sweep_host_syncs=one["sweep"]["host_syncs"],
         sweep_device_busy_ms=one["sweep"]["device_busy_ms"],
         busy_share_of_timed_sweep=one["sweep"]["busy_share_of_timed_sweep"],
         init_launches=one["init_8_chunks"]["kernel_launches"],
         init_host_syncs=one["init_8_chunks"]["host_syncs"],
         note="phase 7's profiles (refine_sweep_profile, init_profile)",
         card=smi)
    for part in ("sweep", "init_8_chunks"):
        a, b = one[part]["kernel_launches"], many[part]["kernel_launches"]
        check(abs(b - a) <= 0.05 * a,
              f"fleet {part}: {b} launches at W={max(FLEET_WS)} against "
              f"{a} at W=1 (more than 5% apart)")
        check(one[part]["host_syncs"] == many[part]["host_syncs"],
              f"fleet {part}: host syncs {one[part]['host_syncs']} at W=1 "
              f"against {many[part]['host_syncs']}")
    check(one["sweep"]["host_syncs"] == 0 == many["sweep"]["host_syncs"],
          f"fleet sweep: host syncs {one['sweep']['sync_sites']} at W=1, "
          f"{many['sweep']['sync_sites']} at W={max(FLEET_WS)}; want 0")
    return prof


def phase_fleet_uncapped(smi):
    """18 (e): the uncapped fleet of four (map_run_cap=0, N=3): K2 once a
    sweep for all worlds; each world's census that of run() with the
    merged config."""
    import numpy as np
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.solver import icm
    dss = [ds for ds, _ in fleet_worlds()[:4]]
    cfg = ICMConfig(map_run_cap=0, N=3)
    res, n = counted(lambda: icm.run_batched(dss, cfg, "cuda"))
    check(n["k2"] == cfg.N and n["k1"] == 0,
          f"uncapped fleet launched K2 {n['k2']}x, K1 {n['k1']}x; want "
          f"{cfg.N} and 0")
    merged = icm.resolve_fleet_config(
        cfg, [icm.prepare(ds, cfg, "cuda") for ds in dss])
    solo = [icm.run(ds, merged, "cuda") for ds in dss]
    census = [r.map_pos.shape[0] for r in res]
    census_run = [r.map_pos.shape[0] for r in solo]
    check(census == census_run,
          f"uncapped fleet census {census} != run()'s {census_run}")
    check(all(np.array_equal(a.x, b.x) for a, b in zip(res, solo)),
          "uncapped fleet: poses differ from run()'s")
    t = res[0].timings
    emit(phase="fleet_uncapped", W=4, config="ICMConfig(map_run_cap=0, N=3)",
         k2_launches=n["k2"], census=census, census_run=census_run,
         poses_vs_run="bitwise",
         init_s=t["init_s"], refine_per_iter_s=t["refine_per_iter_s"],
         refine_frames_per_s=4 * 1833 / t["refine_per_iter_s"], card=smi)
    return n, {key: [r.map_pos.shape[0] for r in res]
               for key in n["shapes"]}


def as_transported(ds, n, max_range):
    """The first ``n`` frames of ``ds`` as the rosbridge transport delivers
    them: ranges clipped at the sensor's range (the engine adds the tree
    radius), the heading through a quaternion, so wrapped into
    (-pi, pi]."""
    import math
    import numpy as np
    from icm_slam_tpu_torch.data.datasets import Dataset
    from icm_slam_tpu_torch.runtime.ingest import quat_to_yaw
    yaw = [quat_to_yaw(0.0, 0.0, math.sin(t / 2), math.cos(t / 2))
           for t in ds.odom[:n, 2]]
    odom = np.concatenate([ds.odom[:n, :2], np.array(yaw)[:, None]], 1)
    return Dataset(np.minimum(ds.scans[:n], max_range), odom,
                   ds.u[:n].copy(), odom[0].copy(), "transported")


def phase_online(smi):
    """19: ``python -m icm_slam_tpu_torch online`` on the card against a
    rosbridge loopback served by this process, fed 600 frames of
    ``synthetic_world()``; its file against ``api.run_online`` on the same
    frames."""
    import numpy as np
    from icm_slam_tpu_torch import api
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.data.datasets import synthetic_world
    from icm_slam_tpu_torch.runtime import fake_rosbridge as frb
    from icm_slam_tpu_torch.runtime.replay import (publish_to_rosbridge,
                                                   stream_dataset)
    T = 600
    ds = synthetic_world().slice(T)
    yaml = os.path.join(HERE, "configs", "reference.yaml")
    cfg = ICMConfig.from_yaml(yaml, N=3)
    # the CLI's process finds roslibpy's stand-in, the loopback client,
    # on its PYTHONPATH (roslibpy is not installed)
    shim = os.path.join(WORK, "roslibpy_shim")
    os.makedirs(shim, exist_ok=True)
    with open(os.path.join(shim, "roslibpy.py"), "w") as f:
        f.write("import sys\nfrom icm_slam_tpu_torch.runtime.fake_rosbridge "
                "import client_module\nsys.modules[__name__] = "
                "client_module()\n")
    out = os.path.join(WORK, "online.npz")
    server = frb.FakeRosBridgeServer().start()
    sys.modules["roslibpy"] = frb.client_module()
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "icm_slam_tpu_torch", "online", "--config",
         yaml, "--iters", "3", "--host", server.host, "--port",
         str(server.port), "--duration", "240", "--out", out],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join([shim, HERE])))
    try:
        deadline = time.monotonic() + 120
        while len(server._subs) < 2 and proc.poll() is None:
            check(time.monotonic() < deadline, "the CLI never subscribed")
            time.sleep(0.05)
        if proc.poll() is not None:
            raise AssertionError(f"cli online exited early:\n"
                                 f"{proc.communicate()[1][-3000:]}")
        t_pub = time.perf_counter()
        publish_to_rosbridge(ds, cfg, hz=10.0, speedup=50.0,
                             host=server.host, port=server.port)
        publish_s = time.perf_counter() - t_pub
        time.sleep(1.0)
        lib = sys.modules["roslibpy"]
        client = lib.Ros(host=server.host, port=server.port)
        client.run()
        lib.Service(client, "/icm_slam/iterative_flag",
                    "std_srvs/SetBool").call({"data": True}, timeout=10)
        client.terminate()
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        server.stop()
        sys.modules.pop("roslibpy", None)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"cli online exited {proc.returncode}:\n{stderr[-3000:]}")
    sync = [json.loads(line)["sync"] for line in stdout.splitlines()
            if line.startswith('{"sync"')]
    check(len(sync) == 1 and sync[0]["dropped"] == 0,
          f"synchronizer stats {sync}")
    with np.load(out) as z:
        x, x_init, pos = z["x"], z["x_init"], z["map_pos"]
    n = x.shape[0]
    check(n >= T - 10 and np.isfinite(x).all() and np.isfinite(pos).all(),
          f"cli online: {n} frames of {T}, finite {np.isfinite(x).all()}")
    t0 = time.perf_counter()
    ref = api.run_online(stream_dataset(as_transported(
        ds, n, cfg.rango_laser_max)), cfg, "cuda")
    ref_s = time.perf_counter() - t0
    check(pos.shape[0] == ref.map_pos.shape[0],
          f"cli online census {pos.shape[0]} != run_online's "
          f"{ref.map_pos.shape[0]}")
    e = float(np.abs(x_init - ref.x_init).max())
    check(e <= 1e-3, f"cli online x_init differs from run_online's by {e}")
    emit(phase="online_cli", frames_published=T, frames_captured=n,
         sync=sync[0], census=pos.shape[0], census_run_online=ref.map_pos.
         shape[0], x_init_max_abs_diff=e,
         x_max_abs_diff=float(np.abs(x - ref.x).max()),
         publish_s=publish_s, cli_process_s=cli_s, run_online_s=ref_s,
         card=smi)


# ---------------------------------------------------------------------------
# phase 20: fleet mode in every configuration
# ---------------------------------------------------------------------------

GOLDEN_MODES = os.path.join(HERE, "tests", "golden",
                            "torch_fleet_modes_synth.npz")
MODE_SEEDS = (7, 10, 11)
# (mode, world) of the small fleets whose poses JAX's own rounding moves
# past the 1e-3 band (tests/test_torch_fleet_modes.py): census and ATE
MODE_SENSITIVE = {("ba", 1)}
# frames of the full-width worlds that the causal-init modes run (400 of
# the 1,833: the script's time limit)
CAUSAL_FRAMES = 400
# the full-width fleets of phase 20 (c): the batched-shaped modes on the
# T=1833 worlds, the causal ones on their first CAUSAL_FRAMES frames
FULL_MODES = ("hooks", "ba", "wba", "nq", "iseq", "seq")


def mode_config(mode, full=False):
    """ICMConfig of a phase-20 fleet: the small fleets' (golden
    torch_fleet_modes_synth.npz, N=2, L=256, cota=5) or, ``full``, the
    full-width one (N=3; the non-quirk Jacobi run at L=2048 as phase 9,
    the sequential sweep N=1 as phase 8)."""
    from icm_slam_tpu_torch.config import ICMConfig
    kw = {"hooks": dict(init_mode="batched", model=hooks_model()),
          "ba": dict(sweep_mode="ba"),
          "wba": dict(sweep_mode="windowed_ba",
                      ba_window=64 if full else 32),
          "nq": dict(replicate_new_obs_quirk=False),
          "iseq": dict(init_mode="sequential"),
          "seq": dict(sweep_mode="sequential")}[mode]
    if not full:
        return ICMConfig(N=2, L=256, cota=5.0, **kw)
    if mode == "nq":
        kw.update(pose_update="jacobi", L=2048)
    return ICMConfig(N=1 if mode == "seq" else 3, **kw)


def fleet_checked(dss, cfg, mode, what):
    """``run_batched`` of the worlds ``dss`` in ``mode``, its launches
    counted and checked: the causal init launches K2 once a frame (T - 1
    for all W worlds, not W (T - 1)), a sequential sweep once a frame (T),
    a batched sweep or BA step K1 once (capped) or K2 once (uncapped, or
    the non-quirk components).  Returns (results, counts, merged config)."""
    from icm_slam_tpu_torch.solver import icm
    merged = icm.resolve_fleet_config(
        cfg, [icm.prepare(ds, cfg, "cuda") for ds in dss])
    T = dss[0].T
    causal = T - 1 if not icm.use_batched_init(merged) else 0
    if mode == "seq":
        want = (0, causal + merged.N * T)
    elif merged.replicate_new_obs_quirk and 0 < merged.map_run_cap < merged.L:
        want = (merged.N, causal)
    else:
        want = (0, causal + merged.N)
    res, n = counted(lambda: icm.run_batched(dss, cfg, "cuda"))
    check((n["k1"], n["k2"]) == want,
          f"{what}: launched K1 {n['k1']}x, K2 {n['k2']}x; want {want}")
    return res, n, merged


def phase_modes_kernels():
    """20 (a): K2 at the per-frame shapes of the causal fleets and at the
    non-quirk fleet's sweep, K1 at the hooks / BA fleets' and the
    causal-init fleet's sweeps, with a world axis, against their plain
    versions and world by world against the launch alone; K2 at a
    per-frame shape (T = 1: ``landmark_map.update``, which takes the sqrt
    key) with both keys."""
    err2 = max(hold_k2_worlds(shape, (0, 1, 517, shape[-1])[-shape[0]:],
                              sqrt_key)
               for shape in ((4, 1, 181, 1024), (4, 1, 104, 2048),
                             (4, 1, 104, 1024), (4, 400, 104, 128),
                             (3, 1, 181, 256), (3, 1, 16, 256),
                             (3, 120, 16, 256))
               for sqrt_key in ((False, True) if shape[1] == 1
                                else (False,)))
    err1 = max(hold_k1_worlds(shape, (0, 7, 100, 128))
               for shape in ((4, 1833, 104, 128), (4, 400, 104, 128)))
    emit(phase="fleet_modes_kernels_vs_plain",
         k2_shapes=[[4, 1, 181, 1024], [4, 1, 104, 2048], [4, 1, 104, 1024],
                    [4, 400, 104, 128], [3, 1, 181, 256], [3, 1, 16, 256],
                    [3, 120, 16, 256]],
         k1_shapes=[[4, 1833, 104, 128], [4, 400, 104, 128]],
         k2_keys="d^2; both d^2 and sqrt at T = 1", labels="exact", k2_distances="within 1e-5 of plain",
         k1_sums="within 1e-4, bitwise run to run",
         each_world_vs_alone="bitwise", k2_dist_max_abs_err=err2,
         k1_sums_max_abs_err=err1)
    return dict(k1=err1, k2=err2)


def phase_modes_small(gmo):
    """20 (b): the small fleets of every configuration against JAX's
    run_batched (tests/golden/torch_fleet_modes_synth.npz): census exact,
    x_init, x and the map within 1e-3 (a cell JAX's own rounding moves
    past the band: census, ATE within 10%); the launches counted."""
    import numpy as np
    from icm_slam_tpu_torch.data.datasets import (synthetic_world,
                                                  world_checksum)
    worlds = [synthetic_world(T=120, n_landmarks=10, seed=s,
                              return_truth=True)[:2] for s in MODE_SEEDS]
    for i, (ds, _) in enumerate(worlds):
        check(world_checksum(ds) == str(gmo[f"hooks_w{i}_world_checksum"]),
              f"small mode fleet: world {i} differs from the golden's")
    launches, nacts, out = {}, {}, {}
    for mode in FULL_MODES:
        res, n, _ = fleet_checked([w[0] for w in worlds], mode_config(mode),
                                  mode, f"small {mode} fleet")
        errs = {}
        for i, (r, (_, x_true)) in enumerate(zip(res, worlds)):
            census = int(gmo[f"{mode}_census"][i])
            check(r.map_pos.shape[0] == census and np.array_equal(
                r.map_counts, gmo[f"{mode}_w{i}_map_counts"]),
                f"small {mode} fleet world {i}: census "
                f"{r.map_pos.shape[0]} != JAX's {census}")
            for k in ("x_init", "x", "map_pos"):
                e = float(np.abs(getattr(r, k) - gmo[f"{mode}_w{i}_{k}"])
                          .max())
                if k == "x" and (mode, i) in MODE_SENSITIVE:
                    ate = ate_rmse(r.x, x_true)
                    ate_jax = float(gmo[f"{mode}_w{i}_ate_rmse"])
                    check(abs(ate - ate_jax) <= 0.1 * ate_jax,
                          f"small {mode} fleet world {i}: ATE {ate} not "
                          f"within 10% of JAX's {ate_jax}")
                    errs["x_sensitive_world"] = e
                    continue
                check(e <= 1e-3, f"small {mode} fleet world {i}: {k} "
                                 f"differs from JAX by {e}")
                errs[k] = max(errs.get(k, 0.0), e)
        out[mode] = dict(census=[r.map_pos.shape[0] for r in res],
                         k1_launches=n["k1"], k2_launches=n["k2"],
                         max_abs_diff_vs_jax=errs)
        launches[f"modes_small_{mode}"] = n
        for key in n["shapes"]:
            nacts[key] = out[mode]["census"]
    emit(phase="fleet_modes_small_vs_jax", worlds="synthetic_world(T=120, "
         "n_landmarks=10, seed=s), s = 7, 10, 11", config="ICMConfig(N=2, "
         "L=256, cota=5) + the mode", tolerance=1e-3, **out)
    return launches, nacts


def fleet_state(res, L):
    """A fleet's results as (maps (W, L, 2) ..., poses (W, T, 3)) on the
    card, to profile a sweep from."""
    import torch
    maps = [map_state(r, L) for r in res]
    x = torch.stack([torch.from_numpy(r.x) for r in res]).cuda()
    return type(maps[0])(*(torch.stack(f) for f in zip(*maps))), x


def head(data, F):
    """The first ``F`` frames of a (fleet's) SweepData."""
    return data._replace(dist=data.dist[..., :F, :],
                         mask=data.mask[..., :F, :],
                         odom=data.odom[..., :F, :], u=data.u[..., :F, :],
                         ang=data.ang if data.ang.dim() < data.dist.dim()
                         else data.ang[..., :F, :])


def mode_profiles(mode, dss, merged, res, solo0, F=4):
    """Launches and host syncs of the fleet's work against one world's
    (W = 1: world 0 under the merged config, from ``run()``'s state): one
    refine sweep (+ map filter) from the runs' final states (a sequential
    sweep on the first ``F`` frames; a ``ba`` sweep of one GN step), and
    for the causal-init modes the init over the first ``F`` frames (the
    profiler's summary took ~0.75 ms a launch on the NVIDIA H100 80GB
    HBM3 machine at 700 W, and every frame or GN step issues the same
    work)."""
    import dataclasses
    import torch
    from icm_slam_tpu_torch.core.energy import weights
    from icm_slam_tpu_torch.solver import icm
    from icm_slam_tpu_torch.solver.sweeps import init_sweep
    w = weights(merged, "cuda")
    W = len(dss)
    data_w, seed_w, x0_w, _, _ = icm.prepare_fleet(dss, merged, "cuda")
    data_1 = icm.prepare(dss[0], merged, "cuda")
    x0_1 = torch.as_tensor(dss[0].x0, device="cuda").float()
    seed_1 = icm.seed_map(data_1, x0_1, merged)
    out = {}
    if not icm.use_batched_init(merged):
        out["init"] = {
            1: launches_and_syncs(lambda: init_sweep(
                head(data_1, F), seed_1, x0_1, merged, w)),
            W: launches_and_syncs(lambda: init_sweep(
                head(data_w, F), seed_w, x0_w, merged, w))}
    cur_w, x_w = fleet_state(res, merged.L)
    cur_1, x_1 = map_state(solo0, merged.L), torch.from_numpy(
        solo0.x).cuda()
    if mode == "seq":
        data_1, data_w = head(data_1, F), head(data_w, F)
        x_1, x_w = x_1[:F], x_w[:, :F]
    data_1 = icm.hoist_compaction(data_1, merged)
    data_w = icm.hoist_compaction(data_w, merged)
    if mode == "ba":
        merged = dataclasses.replace(merged, ba_gn_iters=1)
    icm._refine_step(data_w, cur_w, x_w, merged, w)
    out["sweep"] = {
        1: launches_and_syncs(lambda: icm._refine_step(data_1, cur_1, x_1,
                                                       merged, w)),
        W: launches_and_syncs(lambda: icm._refine_step(data_w, cur_w, x_w,
                                                       merged, w))}
    rows = {}
    for part, prof in out.items():
        a, b = prof[1]["kernel_launches"], prof[W]["kernel_launches"]
        check(abs(b - a) <= 0.05 * a,
              f"{mode} fleet {part}: {b} launches at W={W} against {a} at "
              f"W=1 (more than 5% apart)")
        check(prof[1]["host_syncs"] == prof[W]["host_syncs"],
              f"{mode} fleet {part}: host syncs {prof[1]['sync_sites']} at "
              f"W=1 against {prof[W]['sync_sites']} at W={W}")
        frames = F if part == "init" or mode == "seq" else 1
        rows[part] = dict(
            frames=frames if part == "init" or mode == "seq" else "sweep",
            launches_w1=a, launches_w=b, host_syncs_w1=prof[1]["host_syncs"],
            host_syncs_w=prof[W]["host_syncs"],
            launches_per_frame_w1=a / frames, launches_per_frame_w=b / frames,
            device_busy_ms_w1=prof[1]["device_busy_ms"],
            device_busy_ms_w=prof[W]["device_busy_ms"],
            top_kernels_w=prof[W]["top_kernels_ms_count"])
    return rows


def phase_modes_full(smi):
    """20 (c): every configuration at W=4 at full width: the batched-shaped
    modes on the T=1833 worlds 0-3 (N=3), the causal-init modes on their
    first CAUSAL_FRAMES frames (181 beams).  Each fleet's launches exact
    (``fleet_checked``); worlds 0 and 3 (the causal ones: world 0, to keep
    the script's time) against ``run()`` of that world under the merged
    config (census equal, ATE within 10%); the fleet's
    init and sweep times against world 0's ``run()`` (W=1); launches and
    host syncs of a sweep and of the init's first frames at W=4 against
    W=1 (within 5%, the same syncs).  Returns the launches, the live
    counts per shape and the ``ba`` fleet's results (for 20 (d))."""
    import numpy as np
    from icm_slam_tpu_torch.solver import icm
    worlds = fleet_worlds()[:4]
    launches, nacts, kept = {}, {}, {}
    for mode in FULL_MODES:
        dss = [ds if mode in ("hooks", "ba", "wba")
               else ds.slice(CAUSAL_FRAMES) for ds, _ in worlds]
        frames = dss[0].T
        cfg = mode_config(mode, full=True)
        res, n, merged = fleet_checked(dss, cfg, mode, f"W=4 {mode} fleet")
        for r in res:
            check(np.isfinite(r.x).all() and np.isfinite(r.map_pos).all()
                  and r.x.shape == (frames, 3), f"W=4 {mode} fleet: bad "
                                                f"output")
        solo = {i: icm.run(dss[i], merged, "cuda")
                for i in ((0, 3) if frames > CAUSAL_FRAMES else (0,))}
        vs_run = []
        for i, r1 in solo.items():
            x_true = worlds[i][1][:frames]
            ate, ate_run = ate_rmse(res[i].x, x_true), ate_rmse(r1.x, x_true)
            check(res[i].map_pos.shape == r1.map_pos.shape,
                  f"W=4 {mode} world {i}: census {res[i].map_pos.shape[0]} "
                  f"!= run()'s {r1.map_pos.shape[0]}")
            check(abs(ate - ate_run) <= 0.1 * ate_run,
                  f"W=4 {mode} world {i}: ATE {ate} not within 10% of "
                  f"run()'s {ate_run}")
            vs_run.append(dict(world=i, census=r1.map_pos.shape[0],
                               ate_rmse_fleet=ate, ate_rmse_run=ate_run,
                               x_max_abs_diff=float(np.abs(
                                   res[i].x - r1.x).max())))
        t, t1 = res[0].timings, solo[0].timings
        prof = mode_profiles(mode, dss, merged, res, solo[0])
        emit(phase="fleet_mode_full", mode=mode, W=4, frames=frames,
             config=repr({k: v for k, v in vars(cfg).items()
                          if k in ("N", "L", "sweep_mode", "init_mode",
                                   "replicate_new_obs_quirk", "pose_update",
                                   "ba_window")}),
             obs_cap=merged.obs_cap, map_run_cap=merged.map_run_cap,
             k1_launches=n["k1"], k2_launches=n["k2"],
             census=[r.map_pos.shape[0] for r in res], vs_run_merged=vs_run,
             init_s=t["init_s"], init_s_w1=t1["init_s"],
             init_ratio=t["init_s"] / t1["init_s"],
             refine_per_iter_s=t["refine_per_iter_s"],
             refine_per_iter_s_w1=t1["refine_per_iter_s"],
             refine_ratio=t["refine_per_iter_s"] / t1["refine_per_iter_s"],
             aggregate_refine_frames_per_s=4 * frames
             / t["refine_per_iter_s"],
             aggregate_init_frames_per_s=4 * (frames - 1) / t["init_s"],
             profiles=prof, card=smi)
        launches[f"modes_{mode}"] = n
        for key in n["shapes"]:
            nacts[key] = [r.map_pos.shape[0] for r in res]
        if mode == "ba":
            kept = dict(dss=dss, cfg=cfg, res=res)
    return launches, nacts, kept


def phase_repeatable(ba_fleet, runs, closed):
    """20 (d): the models' sums add in a fixed order on the card, so a
    second run of phases 15-16 (``run()`` with ``sweep_mode`` ``ba`` and
    ``windowed_ba``), of phase 17's ``close_loops`` and of the ``ba``
    fleet gives the same bits as the first."""
    import numpy as np
    import torch
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.models.loop_closure import close_loops
    from icm_slam_tpu_torch.solver import icm
    ds, _ = world_1833()
    out = {}
    for mode, first in runs.items():
        again = icm.run(ds, ICMConfig(N=3, sweep_mode=mode), "cuda")
        same = all(np.array_equal(getattr(again, f), getattr(first, f))
                   for f in ("x_init", "x", "map_pos", "map_counts"))
        check(same, f"{mode} run twice: poses "
                    f"{float(np.abs(again.x - first.x).max())} apart")
        out[mode] = "bitwise"
    data, x_icm, rcfg, kwargs, x_first = closed
    x_again, _ = close_loops(data, x_icm, rcfg, report={}, **kwargs)
    dx = float(np.abs(x_again.cpu().numpy() - x_first).max())
    check(dx == 0.0, f"close_loops twice: poses {dx} apart")
    out["loop_closure"] = "bitwise"
    again = icm.run_batched(ba_fleet["dss"], ba_fleet["cfg"], "cuda")
    for i, (a, b) in enumerate(zip(again, ba_fleet["res"])):
        check(np.array_equal(a.x, b.x) and np.array_equal(a.map_pos,
                                                          b.map_pos),
              f"ba fleet twice: world {i} poses "
              f"{float(np.abs(a.x - b.x).max())} apart")
    out["ba_fleet_w4"] = "bitwise"
    torch.cuda.synchronize()
    emit(phase="models_repeatable", **out,
         note="a second run against the first on the same card, bitwise")


def phase_parallel_bringup():
    """21 (a): ``parallel.distributed.initialize()`` from the environment
    (``ICM_COORDINATOR`` on a free local port, one process): an NCCL group
    of one rank on this card."""
    import torch.distributed as dist
    from icm_slam_tpu_torch.parallel import distributed as pd
    from icm_slam_tpu_torch.parallel.mesh import _free_port
    os.environ.update(ICM_COORDINATOR=f"localhost:{_free_port()}",
                      ICM_NUM_PROCESSES="1", ICM_PROCESS_ID="0")
    t0 = time.perf_counter()
    pd.initialize()
    check(dist.is_initialized() and dist.get_backend() == "nccl",
          "initialize() did not form an NCCL group")
    out = dict(backend=dist.get_backend(), world_size=dist.get_world_size(),
               rank=dist.get_rank(), primary=pd.is_primary(),
               init_s=time.perf_counter() - t0)
    emit(phase="parallel_bringup", **out)
    return out


def phase_parallel_fleet(curve, smi):
    """21 (b): worlds 0-3 of phase 18's curve through ``run_batched`` on a
    fleet mesh over the group: each world bitwise phase 18's W=4 result;
    its pipeline_s against phase 18's, the collectives it issued."""
    import numpy as np
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.parallel import mesh as pm
    from icm_slam_tpu_torch.solver.icm import run_batched
    row4 = next(r for r in curve if r["W"] == 4)
    dss = [w[0] for w in fleet_worlds()[:4]]
    mesh = pm.make_fleet_mesh()
    pm.COLLECTIVES = 0
    res, n = counted(lambda: run_batched(dss, ICMConfig(), "cuda",
                                         mesh=mesh))
    collectives = pm.COLLECTIVES
    check(n["k1"] == 30 and n["k2"] == 0,
          f"fleet mesh launched K1 {n['k1']}x, K2 {n['k2']}x; want 30, 0")
    check(len(res) == 4, f"fleet mesh returned {len(res)} worlds")
    for i, (a, b) in enumerate(zip(res, row4["results"])):
        differ = [f for f in ("x_init", "x", "map_pos", "map_counts")
                  if not np.array_equal(getattr(a, f), getattr(b, f))]
        check(not differ, f"fleet mesh world {i}: {differ} differ from "
                          f"phase 18's W=4")
    t = res[0].timings
    out = dict(W=4, mesh_size=mesh.size(), census=[r.map_pos.shape[0]
                                                   for r in res],
               vs_phase18_w4="bitwise", k1_launches=n["k1"],
               collectives=collectives, pipeline_s=t["pipeline_s"],
               pipeline_s_phase18_w4=row4["pipeline_s"],
               per_world_s=t["per_world_s"],
               refine_per_iter_s=t["refine_per_iter_s"],
               refine_per_iter_s_phase18_w4=row4["refine_per_iter_s"])
    emit(phase="parallel_fleet_mesh", **out, card=smi)
    return n


PAD_TO = 8


def phase_parallel_time(smi):
    """21 (c): the T=1833 world's init and filtered map from ``run()``,
    then 3 sweeps of ``refine_sweep_batched(..., mesh=make_mesh())`` on
    ``shard_sweep_inputs(..., pad_to=8)`` (T 1833 -> 1840, last_t 1832),
    each followed by ``filter_map``, against 3 unsharded sweeps from the
    same start: census exact, poses within 1e-3; the launches, host syncs
    and collectives of one sweep each way."""
    import numpy as np
    import torch
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.core.energy import weights
    from icm_slam_tpu_torch.mapping.landmark_map import filter_map
    from icm_slam_tpu_torch.parallel import mesh as pm
    from icm_slam_tpu_torch.solver import icm
    from icm_slam_tpu_torch.solver.sweeps import refine_sweep_batched
    # K1 at the padded shape against its plain version, the last 7 frames
    # all-masked as the padding is
    pts, mp, mask = shape_inputs("k1", (1840, 48, 128))
    mask[1833:] = False
    err = max(hold_k1(pts, mp, mask, k, 1.0, "(1840, 48, 128) padded")
              for k in (0, 1, 7, 37, 128))
    ds, _ = world_1833()
    cfg = ICMConfig()
    start = icm.run(ds, cfg, "cuda", n_iters=0)
    data = icm.prepare(ds, cfg, "cuda")
    cfg = icm.resolve_config(cfg, data)
    w = weights(cfg, "cuda")
    cur0 = map_of(start.map_pos, start.map_counts, cfg.L)
    x0 = torch.from_numpy(start.x_init).cuda()
    mesh = pm.make_mesh()
    data_s, x_s0, T = pm.shard_sweep_inputs(mesh, data, x0, pad_to=PAD_TO)
    check(T == 1833 and x_s0.shape[0] == 1840,
          f"padding: T {T}, block {x_s0.shape[0]}")

    def sharded(cur, xs):
        st, xs = refine_sweep_batched(data_s, cur, xs, cfg, w, last_t=T - 1,
                                      mesh=mesh)
        return filter_map(st, cfg.cota, cfg.dist_thr,
                          live_cap=cfg.map_run_cap), xs, st

    def unsharded(cur, x):
        st, x = refine_sweep_batched(data, cur, x, cfg, w)
        return filter_map(st, cfg.cota, cfg.dist_thr,
                          live_cap=cfg.map_run_cap), x, st

    def three(step, x):
        cur, census = cur0, []
        for _ in range(3):
            cur, x, st = step(cur, x)
            census.append((int(st.nact), int(cur.nact)))
        return cur, x, census

    pm.COLLECTIVES = 0
    (cur_s, x_s, census_s), n = counted(lambda: three(sharded, x_s0))
    coll = pm.COLLECTIVES
    x_s = pm.gather_time_sharded(mesh, x_s, T)
    cur_u, x_u, census_u = three(unsharded, x0)
    dx = float((x_s - x_u).abs().max())
    dmap = float((cur_s.pos - cur_u.pos).abs().max())
    check(census_s == census_u,
          f"time mesh: census {census_s} != unsharded {census_u}")
    check(dx <= 1e-3, f"time mesh: poses {dx} from the unsharded sweeps")
    check(n["k1"] == 3 and n["k2"] == 0,
          f"time mesh launched K1 {n['k1']}x, K2 {n['k2']}x; want 3, 0")
    prof_s = launches_and_syncs(lambda: sharded(cur_s, x_s0))
    prof_u = launches_and_syncs(lambda: unsharded(cur_u, x0))
    pm.COLLECTIVES = 0
    sharded(cur_s, x_s0)
    out = dict(T=T, padded_T=int(x_s0.shape[0]), last_t=T - 1,
               census_raw_and_filtered=census_s, poses_max_abs_diff=dx,
               map_max_abs_diff=dmap, bitwise=dx == 0.0 and dmap == 0.0,
               tolerance=1e-3, k1_launches=n["k1"],
               k1_padded_vs_plain_sums_max_abs_err=err,
               collectives_3_sweeps=coll,
               collectives_a_sweep=pm.COLLECTIVES,
               sharded_sweep=prof_s, unsharded_sweep=prof_u)
    emit(phase="parallel_time_mesh", **out, card=smi)
    # the live columns K1 met: the start's, then each filtered map's
    seen = [int(cur0.nact)] + [c[1] for c in census_s[:2]]
    return n, {("k1", (1840, 48, 128)): sorted(set(seen))}, err


def phase_parallel_pipeline(smi):
    """21 (d): ``pipeline_stages`` at S=1 on the NCCL group (the arithmetic
    pipeline of tests/test_pipeline.py as one stage, six chunks), exact;
    ``pipelined_refine_pass`` needs three ranks and does not run on one
    card."""
    import torch
    import torch.distributed as dist
    from icm_slam_tpu_torch.parallel import mesh as pm
    from icm_slam_tpu_torch.parallel.pipeline import (make_stage_mesh,
                                                      pipeline_stages)
    chunks = torch.arange(24, dtype=torch.float32, device="cuda").view(6, 4)
    mesh = make_stage_mesh(1)
    pm.COLLECTIVES = 0
    out = pipeline_stages(
        mesh, [lambda c, p: {"v": (p["v"] + 1.0) * c["scale"] - 3.0}],
        lambda c, i: {"v": chunks[i]}, 6,
        {"scale": torch.tensor(2.0, device="cuda")})["v"]
    check(torch.equal(out, (chunks + 1.0) * 2.0 - 3.0),
          "pipeline_stages at S=1 differs from the composition")
    emit(phase="parallel_pipeline", stages=1, chunks=6, exact=True,
         collectives=pm.COLLECTIVES,
         pipelined_refine_pass="not run on one card: its three stages "
                               "need three ranks (tests/"
                               "test_torch_parallel_pipeline.py holds it "
                               "on three gloo CPU ranks)", card=smi)
    dist.destroy_process_group()


# phase 22: the trace of one sweep goes here (build/ is not committed)
TRACE_DIR = os.path.join(WORK, "trace")


class PlotRecorder:
    """Has ``utils.viz.LivePlot``'s ``update``: keeps what each call got
    (the card's machine has no matplotlib)."""

    def __init__(self):
        self.calls = []

    def update(self, x, landmarks, odom=None):
        self.calls.append((x, landmarks, odom))


def phase_live_plot(smi):
    """22 (a): ``api.run_offline(world, ICMConfig(N=3), "cuda",
    live_plot=recorder)`` on the T=1833 world: exactly 3 updates of NumPy
    (1833, 3) poses and (n, 2) landmarks, the last one bitwise the result,
    the result bitwise the same call without the live plot; the runs in
    turns live, plain, plain, live, ``refine_per_iter_s`` of each."""
    import numpy as np
    from icm_slam_tpu_torch import api
    from icm_slam_tpu_torch.config import ICMConfig
    ds, _ = world_1833()
    cfg = ICMConfig(N=3)
    rec = PlotRecorder()
    live, n = counted(lambda: api.run_offline(ds, cfg, "cuda",
                                              live_plot=rec))
    plain = api.run_offline(ds, cfg, "cuda")
    plain2 = api.run_offline(ds, cfg, "cuda")
    rec2 = PlotRecorder()
    live2 = api.run_offline(ds, cfg, "cuda", live_plot=rec2)
    check(n["k1"] == 3 and n["k2"] == 0,
          f"live-plot run launched K1 {n['k1']}x, K2 {n['k2']}x; want 3, 0")
    check(len(rec.calls) == len(rec2.calls) == 3,
          f"{len(rec.calls)}, {len(rec2.calls)} live-plot updates; want 3")
    for x, lm, odom in rec.calls:
        check(isinstance(x, np.ndarray) and isinstance(lm, np.ndarray)
              and x.shape == (1833, 3) and lm.ndim == 2
              and lm.shape[1] == 2 and odom is ds.odom,
              f"live-plot update got {type(x)} {getattr(x, 'shape', None)}, "
              f"{getattr(lm, 'shape', None)}")
    check(np.array_equal(rec.calls[-1][0], live.x)
          and np.array_equal(rec.calls[-1][1], live.map_pos),
          "the last live-plot update is not the result")
    fields = ("x_init", "x", "map_pos", "map_counts", "changes")
    for a, b, what in ((live, plain, "with and without the live plot"),
                       (plain, plain2, "plain run twice"),
                       (live, live2, "live-plot run twice")):
        differ = [f for f in fields
                  if not np.array_equal(getattr(a, f), getattr(b, f))]
        check(not differ, f"{what}: {differ} differ")
    sweep = {k: [r.timings["refine_per_iter_s"] for r in runs]
             for k, runs in (("live", (live, live2)),
                             ("plain", (plain, plain2)))}
    emit(phase="live_plot", world="synthetic_world(T=1833, seed=0)",
         config="ICMConfig(N=3)", updates=len(rec.calls),
         census_per_sweep=[lm.shape[0] for _, lm, _ in rec.calls],
         k1_launches=n["k1"], vs_plain="bitwise",
         order="live, plain, plain, live",
         refine_per_iter_s_live=sweep["live"],
         refine_per_iter_s_plain=sweep["plain"],
         live_over_plain=sum(sweep["live"]) / sum(sweep["plain"]),
         init_s_live=[r.timings["init_s"] for r in (live, live2)],
         init_s_plain=[r.timings["init_s"] for r in (plain, plain2)],
         card=smi)
    return n


def phase_phase_timer(smi):
    """22 (c): ``PhaseTimer.phase`` around 100 launches of K2 at the
    uncapped fleet's (4, 1833, 104, 1024), ``block_on`` a dict holding the
    last output and a MapState on the card, against the CUDA-event time of
    the same 100 launches: at least 0.9 of it; the phase without
    ``block_on`` beside it (what the host takes to issue them)."""
    import torch
    from icm_slam_tpu_torch.mapping.landmark_map import empty_map
    from icm_slam_tpu_torch.utils.profiling import PhaseTimer
    shape, reps = (4, 1833, 104, 1024), 100
    fn = kernel_call("k2", shape, 1024)
    fn()
    torch.cuda.synchronize()
    timer = PhaseTimer()
    held = {"map": empty_map(8, device="cuda")}
    with timer.phase("blocked", block_on=held):
        for _ in range(reps):
            held["k2"] = fn()
    with timer.phase("unblocked"):
        for _ in range(reps):
            fn()
    torch.cuda.synchronize()
    event_ms = cuda_ms(fn, reps) * reps
    blocked_ms = timer.totals["blocked"] * 1e3
    check(blocked_ms >= 0.9 * event_ms,
          f"PhaseTimer read {blocked_ms} ms for {reps} launches the card "
          f"took {event_ms} ms over: it did not wait for the device")
    out = dict(shape=list(shape), launches=reps, phase_ms=blocked_ms,
               cuda_event_ms=event_ms,
               unblocked_ms=timer.totals["unblocked"] * 1e3,
               ratio=blocked_ms / event_ms, report=timer.report())
    emit(phase="phase_timer", **out, card=smi)
    return out


def trace_sweep_main():
    """``--trace-sweep`` (22 (b), a process of its own, so that no earlier
    profiler window shares it): one refine sweep + map filter
    (``_refine_step``) on the T=1833 world's hoisted data, after one warm
    sweep from ``run(..., n_iters=0)``'s start, under
    ``utils.profiling.device_trace`` into build/chip_smoke/trace/; the
    trace parsed, its kernel events counted; then ``launches_and_syncs``
    of the same sweep.  Prints one JSON line."""
    import glob
    import shutil
    sys.path.insert(0, HERE)
    import torch
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.core.energy import weights
    from icm_slam_tpu_torch.solver import icm
    from icm_slam_tpu_torch.utils.profiling import device_trace
    torch.backends.cuda.matmul.allow_tf32 = False
    ds, _ = world_1833()
    cfg = ICMConfig()
    start = icm.run(ds, cfg, "cuda", n_iters=0)
    data = icm.prepare(ds, cfg, "cuda")
    cfg = icm.resolve_config(cfg, data)
    data = icm.hoist_compaction(data, cfg)
    w = weights(cfg, "cuda")
    cur = map_of(start.map_pos, start.map_counts, cfg.L)
    x = torch.from_numpy(start.x_init).cuda()
    cur, x, _ = icm._refine_step(data, cur, x, cfg, w)

    def sweep():
        return icm._refine_step(data, cur, x, cfg, w)

    sweep()
    torch.cuda.synchronize()
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    with device_trace(TRACE_DIR):
        sweep()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    t2 = time.perf_counter()
    (path,) = glob.glob(os.path.join(TRACE_DIR, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    t3 = time.perf_counter()
    kernels = [e for e in events if e.get("cat") == "kernel"]
    prof = launches_and_syncs(sweep)
    print(json.dumps(dict(
        trace_file=os.path.relpath(path, HERE),
        trace_bytes=os.path.getsize(path), trace_events=len(events),
        trace_kernels=len(kernels),
        k1_in_trace=sum(KERNEL_NAME_PART["k1"] in e.get("name", "")
                        for e in kernels),
        k2_in_trace=sum(KERNEL_NAME_PART["k2"] in e.get("name", "")
                        for e in kernels),
        k3_in_trace=sum(KERNEL_NAME_PART["k3"] in e.get("name", "")
                        for e in kernels),
        traced_sweep_s=t1 - t0, export_s=t2 - t1, parse_s=t3 - t2,
        profiler_kernel_launches=prof["kernel_launches"],
        profiler_host_syncs=prof["host_syncs"])), flush=True)


def phase_utils(smi):
    """22: the profiling and plotting modules on the card, around the main
    path: (a) the live plot (in process), (c) ``PhaseTimer``, then three
    kinds of processes at once: (b) ``device_trace`` of one sweep against
    the profiler's launch count (``--trace-sweep``), (d) the CLI's
    ``--plot`` (without matplotlib it must exit non-zero naming it and
    print no summary; with it both PNGs must be written), (e) examples 06
    (fleet mode, K1 with a world axis) and 02 (online, K2 each frame) on
    the card, each exiting 0 and printing its census."""
    import importlib.util
    import re
    import shutil
    n22 = phase_live_plot(smi)
    phase_phase_timer(smi)

    os.makedirs(WORK, exist_ok=True)
    plots = os.path.join(WORK, "plots")
    shutil.rmtree(plots, ignore_errors=True)
    examples = os.path.join(HERE, "examples_torch")
    cmds = {
        "trace": [os.path.abspath(__file__), "--trace-sweep"],
        "cli_plot": ["-m", "icm_slam_tpu_torch", "run", "--dataset",
                     "synthetic", "--frames", "200", "--iters", "1",
                     "--plot", plots],
        "example_06": [os.path.join(examples, "06_fleet_mode.py"),
                       "--device", "cuda"],
        "example_02": [os.path.join(examples, "02_online_streaming.py"),
                       "--device", "cuda", "--frames", "200"]}
    # each process writes into files (no pipe to fill); each one's seconds
    # from the common start to its exit
    logs = {k: [os.path.join(WORK, f"phase22_{k}.{s}") for s in ("out",
                                                                "err")]
            for k in cmds}
    t0 = time.perf_counter()
    procs = {}
    for k, c in cmds.items():
        with open(logs[k][0], "w") as out, open(logs[k][1], "w") as err:
            procs[k] = subprocess.Popen([sys.executable, *c], cwd=HERE,
                                        stdout=out, stderr=err)
    done = {}
    try:
        while len(done) < len(procs):
            check(time.perf_counter() - t0 < 300,
                  f"phase 22's processes {sorted(set(procs) - set(done))} "
                  f"still running after 300 s")
            for k, proc in procs.items():
                if k not in done and proc.poll() is not None:
                    done[k] = time.perf_counter() - t0
            time.sleep(0.1)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for k, secs in done.items():
        with open(logs[k][0]) as out, open(logs[k][1]) as err:
            done[k] = (procs[k].returncode, out.read(), err.read(), secs)

    def ok(k):
        rc, out, err, _ = done[k]
        check(rc == 0, f"{k} exited {rc}:\n{err[-3000:]}")
        return out

    trace = json.loads(ok("trace").strip().splitlines()[-1])
    n_prof = trace["profiler_kernel_launches"]
    check(abs(trace["trace_kernels"] - n_prof) <= 0.01 * n_prof,
          f"device_trace holds {trace['trace_kernels']} kernels; the "
          f"profiler counted {n_prof} launches of the same sweep")
    check(trace["k1_in_trace"] == 1 and trace["k3_in_trace"] == 1,
          f"K1 appears {trace['k1_in_trace']}x and K3 "
          f"{trace['k3_in_trace']}x in the sweep's trace; want 1 each")
    check(trace["profiler_host_syncs"] == 0,
          f"the traced sweep synchronized {trace['profiler_host_syncs']}x")
    emit(phase="device_trace", **trace, seconds=done["trace"][3],
         card=smi)

    rc, out, err, secs = done["cli_plot"]
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    summary = [ln for ln in out.splitlines() if ln.startswith("{")]
    if has_mpl:
        check(rc == 0, f"cli --plot exited {rc}:\n{err[-3000:]}")
        sizes = {f: os.path.getsize(os.path.join(plots, f))
                 if os.path.isfile(os.path.join(plots, f)) else 0
                 for f in ("slam.png", "convergence.png")}
        check(all(v > 1000 for v in sizes.values()),
              f"cli --plot wrote {sizes}")
        result = dict(branch="matplotlib present: both PNGs written",
                      png_bytes=sizes)
    else:
        check(rc != 0 and "matplotlib" in err and not summary
              and not os.path.exists(plots),
              f"without matplotlib cli --plot exited {rc}, printed "
              f"{summary}, stderr {err[-500:]!r}")
        result = dict(branch="matplotlib missing: exited before any work",
                      exit_code=rc, message=err.strip().splitlines()[-1])
    emit(phase="cli_plot", **result, seconds=secs, card=smi)

    censuses = {}
    for k, pattern in (("example_06", r"^fleet sharded over 1 rank\(s\): "
                                      r"same censuses (\[[\d, ]+\])"),
                       ("example_02", r"^online run: 200 poses, "
                                      r"(\d+) landmarks$")):
        m = re.search(pattern, ok(k), re.M)
        check(m is not None, f"{k} printed no census:\n{done[k][1][-2000:]}")
        censuses[k] = json.loads(m.group(1))
    emit(phase="examples", census_06_fleet=censuses["example_06"],
         census_02_online=censuses["example_02"],
         seconds={k: done[k][3] for k in ("example_06", "example_02")},
         card=smi)
    return n22


# ---------------------------------------------------------------------------
# phase 23: K3 and the refine sweeps replayed from one CUDA graph
# ---------------------------------------------------------------------------

# the (W, K) shapes K3 is held against its plain version at: every K3
# shape of KERNEL_SHAPES (all that the counted runs give it), and the
# non-quirk table's width (L = 2048), which an uncapped filter there
# would walk
K3_HELD = tuple(shape for kind, shape, _ in KERNEL_SHAPES
                if kind == "k3") + ((1, 2048),)


def walk_inputs(W, K, ns, seed, chained):
    """K3's inputs on the card: ``chained``, every row close and pointing at
    its successor (the longest walk: one group, K - 1 steps that relabel),
    else neighbours near their row or anywhere, an eighth of the rows
    close; world w walks its first ns[w] rows."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    if chained:
        nn = np.minimum(np.arange(K) + 1, K - 1)[None].repeat(W, 0)
        close = np.ones((W, K), bool)
    else:
        nn = np.clip(np.arange(K)[None] + rng.integers(-3, 4, (W, K)), 0,
                     K - 1)
        nn = np.where(rng.uniform(size=(W, K)) < 0.2,
                      rng.integers(0, K, (W, K)), nn)
        close = rng.uniform(size=(W, K)) < 0.125
    dev = torch.device("cuda")
    return (torch.from_numpy(nn.astype(np.int32)).to(dev),
            torch.from_numpy(close).to(dev),
            torch.tensor(ns, dtype=torch.int32, device=dev))


def world_counts(n, W, K):
    """World 0 walks ``n`` rows, the others other counts in [0, K]."""
    return [n] + [(n * (w + 1) + 37 * w) % (K + 1) for w in range(1, W)]


def k3_inputs(shape, n):
    """The inputs of K3's row at ``shape`` = (W, K) of KERNEL_SHAPES:
    random close rows (an eighth), world 0 walking ``n`` rows."""
    W, K = shape
    seed = {s[:2]: s[2] for s in KERNEL_SHAPES}[("k3", shape)]
    return walk_inputs(W, K, world_counts(min(n, K), W, K), seed=seed,
                       chained=False)


def phase_k3():
    """23 (a): K3 against its plain version at K3_HELD, n in {0, 1, 37, K}
    for world 0 (the other worlds other counts), random and chained close
    rows: labels bitwise.  Returns the largest label difference (0)."""
    import torch
    from icm_slam_tpu_torch.ops import relabel as k3
    held = []
    for W, K in K3_HELD:
        for n in (0, 1, 37, K):
            for chained in (False, True):
                ins = walk_inputs(W, K, world_counts(min(n, K), W, K),
                                  seed=W * K + n, chained=chained)
                lab = k3.relabel_walk(*ins)
                lab_p = k3.relabel_walk_plain(*ins)
                torch.cuda.synchronize()
                check(torch.equal(lab, lab_p),
                      f"K3 labels differ from the plain walk at ({W}, {K}) "
                      f"n={n} chained={chained}")
        held.append([W, K])
    ins = walk_inputs(1, 128, [128], seed=1, chained=False)
    ms, plain_ms = time_pair(lambda: k3.relabel_walk(*ins),
                             lambda: k3.relabel_walk_plain(*ins), reps=20)
    emit(phase="k3_vs_plain", shapes=held, n=[0, 1, 37, "K"],
         close=["random (1/8)", "chained (all)"], labels="bitwise",
         issue_interval_ms=ms, plain_ms=plain_ms,
         plan=k3.launch_plan(128)._asdict())
    return dict(max_abs_err=0, plain_ms=plain_ms)


def k3_bound_us(nn, close, n):
    """The least time of one K3 call on these inputs, and what bounds it:
    nn and close read once, n read once, the labels written once, over
    the memory rate; against one compare of every row for each close row
    the walk meets (what these inputs need), over the f32 peak."""
    import torch
    W, K = nn.shape
    walked = int((close & (torch.arange(K, device=nn.device)
                           < n[:, None])).sum())
    ops_us = walked * K / PEAK_F32_FLOPS * 1e6
    bytes_us = W * (9 * K + 4) / PEAK_BYTES_PER_S * 1e6
    return max(ops_us, bytes_us), ("operations" if ops_us >= bytes_us
                                   else "bytes")


def no_sync(fn, what):
    """``fn()`` under PyTorch's sync debug mode "error": any synchronizing
    CUDA operation raises.  Returns what ``fn`` returned."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    except RuntimeError as e:
        raise AssertionError(f"{what} synchronized with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")


def sweep_start(datasets, cfg):
    """The state after the init and its map filter, with the hoisted data,
    on the card, as ``run()`` (``datasets`` a Dataset) or ``run_batched``
    (a list) reach it: (data, cur_map, x, resolved config, weights)."""
    import torch
    from icm_slam_tpu_torch.core.energy import weights
    from icm_slam_tpu_torch.mapping.landmark_map import filter_map
    from icm_slam_tpu_torch.solver import icm
    if isinstance(datasets, list):
        data, seed, x0, cfg, w = icm.prepare_fleet(datasets, cfg, "cuda")
    else:
        data = icm.prepare(datasets, cfg, "cuda")
        cfg = icm.resolve_config(cfg, data)
        x0 = torch.as_tensor(datasets.x0, device="cuda").to(data.dist.dtype)
        seed, w = icm.seed_map(data, x0, cfg), weights(cfg, "cuda")
    state, x, _ = icm._init(data, seed, x0, cfg, w)
    cur = filter_map(state, cfg.cota, cfg.dist_thr, live_cap=cfg.map_run_cap)
    return icm.hoist_compaction(data, cfg), cur, x, cfg, w


def eager_sweeps(start, N):
    """N sweeps of ``_refine_step`` one by one (and ``map_change``), as the
    loop ran before the graph: (map, x, witnesses (N, ...), changes)."""
    import torch
    from icm_slam_tpu_torch.solver import icm
    data, cur, x, cfg, w = start
    wits, chgs = [], []
    for _ in range(N):
        new, x, wit = icm._refine_step(data, cur, x, cfg, w)
        chgs.append(icm.map_change(new, cur, live_cap=cfg.map_run_cap))
        wits.append(wit)
        cur = new
    return cur, x, torch.stack(wits), torch.stack(chgs)


def graph_sweeps(start, N, timings):
    """N sweeps through ``icm.refine_sweeps`` (one eager, a capture, N - 1
    replays); the replays after the first run under the sync debug mode
    "error", and their mean seconds go to ``timings["replay_s"]`` (from a
    synchronized card to a synchronized card).  Returns what
    ``eager_sweeps`` returns."""
    import torch
    from icm_slam_tpu_torch.solver import icm
    data, cur, x, cfg, w = start
    gen = icm.refine_sweeps(data, cur, x, cfg, w, N, change=True,
                            timings=timings)
    out = [next(gen) for _ in range(min(N, 2))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out += no_sync(lambda: list(gen), "a replayed sweep")
    torch.cuda.synchronize()
    timings["replay_s"] = (time.perf_counter() - t0) / max(N - 2, 1)
    cur, x = out[-1][0], out[-1][1]
    return (cur, x, torch.stack([o[2] for o in out]),
            torch.stack([o[3] for o in out]))


def same_sweeps(a, b):
    import torch
    (ma, xa, wa, ca), (mb, xb, wb, cb) = a, b
    return (all(torch.equal(u, v) for u, v in zip(ma, mb))
            and torch.equal(xa, xb) and torch.equal(wa, wb)
            and torch.equal(ca, cb))


def phase_graph(smi, N=30):
    """23 (b)-(e): one batched sweep (+ map filter, + map_change) under the
    sync debug mode "error" on the main world capped and uncapped and on
    the fleet of eight; then N sweeps eager and from the graph, in turns
    eager, graph, graph, eager, on the main world and the fleet of eight:
    map, poses, witnesses and changes bitwise between every turn, replays
    N - 1 a graph run (its first sweep is eager), K1 N times in each;
    each turn's seconds a sweep (the graph's with its capture and first
    eager sweep) and a graph turn's seconds a replay; one replay under the
    sync debug mode and the profiler (its device time)."""
    import dataclasses
    import torch
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.solver import cuda_graph, icm
    ds, _ = world_1833()
    starts = {"main": sweep_start(ds, ICMConfig()),
              "fleet8": sweep_start([d for d, _ in fleet_worlds()[:8]],
                                    ICMConfig())}
    data, cur, x, cfg, w = starts["main"]
    check(0 < cfg.map_run_cap < cfg.L, f"main start not capped: {cfg}")
    uncapped = dataclasses.replace(cfg, map_run_cap=0)
    synced = {}
    for what, (d, c, xx, cf, ww) in (("capped W=1", starts["main"]),
                                     ("uncapped W=1", (data, cur, x,
                                                       uncapped, w)),
                                     ("capped W=8", starts["fleet8"])):
        def one():
            new, _, _ = icm._refine_step(d, c, xx, cf, ww)
            return icm.map_change(new, c, live_cap=cf.map_run_cap)
        one()                                 # lazy set-up outside the mode
        no_sync(one, f"one batched sweep ({what})")
        synced[what] = 0
    emit(phase="sweep_host_syncs", sweeps=synced,
         mode='torch.cuda.set_sync_debug_mode("error")', card=smi)
    runs = {}
    for name, start in starts.items():
        turns, times, n_k1 = [], [], []
        for kind in ("eager", "graph", "graph", "eager"):
            timings = {}
            replays = cuda_graph.REPLAYS
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, n = counted(
                (lambda: graph_sweeps(start, N, timings)) if kind == "graph"
                else (lambda: eager_sweeps(start, N)))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if kind == "graph":
                check(cuda_graph.REPLAYS - replays == N - 1,
                      f"{name}: {cuda_graph.REPLAYS - replays} replays in a "
                      f"graph run of {N} sweeps; want {N - 1}")
            check(n["k1"] == N and n["k2"] == 0 and n["k3"] == N,
                  f"{name} {kind}: K1 {n['k1']}x, K2 {n['k2']}x, K3 "
                  f"{n['k3']}x; want {N}, 0, {N}")
            if turns:
                check(same_sweeps(turns[0], out),
                      f"{name}: the {kind} run differs from the first eager "
                      f"run (map, poses, witnesses or changes)")
            turns.append(out)
            times.append(dict(kind=kind, sweep_s=secs / N,
                              capture_s=timings.get("capture_s"),
                              replay_s=timings.get("replay_s")))
        eager = [t["sweep_s"] for t in times if t["kind"] == "eager"]
        graph = [t["sweep_s"] for t in times if t["kind"] == "graph"]
        gen = icm.refine_sweeps(*start, 4)
        next(gen), next(gen)
        replay = launches_and_syncs(lambda: next(gen))
        runs[name] = dict(
            W=1 if name == "main" else 8, N=N, turns=times,
            eager_sweep_s=eager, graph_sweep_s=graph,
            graph_over_eager=sum(graph) / sum(eager),
            replay_s=[t["replay_s"] for t in times if t["kind"] == "graph"],
            replay_profile={k: v for k, v in replay.items()
                            if k != "top_kernels_ms_count"},
            census=[int(v) for v in turns[0][0].nact.reshape(-1)],
            replays_a_graph_run=N - 1, vs_eager="bitwise")
    emit(phase="graph_vs_eager", order="eager, graph, graph, eager",
         note="a graph run: the first sweep eager, then the capture, then "
              "N - 1 replays; sweep_s includes the capture",
         **runs, card=smi)
    return runs


PARENT_ROOT = os.path.join(HERE, "build", "parent")


def phase_old_vs_new(nacts, smi):
    """The kernel table of another commit's package against this one's on
    this card, in turns old, new, new, old, each turn a process of its own
    (``--time-kernels``).  The other commit is whatever checkout of the
    package lies under build/parent/ (for instance ``git archive HEAD~1
    icm_slam_tpu_torch | tar -x -C build/parent``); it is never committed,
    and without it this phase reports that and measures nothing."""
    if not os.path.isdir(os.path.join(PARENT_ROOT, "icm_slam_tpu_torch")):
        emit(phase="old_vs_new", skipped="no package under build/parent/")
        return
    arg = [",".join(str(v) for v in nacts[k]) for k in ("k1", "k2")]
    turns = []
    for who, root in (("old", PARENT_ROOT), ("new", HERE), ("new", HERE),
                      ("old", PARENT_ROOT)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--time-kernels",
             root, *arg], cwd=HERE, capture_output=True, text=True,
            timeout=300)
        check(proc.returncode == 0,
              f"--time-kernels {root} exited {proc.returncode}:\n"
              f"{proc.stderr[-3000:]}")
        turns.append((who, json.loads(proc.stdout.strip().splitlines()[-1])))
    rows = []
    for i, first in enumerate(turns[0][1]["rows"]):
        row = {k: first[k] for k in ("kernel", "shape", "nact", "bound_us")}
        for key in ("own_us", "issue_us"):
            for who in ("old", "new"):
                row[f"{who}_{key}"] = [t["rows"][i][key] for w, t in turns
                                       if w == who]
        row["old_variant"] = turns[0][1]["rows"][i]["variant"]
        row["new_variant"] = turns[1][1]["rows"][i]["variant"]
        rows.append(row)
    emit(phase="old_vs_new", order=[w for w, _ in turns],
         floor_own_us={w + str(i): t["floor"]["own_us"]
                       for i, (w, t) in enumerate(turns)},
         rows=rows, card=smi)


# which run's launches a shape's row reports, and what that run is
LAUNCHED_BY = {
    ("k1", (1833, 48, 128)): ("main", "the default run, N=30 (phase 4)"),
    ("k2", (1833, 48, 1024)): ("uncapped",
                               "the uncapped run, N=3 (phase 5)"),
    ("k2", (1833, 48, 128)): ("nonquirk",
                              "the non-quirk Jacobi run, N=3 (phase 9)"),
    ("k2", (1, 181, 1024)): ("sequential",
                             "the sequential run, N=1 (phase 8)"),
    ("k2", (1, 48, 2048)): ("nonquirk",
                            "the non-quirk Jacobi run's causal init "
                            "(phase 9)"),
    ("k1", (240, 16, 128)): ("hooks_causal",
                             "the small world's capped sweeps, N=3 "
                             "(phase 14)"),
    ("k2", (1, 16, 256)): ("hooks_causal",
                           "the small world's causal init (phase 14)"),
    ("k1", (2, 1833, 96, 128)): ("fleet_w2",
                                 "the fleet curve's W=2 run, N=30 (phase 18)"),
    ("k1", (4, 1833, 104, 128)): ("fleet_w4",
                                  "the fleet curve's W=4 run, N=30 "
                                  "(phase 18)"),
    ("k1", (8, 1833, 152, 128)): ("fleet_w8",
                                  "the fleet curve's W=8 run, N=30 "
                                  "(phase 18)"),
    ("k2", (4, 1833, 104, 1024)): ("fleet_uncapped",
                                   "the uncapped fleet of four, N=3 "
                                   "(phase 18)"),
    ("k1", (3, 240, 48, 128)): ("fleet_small",
                                "the small capped fleet, N=3 (phase 18)"),
    ("k2", (3, 300, 136, 256)): ("fleet_small",
                                 "the small uncapped fleet, N=4 (phase 18)"),
    ("k2", (4, 1, 181, 1024)): ("modes_seq",
                                "the W=4 sequential fleet, 400 frames, N=1 "
                                "(phase 20)"),
    ("k2", (4, 1, 104, 2048)): ("modes_nq",
                                "the W=4 non-quirk Jacobi fleet's causal "
                                "init, 400 frames (phase 20)"),
    ("k2", (4, 1, 104, 1024)): ("modes_iseq",
                                "the W=4 init_mode='sequential' fleet's "
                                "causal init, 400 frames (phase 20)"),
    ("k2", (4, 400, 104, 128)): ("modes_nq",
                                 "the W=4 non-quirk Jacobi fleet's sweeps, "
                                 "N=3 (phase 20)"),
    ("k1", (4, 400, 104, 128)): ("modes_iseq",
                                 "the W=4 init_mode='sequential' fleet's "
                                 "sweeps, N=3 (phase 20)"),
    ("k2", (3, 1, 181, 256)): ("modes_small_seq",
                               "the small sequential fleet, N=2 (phase 20)"),
    ("k2", (3, 1, 16, 256)): ("modes_small_nq",
                              "the small non-quirk fleet's causal init "
                              "(phase 20)"),
    ("k2", (3, 120, 16, 256)): ("modes_small_ba",
                                "the small ba fleet, N=2 (phase 20)"),
    ("k1", (1840, 48, 128)): ("parallel_time",
                              "the 3 time-sharded sweeps, T=1833 padded "
                              "to 1840 (phase 21)"),
    ("k3", (1, 128)): ("main", "the default run, N=30 (phase 4): the "
                               "filter after each sweep and the init's"),
    ("k3", (1, 1024)): ("uncapped", "the uncapped run, N=3 (phase 5): "
                                    "the filters and the init's merge"),
    ("k3", (2, 128)): ("fleet_w2", "the fleet curve's W=2 run, N=30 "
                                   "(phase 18)"),
    ("k3", (2, 1024)): ("fleet_w2", "the fleet curve's W=2 run's init "
                                    "merge (phase 18)"),
    ("k3", (3, 128)): ("fleet_small", "the small capped fleet, N=3 "
                                      "(phase 18)"),
    ("k3", (3, 256)): ("fleet_small", "the small fleets' filters at "
                                      "L=256 (phase 18)"),
    ("k3", (4, 128)): ("fleet_w4", "the fleet curve's W=4 run, N=30 "
                                   "(phase 18)"),
    ("k3", (4, 1024)): ("fleet_uncapped", "the uncapped fleet of four, "
                                          "N=3 (phase 18)"),
    ("k3", (8, 128)): ("fleet_w8", "the fleet curve's W=8 run, N=30 "
                                   "(phase 18)"),
    ("k3", (8, 1024)): ("fleet_w8", "the fleet curve's W=8 run's init "
                                    "merge (phase 18)")}


def check_shapes_covered(launches):
    """Every shape a counted run gave a kernel must have its rows in the
    kernel table (and with them its check against the plain version).
    """
    table = {s[:2] for s in KERNEL_SHAPES}
    met = {key for n in launches.values() for key in n["shapes"]}
    check(met <= table, f"shapes launched on a path without a row in "
                        f"KERNEL_SHAPES: {sorted(met - table)}")
    for key, (run, _) in LAUNCHED_BY.items():
        check(launches[run]["shapes"].get(key, 0) > 0,
              f"the {run} run never launched {key}")


def kernels_line(launches, checks, rows):
    """The contract's line: one entry per kernel with the main shape's
    numbers on top and every shape's row under ``shapes``."""
    def entry(name, source, replaces, kind, shape):
        main_row = next(r for r in rows if r["kernel"] == kind
                        and r["shape"] == list(shape)
                        and r["nact"] == shape[-1])
        shapes = []
        for r in rows:
            if r["kernel"] != kind:
                continue
            key = (kind, tuple(r["shape"]))
            by_run = {name: n["shapes"][key] for name, n in launches.items()
                      if key in n.get("shapes", {})}
            run, by = LAUNCHED_BY[key]
            shapes.append(dict(
                r, launched_by=by, library_ms=None,
                launches=launches[run]["shapes"][key],
                launches_by_run=by_run))
        return dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches["all"][kind],
            max_abs_err=checks[kind]["max_abs_err"],
            ms=main_row["own_us"] / 1e3, plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_us"] / 1e3,
            bound_by=main_row["bound_by"], library_ms=None,
            issue_interval_ms=main_row["issue_us"] / 1e3, shapes=shapes)

    return [
        entry("associate_and_sums", "icm_slam_tpu_torch/csrc/assoc_sums.cu",
              "icm_slam_tpu/ops/assoc_sums_pallas.py:70", "k1",
              (1833, 48, 128)),
        entry("nearest_landmark",
              "icm_slam_tpu_torch/csrc/nearest_landmark.cu",
              "icm_slam_tpu/ops/assoc_pallas.py:76", "k2",
              (1833, 48, 1024)),
        entry("relabel_walk", "icm_slam_tpu_torch/csrc/relabel_walk.cu",
              "icm_slam_tpu/mapping/landmark_map.py:219", "k3", (1, 128))]


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

    walls = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t
        print(f"chip_smoke: {name} {walls[name]:.1f} s", file=sys.stderr,
              flush=True)
        return out

    def kernel_timing(nacts):
        emit(phase="launch_floor", **launch_floor(),
             note="K2 on one point, a table of one column, nact=0", card=smi)
        rows = kernel_table(nacts)
        emit(phase="kernel_table", rows=rows, nact_as_run={
            k if isinstance(k, str) else f"{k[0]} {list(k[1])}": v
            for k, v in nacts.items()}, card=smi)
        emit(phase="k2_variants_timed", rows=k2_variants_timed(nacts),
             card=smi)
        phase_old_vs_new(nacts, smi)
        return rows

    k1 = timed("k1", phase_k1)
    k2 = timed("k2", phase_k2)
    k3 = timed("k3", phase_k3)
    g = np.load(GOLDEN)
    launches, nacts = timed("main_uncapped", phase_main, g, smi)
    timed("small", phase_small, g)
    counts7, one_world = timed("profile", phase_profile, smi)
    for kind, counts in counts7.items():
        nacts[kind] += counts
    # K3's rows: n = K and the fewest live rows a filter met
    nacts["k3"] = [min(nacts["k1"])]
    ge = np.load(GOLDEN_ENGINES)
    n8, seq_res = timed("sequential", phase_sequential, ge, smi)
    nacts["k2"].append(seq_res.map_pos.shape[0])
    n9, nq_res = timed("nonquirk_jacobi", phase_nonquirk_jacobi, ge, smi)
    nacts["k2"].append(nq_res.map_pos.shape[0])
    k2_frame = timed("k2_per_frame", phase_k2_per_frame)
    n11 = timed("entry_points", phase_entry_points, seq_res, smi)
    gm = np.load(GOLDEN_MODELS)
    n13, _ = timed("hooks_batched", phase_hooks_batched, gm, smi)
    n14, hc_res = timed("hooks_causal", phase_hooks_causal, gm, smi)
    nacts["k2"].append(hc_res.map_pos.shape[0])
    n15, ba_res = timed("ba", phase_ba, gm, smi, "ba")
    n16, wba_res = timed("windowed_ba", phase_ba, gm, smi, "windowed_ba")
    closed = timed("loop_closure", phase_loop_closure, gm, smi)
    launches.update(sequential=n8, nonquirk=n9, entry_points=n11,
                    hooks_batched=n13, hooks_causal=n14, ba=n15,
                    windowed_ba=n16)
    t18 = time.perf_counter()
    fk = timed("fleet_kernels", phase_fleet_kernels)
    gf = np.load(GOLDEN_FLEET)
    n18b, nacts18b = timed("fleet_small", phase_fleet_small, gf)
    n18c, nacts18c, curve = timed("fleet_curve", phase_fleet_curve, gf, smi)
    timed("fleet_profile", phase_fleet_profile, curve, one_world, smi)
    n18e, nacts18e = timed("fleet_uncapped", phase_fleet_uncapped, smi)
    launches.update(fleet_small=n18b, fleet_uncapped=n18e, **n18c)
    # a fleet shape's table rows: the width, and the fewest and the most
    # live columns its worlds left (the one-world shape keeps its counts)
    for key, counts in {**nacts18b, **nacts18c, **nacts18e}.items():
        if len(key[1]) == 4:
            nacts[key] = sorted({min(counts), max(counts)})
    emit(phase="fleet_wall_seconds", seconds=time.perf_counter() - t18)
    timed("online", phase_online, smi)
    t20 = time.perf_counter()
    fmk = timed("fleet_modes_kernels", phase_modes_kernels)
    n20b, nacts20b = timed("fleet_modes_small", phase_modes_small,
                           np.load(GOLDEN_MODES))
    n20c, nacts20c, ba_fleet = timed("fleet_modes_full", phase_modes_full,
                                     smi)
    timed("models_repeatable", phase_repeatable, ba_fleet,
          {"ba": ba_res, "windowed_ba": wba_res}, closed)
    launches.update(**n20b, **n20c)
    for key, counts in {**nacts20b, **nacts20c}.items():
        if len(key[1]) == 4:
            nacts[key] = sorted({min(counts), max(counts)})
    emit(phase="fleet_modes_wall_seconds", seconds=time.perf_counter() - t20)
    t21 = time.perf_counter()
    timed("parallel_bringup", phase_parallel_bringup)
    n21b = timed("parallel_fleet", phase_parallel_fleet, curve, smi)
    n21c, nacts21c, err21 = timed("parallel_time", phase_parallel_time, smi)
    timed("parallel_pipeline", phase_parallel_pipeline, smi)
    launches.update(parallel_fleet=n21b, parallel_time=n21c)
    nacts.update(nacts21c)
    emit(phase="parallel_wall_seconds", seconds=time.perf_counter() - t21)
    launches["live_plot"] = timed("utils", phase_utils, smi)
    timed("graph", phase_graph, smi)
    check_shapes_covered(launches)
    emit(phase="launches_by_shape", **{
        run: {f"{kind} {list(shape)}": c
              for (kind, shape), c in n["shapes"].items()}
        for run, n in launches.items()})
    rows = timed("kernel_timing", kernel_timing, nacts)
    emit(phase="wall_seconds", **walls,
         since_build=time.perf_counter() - t0)
    launches["all"] = {k: sum(n[k] for n in launches.values())
                       for k in ("k1", "k2", "k3")}
    k2["max_abs_err"] = max(k2["max_abs_err"], k2_frame["max_abs_err"],
                            fk["k2"], fmk["k2"])
    k1["max_abs_err"] = max(k1["max_abs_err"], fk["k1"], fmk["k1"], err21)

    print(json.dumps({"kernels": kernels_line(
        launches, {"k1": k1, "k2": k2, "k3": k3}, rows)}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--time-kernels":
        time_kernels_main(os.path.abspath(sys.argv[2]), {
            "k1": [int(v) for v in sys.argv[3].split(",")],
            "k2": [int(v) for v in sys.argv[4].split(",")]})
    elif sys.argv[1:] == ["--trace-sweep"]:
        trace_sweep_main()
    else:
        main()
