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
   launch counts: K1 exactly 30 in run 4 and K2 exactly 3 in run 5;
6. the small world of tests/test_torch_slice.py on the card against its
   golden: census exact, poses and map within 1e-3;
7. warm timings of the main path, and the kernel launches
   (torch.profiler) and host syncs (PyTorch's sync debug mode) of the
   init and of one refine sweep;
8. the sequential engine: ``run(world, ICMConfig(sweep_mode="sequential",
   N=2), "cuda")`` against the JAX golden
   tests/golden/torch_engines_synth_T1833.npz: census exact, ATE within
   10%; K2 launched exactly (T-1) + N*T times (once per frame through
   ``landmark_map.update``), K1 never; its init and sweep times; launches
   and host syncs of one sequential sweep over the world's first 64
   frames;
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
   ``api.run_online`` over ``stream_dataset`` with the sequential init
   against the offline causal init from the same first pose (census
   equal, x_init atol 1e-3); ``python -m icm_slam_tpu_torch run`` and
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
   old, each turn a process of its own.

``--time-kernels ROOT K1NACTS K2NACTS`` prints phase 12's table for the
package under ROOT (what each of those turns runs).

Every run of a main path (phases 4, 5, 8, 9, 11) counts the kernel
launches with the counters set to 0 just before it and read just after;
the kernels' JSON line sums them.  A ``wall_seconds`` line gives each
phase's seconds.  Then the card's ``nvidia-smi`` line
and, last, ``{"ok": true, "device": {...}}``.  Without CUDA the script
fails.
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
# scratch files of phase 11, inside the checkout (build/ is not committed)
WORK = os.path.join(HERE, "build", "chip_smoke")


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


def kernel_bound_us(kind, T, B, K, nact):
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
    ops_us = flops / PEAK_F32_FLOPS * 1e6
    bytes_us = byts / PEAK_BYTES_PER_S * 1e6
    return max(ops_us, bytes_us), ("operations" if ops_us >= bytes_us
                                   else "bytes")


# the shapes the paths give the kernels, each with the seed of its inputs:
# K1 on the capped sweep; K2 on the uncapped sweep, on the non-quirk sweep
# (the first 128 rows of a table of 2048) and once per frame in
# landmark_map.update (all beams at L=1024, compacted beams at L=2048)
KERNEL_SHAPES = (("k1", (1833, 48, 128), 1), ("k2", (1833, 48, 1024), 2),
                 ("k2", (1833, 48, 128), 7), ("k2", (1, 181, 1024), 3),
                 ("k2", (1, 48, 2048), 8))
# K2 shapes whose table is a view of the first rows of one this wide, as
# the non-quirk sweep passes it
TABLE_WIDTH = {(1833, 48, 128): 2048}
KERNEL_NAME_PART = {"k1": "assoc_sums", "k2": "nearest_landmark"}


def shape_inputs(kind, shape):
    """The inputs of one row of KERNEL_SHAPES (any other shape: seed 9);
    a K2 table in TABLE_WIDTH is the first rows of a wider one."""
    seed = {s[:2]: s[2] for s in KERNEL_SHAPES}.get((kind, shape), 9)
    T, B, K = shape
    wide = TABLE_WIDTH.get(shape, K) if kind == "k2" else K
    pts, mp, mask = kernel_inputs(T, B, wide, seed=seed, pick_from=K)
    return pts, mp[:K], mask


def kernel_call(kind, shape, nact, plain=False):
    """A closure that calls the kernel's wrapper (``plain``: its plain
    version) at ``shape`` with ``nact`` live columns, on inputs that stay
    where they are (warm in L2, as the callers find them)."""
    import torch
    from icm_slam_tpu_torch.ops import assoc as k2
    from icm_slam_tpu_torch.ops import assoc_sums as k1
    pts, mp, mask = shape_inputs(kind, shape)
    n = torch.tensor(nact, dtype=torch.int32, device="cuda")
    if kind == "k1":
        if plain:
            return lambda: k1.associate_and_sums_plain(pts, mp, mask, n, 1.0)
        return lambda: k1.associate_and_sums(pts, mp, mask, n, 1.0)
    if plain:
        return lambda: k2.nearest_landmark_plain(pts, mp, n)
    return lambda: k2.nearest_landmark(pts, mp, n)


def kernel_variant(kind, shape):
    """The launch variant the wrapper takes at this shape, as a string."""
    from icm_slam_tpu_torch.ops import assoc as k2
    from icm_slam_tpu_torch.ops import assoc_sums as k1
    mod = k2 if kind == "k2" else k1
    if not hasattr(mod, "launch_plan"):
        return "one launch shape"
    plan = mod.launch_plan(shape[0] * shape[1], shape[2]) if kind == "k2" \
        else mod.launch_plan(*shape)
    return " ".join(f"{k}={v}" for k, v in plan._asdict().items())


def kernel_row(kind, shape, nact, profiled=True):
    """One row of the kernel table, every time measured here."""
    fn = kernel_call(kind, shape, nact)
    small = shape[0] == 1
    own = graph_us(fn, reps=400 if small else 100)
    issue = cuda_ms(fn, reps=400 if small else 100) * 1e3
    bound, by = kernel_bound_us(kind, *shape, nact)
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


def kernel_table(nacts_as_run, profiled=True):
    """Rows for every shape at nact = the table's width and at each live
    count the runs left (``nacts_as_run``: kind -> counts)."""
    rows = []
    for kind, shape, _ in KERNEL_SHAPES:
        for nact in [shape[2]] + sorted(set(nacts_as_run[kind]),
                                        reverse=True):
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
                          rows=kernel_table(nacts))), flush=True)


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
        T, B, L = shape
        pts, mp, _ = shape_inputs(kind, shape)
        counts = [L] + sorted({n for n in nacts if n < L}, reverse=True)
        row = dict(shape=list(shape), nact=counts,
                   picked=k2.launch_plan(T * B, L).lanes, own_us={})
        for lanes, threads in ((32, 256), (1, 128)):
            plan = k2.plan_for(T * B, L, lanes=lanes, threads=threads)
            times = []
            for n in counts:
                nact = count_tensor(n)
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


def count_tensor(n):
    import torch
    return torch.tensor(n, dtype=torch.int32, device="cuda")


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
    odd = []
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


def hold_k2(pts, mp, n, plan, what):
    """K2 with ``plan`` (None: the wrapper's own choice) against its plain
    version: labels exact, distances within 1e-5.  Returns the error."""
    import torch
    from icm_slam_tpu_torch.ops import assoc as k2
    nact = count_tensor(n)
    if plan is None:
        lab, dist = k2.nearest_landmark(pts, mp, nact)
    else:
        lab, dist = k2.launch(pts, mp, nact, plan)
    lab_p, dist_p = k2.nearest_landmark_plain(pts, mp, nact)
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
    (the grouped kernel scans a chunk under 128 column by column), on the
    tie tables: labels and distances equal to the plain version's."""
    import torch
    from icm_slam_tpu_torch.ops import assoc as k2
    for tie_pts, tie_map in tie_inputs():
        L, n_pts = tie_map.shape[0], tie_pts.shape[1]
        for columns in (None, 128, 64, 32):
            for plan in [None] + k2_variants(n_pts, L, columns):
                for n in (1, 39, 40, 41, 80, 120, 173, L):
                    nact = count_tensor(n)
                    lab, dist = (k2.nearest_landmark(tie_pts, tie_map, nact)
                                 if plan is None else
                                 k2.launch(tie_pts, tie_map, nact, plan))
                    lab_p, dist_p = k2.nearest_landmark_plain(
                        tie_pts, tie_map, nact)
                    check(torch.equal(lab, lab_p)
                          and torch.equal(dist, dist_p),
                          f"K2 breaks a d^2 tie otherwise than its plain "
                          f"version: {what} plan={plan} nact={n}")


def hold_k2_shape(shape, nacts):
    """K2 at one of KERNEL_SHAPES, through the wrapper and with every
    variant whichever the wrapper picks; returns the largest error."""
    T, B, L = shape
    pts, mp, _ = shape_inputs("k2", shape)
    err = 0.0
    for plan in [None] + k2_variants(T * B, L):
        for n in nacts:
            err = max(err, hold_k2(pts, mp, n, plan, f"{shape} {plan}"))
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
    emit(phase="init_profile", **launches_and_syncs(
        lambda: init_sweep_batched(data, seed, x0, cfg, w)),
        note="init_sweep_batched (58 chunks of 32 frames, R=2)", card=smi)

    cur = filter_map(state, cfg.cota, cfg.dist_thr, live_cap=cfg.map_run_cap)
    data = icm.hoist_compaction(data, cfg)
    first_nact = int(cur.nact)
    cur, x, wit = icm._refine_step(data, cur, x, cfg, w)
    emit(phase="refine_sweep_profile", **launches_and_syncs(
        lambda: icm._refine_step(data, cur, x, cfg, w)),
        note="one refine sweep + map filter, after one warm sweep",
        live_columns=dict(raw_after_init=raw_init,
                          first_sweep_sees=first_nact,
                          raw_after_first_sweep=int(wit[0]),
                          second_sweep_sees=int(cur.nact)),
        card=smi)
    # the live counts K1 meets in the first sweeps, before the map settles,
    # and the raw count an init leaves, which the per-frame K2 of a causal
    # init grows towards
    return {"k1": [first_nact, int(cur.nact)], "k2": [raw_init]}


def counted(fn):
    """``fn()`` with both kernels' launch counters set to 0 just before it;
    returns (result, {"k1": n, "k2": n, "shapes": {(kernel, shape): n}})
    read just after."""
    from icm_slam_tpu_torch.ops import assoc as k2
    from icm_slam_tpu_torch.ops import assoc_sums as k1
    for mod in (k1, k2):
        mod.LAUNCHES = 0
        mod.LAUNCH_SHAPES.clear()
    out = fn()
    shapes = {(kind, shape): n for kind, mod in (("k1", k1), ("k2", k2))
              for shape, n in mod.LAUNCH_SHAPES.items()}
    return out, {"k1": k1.LAUNCHES, "k2": k2.LAUNCHES, "shapes": shapes}


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
    import torch
    from icm_slam_tpu_torch.mapping.landmark_map import MapState
    n = res.map_pos.shape[0]
    pos = torch.zeros((L, 2), device="cuda")
    counts = torch.zeros((L,), device="cuda")
    pos[:n] = torch.from_numpy(res.map_pos).cuda()
    counts[:n] = torch.from_numpy(res.map_counts).cuda()
    return MapState(pos, counts,
                    torch.tensor(n, dtype=torch.int32, device="cuda"))


def phase_sequential(ge, smi):
    """The reference-faithful sequential engine at full width."""
    import torch
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.core.energy import weights
    from icm_slam_tpu_torch.solver import icm

    ds, x_true = big_world(ge, "seq")
    T, cfg = ds.T, ICMConfig(sweep_mode="sequential", N=2)
    res, n = counted(lambda: icm.run(ds, cfg, "cuda"))
    want = (T - 1) + cfg.N * T
    check(n["k2"] == want and n["k1"] == 0,
          f"sequential run launched K2 {n['k2']}x, K1 {n['k1']}x; want "
          f"{want} and 0")
    agree = hold_to_golden(res, x_true, golden_case(ge, "seq"),
                           "sequential")
    t = res.timings
    emit(phase="sequential_engine", world="synthetic_world(T=1833, seed=0)",
         config="ICMConfig(sweep_mode='sequential', N=2) L=1024",
         k2_launches=n["k2"], k1_launches=n["k1"], **agree,
         prepare_s=t["prepare_s"], init_s=t["init_s"],
         refine_per_iter_s=t["refine_per_iter_s"],
         init_frames_per_s=(T - 1) / t["init_s"],
         refine_frames_per_s=T / t["refine_per_iter_s"], card=smi)

    # one sequential sweep (+ map filter) over the first 64 frames, from
    # the run's map and poses: launches per frame, host syncs per sweep
    F = 64
    data = icm.prepare(ds.slice(F), cfg, "cuda")
    rcfg = icm.resolve_config(cfg, data)
    w = weights(rcfg, "cuda")
    cur = map_state(res, rcfg.L)
    x = torch.from_numpy(res.x[:F]).cuda()
    icm._refine_step(data, cur, x, rcfg, w)
    prof = launches_and_syncs(lambda: icm._refine_step(data, cur, x, rcfg, w))
    emit(phase="sequential_sweep_profile", frames=F,
         kernel_launches_per_frame=prof["kernel_launches"] / F, **prof,
         note="one sequential sweep + map filter over frames 0-63 of the "
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
    """K2 at the shapes every update() gives it, and on d^2 ties."""
    from icm_slam_tpu_torch.ops import assoc as k2
    pts, mp, _ = shape_inputs("k2", (1, B, L))
    err = 0.0
    for shape in ((1, B, L), (1, 48, 2048)):
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
         other_shapes=[[1, 48, 2048]],
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
    out, totals = {}, {"k1": 0, "k2": 0, "shapes": {}}

    def tally(n):
        for k in ("k1", "k2"):
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
    # same first pose (the stream starts at the first odometry reading)
    seq0 = ICMConfig(init_mode="sequential", N=0)
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
               online_vs_phase8_x_init_max_abs_diff=float(
                   np.abs(onl.x_init - seq_res.x_init).max()))

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
                             "the sequential run, N=2 (phase 8)"),
    ("k2", (1, 48, 2048)): ("nonquirk",
                            "the non-quirk Jacobi run's causal init "
                            "(phase 9)")}


def check_shapes_covered(launches):
    """Every shape a counted run gave a kernel must have its rows in the
    kernel table (and with them its check against the plain version)."""
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
                        and r["nact"] == shape[2])
        shapes = []
        for r in rows:
            if r["kernel"] != kind:
                continue
            run, by = LAUNCHED_BY[(kind, tuple(r["shape"]))]
            shapes.append(dict(
                r, launched_by=by, library_ms=None,
                launches=launches[run]["shapes"][(kind, tuple(r["shape"]))]))
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
              (1833, 48, 1024))]


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
        return out

    def kernel_timing(nacts):
        emit(phase="launch_floor", **launch_floor(),
             note="K2 on one point, a table of one column, nact=0", card=smi)
        rows = kernel_table(nacts)
        emit(phase="kernel_table", rows=rows, nact_as_run=nacts, card=smi)
        emit(phase="k2_variants_timed", rows=k2_variants_timed(nacts["k2"]),
             card=smi)
        phase_old_vs_new(nacts, smi)
        return rows

    k1 = timed("k1", phase_k1)
    k2 = timed("k2", phase_k2)
    g = np.load(GOLDEN)
    launches, nacts = timed("main_uncapped", phase_main, g, smi)
    timed("small", phase_small, g)
    for kind, counts in timed("profile", phase_profile, smi).items():
        nacts[kind] += counts
    ge = np.load(GOLDEN_ENGINES)
    n8, seq_res = timed("sequential", phase_sequential, ge, smi)
    nacts["k2"].append(seq_res.map_pos.shape[0])
    n9, nq_res = timed("nonquirk_jacobi", phase_nonquirk_jacobi, ge, smi)
    nacts["k2"].append(nq_res.map_pos.shape[0])
    k2_frame = timed("k2_per_frame", phase_k2_per_frame)
    n11 = timed("entry_points", phase_entry_points, seq_res, smi)
    launches.update(sequential=n8, nonquirk=n9, entry_points=n11)
    check_shapes_covered(launches)
    emit(phase="launches_by_shape", **{
        run: {f"{kind} {list(shape)}": c
              for (kind, shape), c in n["shapes"].items()}
        for run, n in launches.items()})
    rows = timed("kernel_timing", kernel_timing, nacts)
    emit(phase="wall_seconds", **walls,
         since_build=time.perf_counter() - t0)
    launches["all"] = {k: launches["main"][k] + launches["uncapped"][k]
                       + n8[k] + n9[k] + n11[k] for k in ("k1", "k2")}
    k2["max_abs_err"] = max(k2["max_abs_err"], k2_frame["max_abs_err"])

    print(json.dumps({"kernels": kernels_line(
        launches, {"k1": k1, "k2": k2}, rows)}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--time-kernels":
        time_kernels_main(os.path.abspath(sys.argv[2]), {
            "k1": [int(v) for v in sys.argv[3].split(",")],
            "k2": [int(v) for v in sys.argv[4].split(",")]})
    else:
        main()
