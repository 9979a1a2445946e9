"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here carries the ``cuda`` marker and skips where no GPU is
present: a CUDA kernel has no CPU mode.  This file imports neither JAX nor
the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py

Tolerances: labels exact; K1 d2min bitwise (--fmad=false), sums atol 1e-4
(f32 sums in another order) and bitwise between two runs (no atomics); K2
distances atol 1e-5, and labels and distances exact on constructed d^2
ties for every launch variant, resident and chunked; a misaligned view
refused; the per-frame map
update through K2 against the same call on CPU tensors, labels and counts
exact, positions atol 1e-5; small end-to-end runs on the GPU against the
same runs on the CPU, census exact and poses atol 1e-3.  The world axis
of both kernels (a fleet of W worlds in one launch): each world's slice
against the plain version as above and bitwise against the launch on that
world alone, with another live count in every world and each world's
table a column slice of a wider one; a fleet run on the GPU against the
same fleet on the CPU, census exact and poses atol 1e-3; on the GPU,
``add_rows`` and whole runs repeat bitwise, and a fleet's world is bitwise
its ``run()`` with the merged config.  ``utils.profiling`` on the card:
``PhaseTimer`` with ``block_on`` reads at least 0.9 of the launches'
CUDA-event time, and ``device_trace``'s kernel events hold one K1 and one
K2 launch.  K3 (the map filter's relabel walk) against its plain walk,
bitwise; K2's sqrt key against its plain version, and its tie rule; the
refine sweeps replayed from a CUDA graph bitwise the same sweeps one by
one, with each kernel counted once a sweep; a capture that fails raises.
K4 (the fused pose LM) against its plain version at every (P, B, sided,
fold) a run gives it and at P = 1, B = 181 and all-masked problems:
bitwise, and bitwise from run to run; the order ``ops.pose_lm.reduce_plan``
gives K4's sums bitwise torch's own CUDA sums over dim 1; the
batched init's chunks replayed from a CUDA graph bitwise the eager chunks
(one world, W = 4, and on a card that is not the current one), and an
init capture that fails raises.
"""
import collections

import numpy as np
import pytest
import torch

from icm_slam_tpu_torch.ops import _build
from icm_slam_tpu_torch.ops import assoc as k2
from icm_slam_tpu_torch.ops import assoc_sums as k1

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(T, B, K, seed, dev):
    rng = np.random.default_rng(seed)
    mp = rng.uniform(-15, 15, (K, 2)).astype(np.float32)
    pts = (mp[rng.integers(0, K, (T, B))]
           + rng.normal(0, 0.8, (T, B, 2))).astype(np.float32)
    mask = rng.uniform(size=(T, B)) < 0.7
    return (torch.from_numpy(pts).to(dev), torch.from_numpy(mp).to(dev),
            torch.from_numpy(mask).to(dev))


@pytest.mark.parametrize("nact", [0, 1, 37, 128])
def test_k1_kernel_matches_plain(dev, nact):
    pts, mp, mask = _inputs(257, 48, 128, 3, dev)
    n = torch.tensor(nact, dtype=torch.int32, device=dev)
    before = _build.launches("assoc_sums")
    lab, d2, sums = k1.associate_and_sums(pts, mp, mask, n, 1.0)
    assert _build.launches("assoc_sums") == before + 1
    lab_p, d2_p, sums_p = k1.associate_and_sums_plain(pts, mp, mask, n, 1.0)
    assert torch.equal(lab, lab_p)
    assert torch.equal(d2, d2_p)
    assert float((sums - sums_p).abs().max()) <= 1e-4


@pytest.mark.parametrize("nact", [0, 1, 37, 1024])
def test_k2_kernel_matches_plain(dev, nact):
    pts, mp, _ = _inputs(33, 48, 1024, 4, dev)
    n = torch.tensor(nact, dtype=torch.int32, device=dev)
    before = _build.launches("nearest_landmark")
    lab, dist = k2.nearest_landmark(pts, mp, n)
    assert _build.launches("nearest_landmark") == before + 1
    lab_p, dist_p = k2.nearest_landmark_plain(pts, mp, n)
    assert torch.equal(lab, lab_p)
    fin = torch.isfinite(dist_p)
    assert torch.equal(fin, torch.isfinite(dist))
    if bool(fin.any()):
        assert float((dist - dist_p)[fin].abs().max()) <= 1e-5


def test_k2_near_tie_matches_plain(dev):
    """Exact and one-ulp d^2 ties: the first minimum wins in both."""
    rng = np.random.default_rng(6)
    base = rng.uniform(0.5, 0.9, (40, 2)).astype(np.float32)
    a = rng.uniform(0, 2 * np.pi, 40)
    r = np.hypot(base[:, 0], base[:, 1]).astype(np.float32)
    ring = np.stack([r * np.cos(a), r * np.sin(a)], 1).astype(np.float32)
    mirror = -base                                   # exactly equal d^2
    mp = np.concatenate([ring, base, mirror, base]).astype(np.float32)
    pts = torch.zeros((1, 3, 2), device=dev)
    pts[0, 1] = 1e-7
    pts[0, 2, 0] = -1e-7
    mp = torch.from_numpy(mp).to(dev)
    for n in (1, 40, 80, 120, 160):
        nact = torch.tensor(n, dtype=torch.int32, device=dev)
        lab, dist = k2.nearest_landmark(pts, mp, nact)
        lab_p, dist_p = k2.nearest_landmark_plain(pts, mp, nact)
        assert torch.equal(lab, lab_p)
        assert torch.equal(dist, dist_p)


# every variant of K2: (lanes per point, threads per block)
VARIANTS = [(32, 128), (32, 256), (1, 64), (1, 128), (1, 256)]


def _hold_k2(pts, mp, nact, plan, dev, exact=False):
    n = torch.tensor(nact, dtype=torch.int32, device=dev)
    lab, dist = k2.launch(pts, mp, n, plan)
    lab_p, dist_p = k2.nearest_landmark_plain(pts, mp, n)
    assert torch.equal(lab, lab_p)
    fin = torch.isfinite(dist_p)
    assert torch.equal(fin, torch.isfinite(dist))
    if exact:
        assert torch.equal(dist, dist_p)
    elif bool(fin.any()):
        assert float((dist - dist_p)[fin].abs().max()) <= 1e-5


@pytest.mark.parametrize("lanes,threads", VARIANTS)
@pytest.mark.parametrize("shape", [(1, 181, 1024), (1, 181, 2048),
                                   (1833, 48, 128), (128, 48, 1024),
                                   (257, 48, 1000), (3, 7, 130)])
def test_k2_variant_matches_plain(dev, lanes, threads, shape):
    """Each variant at the shapes the callers give the wrapper (one frame
    against tables of 1024 and 2048 columns, a whole run against the first
    128) and at others: point counts that fill no whole tile, live counts
    that are no multiple of the lane count or of a group of 32 columns."""
    T, B, L = shape
    pts, mp, _ = _inputs(T, B, L, 8, dev)
    plan = k2.plan_for(T * B, L, lanes=lanes, threads=threads)
    before = _build.launches("nearest_landmark")
    for nact in (0, 1, lanes - 1, lanes + 1, 37, 100, 127, L - 1, L):
        _hold_k2(pts, mp, nact, plan, dev)
    assert _build.launches("nearest_landmark") == before + 9


@pytest.mark.parametrize("shape,lanes", [((1, 181, 1024), 32),
                                         ((1, 181, 2048), 32),
                                         ((128, 48, 1024), 1),
                                         ((1833, 48, 128), 1),
                                         ((1833, 48, 1024), 1)])
def test_k2_wrapper_takes_the_planned_variant(dev, shape, lanes):
    T, B, L = shape
    assert k2.launch_plan(T * B, L).lanes == lanes
    pts, mp, _ = _inputs(T, B, L, 9, dev)
    for nact in (0, 5, 127, L):
        n = torch.tensor(nact, dtype=torch.int32, device=dev)
        lab, dist = k2.nearest_landmark(pts, mp, n)
        lab_p, dist_p = k2.nearest_landmark_plain(pts, mp, n)
        assert torch.equal(lab, lab_p)
        fin = torch.isfinite(dist_p)
        assert torch.equal(fin, torch.isfinite(dist))
        if bool(fin.any()):
            assert float((dist - dist_p)[fin].abs().max()) <= 1e-5


@pytest.mark.parametrize("lanes,threads", VARIANTS)
def test_k2_table_wider_than_a_chunk(dev, lanes, threads):
    """A table wider than the resident limit, and narrow chunks forced on
    a small one: the minimum carries over from chunk to chunk."""
    W = k2.RESIDENT_COLUMNS + 904
    pts, mp, _ = _inputs(4, 181, W, 10, dev)
    plan = k2.plan_for(4 * 181, W, lanes=lanes, threads=threads)
    assert plan.shmem == 8 * k2.RESIDENT_COLUMNS
    for nact in (k2.RESIDENT_COLUMNS, k2.RESIDENT_COLUMNS + 1, W - 3, W):
        _hold_k2(pts, mp, nact, plan, dev)
    small = k2.plan_for(4 * 181, W, lanes=lanes, threads=threads, columns=96)
    for nact in (95, 96, 97, 1000):
        _hold_k2(pts, mp, nact, small, dev)


@pytest.mark.parametrize("lanes,threads", VARIANTS)
@pytest.mark.parametrize("columns", [None, 128, 64, 32])
def test_k2_ties_across_lanes_and_chunks(dev, lanes, threads,
                                         columns):
    """64 columns four times each (neighbours, shuffled, in order): every
    point meets an exact four-way tie that spans lanes and, with narrow
    chunks, chunks (128 columns a chunk keeps the grouped kernel on its
    groups, fewer put it on its column-by-column scan); the first copy
    must win, as in the plain version."""
    rng = np.random.default_rng(5)
    cols = rng.uniform(-15, 15, (64, 2)).astype(np.float32)
    order = np.concatenate([np.repeat(np.arange(64), 2),
                            rng.permutation(64), np.arange(64)])
    pts = (cols[rng.integers(0, 64, (1, 181))]
           + rng.normal(0, 0.8, (1, 181, 2))).astype(np.float32)
    pts, mp = torch.from_numpy(pts).to(dev), torch.from_numpy(
        cols[order]).to(dev)
    kw = {} if columns is None else dict(columns=columns)
    plan = k2.plan_for(181, 256, lanes=lanes, threads=threads,
                       **kw)
    for nact in (2, 31, 33, 127, 129, 200, 256):
        _hold_k2(pts, mp, nact, plan, dev, exact=True)


def test_k2_refuses_a_plan_that_does_not_cover_the_points(dev):
    pts, mp, _ = _inputs(4, 181, 256, 11, dev)
    n = torch.tensor(9, dtype=torch.int32, device=dev)
    plan = k2.plan_for(4 * 181, 256, lanes=32)
    for bad in (plan._replace(blocks=plan.blocks - 1),
                plan._replace(lanes=8), plan._replace(shmem=100),
                plan._replace(threads=48)):
        with pytest.raises(RuntimeError, match="cudaError_t 1"):
            k2.launch(pts, mp, n, bad)


@pytest.mark.parametrize("shape", [(257, 48, 128), (65, 181, 128),
                                   (33, 48, 130), (9, 5, 8)])
def test_k1_sums_repeat_bitwise_and_match_plain(dev, shape):
    """Beams beyond one round of either pass, a width that is no multiple
    of 4, duplicated columns; the sums of two runs are the same bits."""
    T, B, K = shape
    pts, mp, mask = _inputs(T, B, K, 12, dev)
    mp[K // 2] = mp[1]
    mp[K - 1] = mp[1]
    for nact in (0, 3, K - 1, K):
        n = torch.tensor(nact, dtype=torch.int32, device=dev)
        lab, d2, sums = k1.associate_and_sums(pts, mp, mask, n, 2.0)
        again = k1.associate_and_sums(pts, mp, mask, n, 2.0)
        lab_p, d2_p, sums_p = k1.associate_and_sums_plain(pts, mp, mask, n,
                                                          2.0)
        assert torch.equal(lab, lab_p) and torch.equal(d2, d2_p)
        assert all(torch.equal(a, b) for a, b in zip((lab, d2, sums), again))
        assert float((sums - sums_p).abs().max()) <= 1e-4
        assert float(sums[:, 2].sum()) == float(sums_p[:, 2].sum())


@pytest.mark.parametrize("quirk", [True, False])
def test_update_through_k2_matches_cpu(dev, quirk):
    from icm_slam_tpu_torch.mapping import landmark_map as lm
    rng = np.random.default_rng(7)
    L, B = 1024, 181
    ref = rng.uniform(-15, 15, (L, 2)).astype(np.float32)
    pick = rng.integers(0, 700, B)
    pts = (ref[pick] + rng.normal(0, 0.9, (B, 2))).astype(np.float32)
    pts[:20] += 6.0                                  # far beams
    mask = rng.uniform(size=B) < 0.8
    pos = rng.uniform(-15, 15, (L, 2)).astype(np.float32)
    cnt = np.where(np.arange(L) < 720, rng.integers(1, 30, L), 0)

    def call(d):
        t = lambda a: torch.from_numpy(np.asarray(a)).to(d)
        state = lm.MapState(t(pos), t(cnt.astype(np.float32)),
                            torch.tensor(720, dtype=torch.int32, device=d))
        return lm.update(state, t(ref),
                         torch.tensor(700, dtype=torch.int32, device=d),
                         t(pts), t(mask), 1.0, quirk)

    before = _build.launches("nearest_landmark")
    st_g, lab_g = call(dev)
    assert _build.launches("nearest_landmark") == before + 1
    st_c, lab_c = call("cpu")
    assert torch.equal(lab_g.cpu(), lab_c)
    assert int(st_g.nact) == int(st_c.nact) > 720
    assert torch.equal(st_g.counts.cpu(), st_c.counts)
    assert float((st_g.pos.cpu() - st_c.pos).abs().max()) <= 1e-5


def test_a_view_of_the_table_is_taken_where_it_lies(dev):
    """The first rows of a wider table, as the non-quirk sweep passes them,
    and rows from an even offset: both are contiguous and 8-byte aligned."""
    pts, mp, mask = _inputs(65, 48, 2048, 13, dev)
    n = torch.tensor(100, dtype=torch.int32, device=dev)
    for view in (mp[:128], mp[3:131]):
        lab, dist = k2.nearest_landmark(pts, view, n)
        lab_p, dist_p = k2.nearest_landmark_plain(pts, view, n)
        assert torch.equal(lab, lab_p)
        assert float((dist - dist_p).abs().max()) <= 1e-5
        out = k1.associate_and_sums(pts, view, mask, n, 1.0)
        ref = k1.associate_and_sums_plain(pts, view, mask, n, 1.0)
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
        assert float((out[2] - ref[2]).abs().max()) <= 1e-4


def test_wrappers_reject_a_misaligned_view(dev):
    flat = torch.zeros(2 * 128 + 1, device=dev)
    odd = flat[1:].view(128, 2)              # contiguous, 4 bytes off
    assert odd.is_contiguous() and odd.data_ptr() % 8 == 4
    pts, mp, mask = _inputs(8, 16, 128, 5, dev)
    n = torch.tensor(3, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="8-byte"):
        k2.nearest_landmark(pts, odd, n)
    with pytest.raises(ValueError, match="8-byte"):
        k1.associate_and_sums(pts, odd, mask, n, 1.0)


def test_wrappers_reject_cpu_map_with_cuda_points(dev):
    pts, mp, mask = _inputs(8, 16, 128, 5, dev)
    n = torch.tensor(3, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        k1.associate_and_sums(pts, mp.cpu(), mask, n, 1.0)
    with pytest.raises(ValueError):
        k2.nearest_landmark(pts, mp.cpu(), n)


def test_small_run_gpu_matches_cpu(dev):
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.data.datasets import synthetic_world
    from icm_slam_tpu_torch.solver.icm import run
    ds = synthetic_world(T=240, n_landmarks=12, seed=7)
    cfg = ICMConfig(L=256, cota=20.0, N=3)
    before = _build.launches("assoc_sums")
    gpu = run(ds, cfg, dev)
    assert _build.launches("assoc_sums") == before + 3
    cpu = run(ds, cfg, "cpu")
    assert gpu.map_pos.shape == cpu.map_pos.shape
    for f in ("x_init", "x", "map_pos"):
        np.testing.assert_allclose(getattr(gpu, f), getattr(cpu, f),
                                   atol=1e-3)


@pytest.mark.parametrize("kw", [
    dict(sweep_mode="sequential", N=1),
    dict(replicate_new_obs_quirk=False, pose_update="jacobi", N=2)])
def test_small_engine_runs_gpu_match_cpu(dev, kw):
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.data.datasets import synthetic_world
    from icm_slam_tpu_torch.solver.icm import run
    ds = synthetic_world(T=120, n_landmarks=10, seed=7)
    cfg = ICMConfig(L=256, cota=20.0, **kw)
    before = _build.launches("nearest_landmark")
    gpu = run(ds, cfg, dev)
    per_sweep = ds.T if kw.get("sweep_mode") == "sequential" else 1
    assert _build.launches("nearest_landmark") - before == \
        ds.T - 1 + cfg.N * per_sweep
    cpu = run(ds, cfg, "cpu")
    assert gpu.map_pos.shape == cpu.map_pos.shape
    for f in ("x_init", "x", "map_pos"):
        np.testing.assert_allclose(getattr(gpu, f), getattr(cpu, f),
                                   atol=1e-3)


def _world_inputs(W, T, B, K, seed, dev, width=None):
    """W worlds of ``_inputs``; each world's table is the first K columns
    of a table ``width`` wide, as a fleet's capped sweep passes them."""
    worlds = [_inputs(T, B, width or K, seed + w, dev) for w in range(W)]
    pts, mp, mask = (torch.stack(f) for f in zip(*worlds))
    return pts.contiguous(), mp[:, :K], mask.contiguous()


@pytest.mark.parametrize("shape", [(4, 65, 48, 128), (3, 33, 48, 130),
                                   (2, 9, 181, 8)])
def test_k1_world_axis_is_each_world_alone(dev, shape):
    W, T, B, K = shape
    pts, mp, mask = _world_inputs(W, T, B, K, 21, dev, width=2 * K + 2)
    assert not mp.is_contiguous()
    nact = torch.tensor([0, 1, K // 2 + 3, K][:W], dtype=torch.int32,
                        device=dev)
    before = _build.launches("assoc_sums")
    lab, d2, sums = k1.associate_and_sums(pts, mp, mask, nact, 1.5)
    assert _build.launches("assoc_sums") == before + 1
    assert _build.launch_shapes("assoc_sums").get((W, T, B, K), 0) >= 1
    again = k1.associate_and_sums(pts, mp, mask, nact, 1.5)
    assert all(torch.equal(a, b) for a, b in zip((lab, d2, sums), again))
    lab_p, d2_p, sums_p = k1.associate_and_sums_plain(pts, mp, mask, nact,
                                                      1.5)
    assert torch.equal(lab, lab_p) and torch.equal(d2, d2_p)
    assert float((sums - sums_p).abs().max()) <= 1e-4
    for w in range(W):
        one = k1.associate_and_sums(pts[w], mp[w].contiguous(), mask[w],
                                    nact[w], 1.5)
        assert all(torch.equal(a[w], b) for a, b in zip((lab, d2, sums),
                                                        one))


@pytest.mark.parametrize("lanes,threads", VARIANTS)
@pytest.mark.parametrize("shape", [(4, 33, 48, 1024), (3, 1, 181, 256)])
def test_k2_world_axis_is_each_world_alone(dev, lanes, threads, shape):
    W, T, B, L = shape
    pts, mp, _ = _world_inputs(W, T, B, L, 31, dev, width=L + 6)
    nact = torch.tensor([0, 1, 37, L][:W - 1] + [L], dtype=torch.int32,
                        device=dev)
    plan = k2.plan_for(T * B, L, lanes=lanes, threads=threads)
    before = _build.launches("nearest_landmark")
    lab, dist = k2.launch(pts, mp, nact, plan)
    assert _build.launches("nearest_landmark") == before + 1
    assert _build.launch_shapes("nearest_landmark").get((W, T, B, L), 0) >= 1
    lab_p, dist_p = k2.nearest_landmark_plain(pts, mp, nact)
    assert torch.equal(lab, lab_p)
    fin = torch.isfinite(dist_p)
    assert torch.equal(fin, torch.isfinite(dist))
    if bool(fin.any()):
        assert float((dist - dist_p)[fin].abs().max()) <= 1e-5
    for w in range(W):
        one = k2.launch(pts[w], mp[w].contiguous(), nact[w], plan)
        assert torch.equal(lab[w], one[0]) and torch.equal(dist[w], one[1])
    # the wrapper's own plan, chosen from one world's points
    lab_w, dist_w = k2.nearest_landmark(pts, mp, nact)
    assert torch.equal(lab_w, lab_p)


@pytest.mark.parametrize("map_run_cap", [256, 0])
def test_fleet_run_gpu_matches_cpu(dev, map_run_cap):
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.data.datasets import synthetic_world
    from icm_slam_tpu_torch.solver.icm import run_batched
    # the worlds of tests/test_torch_fleet.py's comparison with JAX
    worlds = [synthetic_world(T=240, n_landmarks=12, seed=s)
              for s in (7, 10, 11)]
    cfg = ICMConfig(L=256, cota=20.0, N=3, map_run_cap=map_run_cap)
    b1, b2 = _build.launches("assoc_sums"), _build.launches("nearest_landmark")
    gpu = run_batched(worlds, cfg, dev)
    # one launch a sweep for all three worlds: K1 capped, K2 uncapped
    assert (_build.launches("assoc_sums") - b1,
            _build.launches("nearest_landmark") - b2) == \
        ((3, 0) if map_run_cap else (0, 3))
    cpu = run_batched(worlds, cfg, "cpu")
    for g, c in zip(gpu, cpu):
        assert g.map_pos.shape == c.map_pos.shape
        for f in ("x_init", "x", "map_pos"):
            np.testing.assert_allclose(getattr(g, f), getattr(c, f),
                                       atol=1e-3)


def test_add_rows_repeats_bitwise(dev):
    """Rows that share an index are summed in a fixed order on the card
    (``index_add_`` would add them by float atomics)."""
    from icm_slam_tpu_torch.mapping.landmark_map import add_rows
    rng = np.random.default_rng(9)
    idx = torch.from_numpy(rng.integers(0, 33, 200000)).to(dev)
    vals = torch.from_numpy(rng.normal(0, 1e3, (200000, 3)).astype(
        np.float32)).to(dev)
    first = add_rows(torch.zeros((33, 3), device=dev), idx, vals)
    for _ in range(3):
        assert torch.equal(add_rows(torch.zeros((33, 3), device=dev), idx,
                                    vals), first)
    # f32 sums of ~6,000 rows each, against f64: within 1e-5 of the mass
    ref = torch.zeros((33, 3), dtype=torch.float64).index_add_(
        0, idx.cpu(), vals.cpu().double())
    mass = torch.zeros((33, 3), dtype=torch.float64).index_add_(
        0, idx.cpu(), vals.cpu().double().abs())
    assert bool(((first.cpu().double() - ref).abs() <= 1e-5 * mass).all())


def test_runs_repeat_and_a_fleet_world_is_its_run_bitwise(dev):
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.data.datasets import synthetic_world
    from icm_slam_tpu_torch.solver import icm
    worlds = [synthetic_world(T=240, n_landmarks=12, seed=s)
              for s in (7, 8, 9)]
    cfg = ICMConfig(L=256, cota=20.0, N=3)
    fleet = icm.run_batched(worlds, cfg, dev)
    merged = icm.resolve_fleet_config(
        cfg, [icm.prepare(w, cfg, dev) for w in worlds])
    for w, rb in zip(worlds, fleet):
        r1, r2 = (icm.run(w, merged, dev) for _ in range(2))
        for f in ("x_init", "x", "map_pos", "map_counts"):
            assert np.array_equal(getattr(r1, f), getattr(r2, f))
            assert np.array_equal(getattr(rb, f), getattr(r1, f))


def test_phase_timer_waits_for_the_card(dev):
    """``PhaseTimer.phase(block_on=...)`` reads the clock after the card
    has run what the block issued: at least 0.9 of the launches' CUDA-event
    time, with ``block_on`` a nesting that holds a MapState."""
    from icm_slam_tpu_torch.mapping.landmark_map import empty_map
    from icm_slam_tpu_torch.utils.profiling import PhaseTimer
    rng = np.random.default_rng(3)
    pts = torch.from_numpy(rng.uniform(-9, 9, (4, 1833, 104, 2)).astype(
        np.float32)).to(dev)
    mp = torch.from_numpy(rng.uniform(-9, 9, (4, 1024, 2)).astype(
        np.float32)).to(dev)
    nact = torch.full((4,), 1024, dtype=torch.int32, device=dev)
    k2.nearest_landmark(pts, mp, nact)
    torch.cuda.synchronize(dev)
    timer, held = PhaseTimer(), {"map": [empty_map(8, device=dev)]}
    with timer.phase("k2", block_on=held):
        for _ in range(20):
            held["out"] = k2.nearest_landmark(pts, mp, nact)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        k2.nearest_landmark(pts, mp, nact)
    end.record()
    torch.cuda.synchronize(dev)
    assert timer.totals["k2"] * 1e3 >= 0.9 * start.elapsed_time(end)
    assert timer.report()["k2"]["count"] == 1


def test_device_trace_records_the_kernels(dev, tmp_path):
    """``device_trace`` on the card writes a Chrome trace whose kernel
    events hold one K1 launch and one K2 launch.  A torch op runs first in
    the window: with K1 first, its event was missing from the trace in 2
    of 5 runs of this file on an H100 (the cause is not traced)."""
    import glob
    import json
    from icm_slam_tpu_torch.utils.profiling import device_trace
    rng = np.random.default_rng(4)
    pts = torch.from_numpy(rng.uniform(-9, 9, (64, 48, 2)).astype(
        np.float32)).to(dev)
    mp = torch.from_numpy(rng.uniform(-9, 9, (128, 2)).astype(
        np.float32)).to(dev)
    mask = torch.ones((64, 48), dtype=torch.bool, device=dev)
    n = torch.tensor(100, dtype=torch.int32, device=dev)
    with device_trace(str(tmp_path), device=dev):
        torch.ones(8, device=dev).add_(1.0)
        torch.cuda.synchronize(dev)
        k1.associate_and_sums(pts, mp, mask, n, 1.0)
        k2.nearest_landmark(pts, mp, n)
        torch.cuda.synchronize(dev)
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    assert sum("assoc_sums" in s for s in names) == 1, names
    assert sum("nearest_landmark" in s for s in names) == 1, names


def _walk_inputs(W, K, ns, seed, chained, dev):
    rng = np.random.default_rng(seed)
    if chained:
        nn = np.minimum(np.arange(K) + 1, K - 1)[None].repeat(W, 0)
        close = np.ones((W, K), bool)
    else:
        nn = rng.integers(0, K, (W, K))
        close = rng.uniform(size=(W, K)) < 0.3
    return (torch.from_numpy(nn.astype(np.int32)).to(dev),
            torch.from_numpy(close).to(dev),
            torch.tensor(ns, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("chained", [False, True])
@pytest.mark.parametrize("W,K,ns", [(1, 8, [8]), (3, 128, [0, 37, 128]),
                                    (1, 1024, [1]), (2, 2048, [2048, 999]),
                                    (1, 100, [100])])
def test_k3_matches_plain(dev, W, K, ns, chained):
    """K3 against the plain walk, bitwise, one launch for all worlds; a
    chained walk relabels at every step (two barriers each)."""
    from icm_slam_tpu_torch.ops import relabel as k3
    ins = _walk_inputs(W, K, ns, K + W, chained, dev)
    before = _build.launches("relabel_walk")
    lab = k3.relabel_walk(*ins)
    assert _build.launches("relabel_walk") == before + 1
    assert torch.equal(lab, k3.relabel_walk_plain(*ins))


def test_k2_sqrt_key_matches_plain(dev):
    """The sqrt key against its plain version on a sqrt tie of unequal
    d^2 (column 0 wins, where the d^2 key takes column 1) and on a frame
    of random points; the grouped kernel refuses the sqrt key."""
    rng = np.random.default_rng(0)
    while True:
        b = rng.uniform(0.5, 0.9, 2).astype(np.float32)
        r, a = np.float32(np.hypot(*b)), rng.uniform(0, 2 * np.pi)
        ref = np.stack([np.array([r * np.cos(a), r * np.sin(a)],
                                 np.float32), b])
        d2 = torch.from_numpy(ref).pow(2).sum(-1)
        if d2[0] > d2[1] and torch.sqrt(d2[0]) == torch.sqrt(d2[1]):
            break
    pts = torch.zeros((1, 1, 2), device=dev)
    mp = torch.from_numpy(ref).to(dev)
    n = torch.tensor(2, dtype=torch.int32, device=dev)
    assert int(k2.nearest_landmark(pts, mp, n, sqrt_key=True)[0][0, 0]) == 0
    assert int(k2.nearest_landmark(pts, mp, n)[0][0, 0]) == 1
    pts, mp, _ = _inputs(1, 181, 1024, 5, dev)
    for nact in (0, 1, 37, 1024):
        n = torch.tensor(nact, dtype=torch.int32, device=dev)
        lab, dist = k2.nearest_landmark(pts, mp, n, sqrt_key=True)
        lab_p, dist_p = k2.nearest_landmark_plain(pts, mp, n, sqrt_key=True)
        assert torch.equal(lab, lab_p) and torch.equal(dist, dist_p)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        k2.launch(pts, mp, n, k2.plan_for(181, 1024, lanes=1), sqrt_key=True)


def _hold_graph_to_eager(dev):
    """``refine_sweeps`` on ``dev`` (one eager sweep, a capture, replays)
    against the same sweeps one by one: map, poses, witnesses and changes
    bitwise; N - 1 replays, and each kernel counted once a sweep."""
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.core.energy import weights
    from icm_slam_tpu_torch.data.datasets import synthetic_world
    from icm_slam_tpu_torch.solver import cuda_graph, icm
    ds = synthetic_world(T=240, n_landmarks=12, seed=7)
    cfg = ICMConfig(L=256, cota=20.0, N=4)
    start = icm.run(ds, cfg, dev, n_iters=0)
    data = icm.prepare(ds, cfg, dev)
    cfg = icm.resolve_config(cfg, data)
    data = icm.hoist_compaction(data, cfg)
    w = weights(cfg, dev)
    pos = torch.zeros((cfg.L, 2), device=dev)
    counts = torch.zeros((cfg.L,), device=dev)
    k = start.map_pos.shape[0]
    pos[:k] = torch.from_numpy(start.map_pos).to(dev)
    counts[:k] = torch.from_numpy(start.map_counts).to(dev)
    cur0 = icm.MapState(pos, counts,
                        torch.tensor(k, dtype=torch.int32, device=dev))
    x0 = torch.from_numpy(start.x_init).to(dev)
    cur, x, eager = cur0, x0, []
    for _ in range(cfg.N):
        new, x, wit = icm._refine_step(data, cur, x, cfg, w)
        eager.append((wit, icm.map_change(new, cur,
                                          live_cap=cfg.map_run_cap)))
        cur = new
    replays = cuda_graph.REPLAYS
    n1, n3 = _build.launches("assoc_sums"), _build.launches("relabel_walk")
    n4 = _build.launches("pose_lm")
    timings = {}
    graph = [(m, xx, wit, chg) for m, xx, wit, chg in icm.refine_sweeps(
        data, cur0, x0, cfg, w, cfg.N, change=True, timings=timings)]
    assert cuda_graph.REPLAYS - replays == cfg.N - 1
    assert _build.launches("assoc_sums") - n1 == cfg.N
    assert _build.launches("relabel_walk") - n3 == cfg.N
    # two red-black pairs of half-passes a sweep
    assert _build.launches("pose_lm") - n4 == 4 * cfg.N
    assert timings["capture_s"] > 0
    for (wit, chg), (_, _, gw, gc) in zip(eager, graph):
        assert torch.equal(wit, gw) and torch.equal(chg, gc)
    m, xx = graph[-1][:2]
    assert torch.equal(xx, x)
    assert all(torch.equal(a, b) for a, b in zip(m, cur))


def test_graph_sweeps_equal_eager_sweeps(dev):
    _hold_graph_to_eager(dev)


def test_graph_sweeps_on_a_card_that_is_not_current(dev):
    """The capture and the replays go to the sweep's own card, not to the
    current one: on card 1 with card 0 current, still bitwise eager."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    with torch.cuda.device(0):
        _hold_graph_to_eager(torch.device("cuda:1"))


def test_a_capture_that_fails_raises(dev):
    """A sweep that reads the card from the host cannot be captured: the
    capture raises (nothing falls back to eager sweeps)."""
    from icm_slam_tpu_torch.mapping.landmark_map import empty_map
    from icm_slam_tpu_torch.solver.cuda_graph import CapturedStep

    def sweep(m, x):
        return m, x + float(x.sum()), x.sum()
    x = torch.ones(4, device=dev)
    sweep(empty_map(4, device=dev), x)
    with pytest.raises(RuntimeError):
        CapturedStep(sweep, empty_map(4, device=dev), x)


# --- K4: the fused pose LM ----------------------------------------------

def _pose_problems(P, B, two_sided, seed, dev, empty=0):
    """P random pose problems near a consistent configuration (a fifth of
    the beams masked, the first ``empty`` problems all masked), with start
    poses and the weights: (PoseProblem, x0, w) on ``dev``."""
    from icm_slam_tpu_torch.core.energy import PoseProblem
    rng = np.random.default_rng(seed)
    xp = np.concatenate([rng.uniform(-5, 5, (P, 2)),
                         rng.uniform(-np.pi, np.pi, (P, 1))], 1)
    up = np.stack([rng.uniform(0.5, 1.5, P), rng.uniform(-0.3, 0.3, P)], 1)

    def step(x, u):
        return x + 0.1 * np.stack([u[:, 0] * np.cos(x[:, 2]),
                                   u[:, 0] * np.sin(x[:, 2]), u[:, 1]], 1)
    x = step(xp, up)
    uc = np.stack([rng.uniform(0.5, 1.5, P), rng.uniform(-0.3, 0.3, P)], 1)
    xn = step(x, uc)
    dist = rng.uniform(1.0, 9.0, (P, B))
    ang = np.sort(rng.uniform(0, np.pi, (P, B)), axis=1)
    mask = rng.uniform(size=(P, B)) >= 0.2
    mask[:empty] = False
    a = ang + x[:, 2:3] - np.pi / 2
    matched = (x[:, None, :2] + dist[..., None] * np.stack(
        [np.cos(a), np.sin(a)], -1) + rng.normal(0, 0.05, (P, B, 2)))
    noise = [rng.normal(0, 0.02, (P, 3)) for _ in range(3)]
    if not two_sided:
        xn, uc = np.zeros_like(xn), np.zeros_like(uc)
    fields = [dist, ang, mask, matched, xp, up, xp + noise[0],
              x + noise[1], xn, uc, xn + noise[2]]
    prob = PoseProblem(*[torch.from_numpy(
        f if f.dtype == bool else f.astype(np.float32)).to(dev)
        for f in fields])
    x0 = torch.from_numpy((x + rng.normal(0, 0.05, (P, 3))).astype(
        np.float32)).to(dev)
    w = (torch.sqrt(torch.tensor([1.0, 2.0, 0.5], device=dev)),
         torch.sqrt(torch.tensor([1.5, 0.7], device=dev)),
         torch.sqrt(torch.tensor(0.8, device=dev)), 0.1)
    return prob, x0, w


def _hold_k4(P, B, two_sided, fold, dev, empty=0, seed=0):
    """K4 bitwise its plain version on the card, and from run to run."""
    from icm_slam_tpu_torch.ops import pose_lm as k4
    prob, x0, w = _pose_problems(P, B, two_sided, seed + P + B, dev, empty)
    fd = (torch.arange(P, device=dev) % 7 == 3) if fold else None
    n4 = _build.launches("pose_lm")
    out = k4.pose_lm(prob, x0, w, 8, two_sided, fd)
    again = k4.pose_lm(prob, x0, w, 8, two_sided, fd)
    assert _build.launches("pose_lm") - n4 == 2
    plain = k4.pose_lm_plain(prob, x0, w, 8, two_sided, fd)
    torch.cuda.synchronize()
    assert torch.equal(out, again), "K4 differs from run to run"
    assert torch.equal(out, plain), (
        int((out != plain).any(dim=1).sum()),
        float((out - plain).abs().max()))
    return out


K4_SHAPES = [  # (P, B, two_sided, fold): what the runs give K4
    (32, 48, False, False), (916, 48, True, True), (916, 48, True, False),
    (1, 181, False, False), (1, 181, True, False), (1, 48, False, False),
    (1832, 48, True, True), (64, 96, False, False), (1832, 96, True, True),
    (128, 104, False, False), (3664, 104, True, True),
    (256, 152, False, False), (7328, 152, True, True),
    (32, 16, False, False), (120, 16, True, True), (4, 181, True, False),
    (4, 104, False, False), (1596, 104, True, True), (920, 48, True, True),
    (1, 1, False, False), (64, 300, True, True)]


@pytest.mark.parametrize("P,B,two_sided,fold", K4_SHAPES)
def test_k4_matches_plain(dev, P, B, two_sided, fold):
    _hold_k4(P, B, two_sided, fold, dev)


@pytest.mark.parametrize("two_sided", [False, True])
def test_k4_all_masked_problems(dev, two_sided):
    """Problems with no valid beam solve the kinematic and odometry rows
    alone, as the plain version does."""
    _hold_k4(24, 48, two_sided, two_sided, dev, empty=24)
    _hold_k4(24, 181, two_sided, False, dev, empty=7)


def test_k4_refuses_what_it_does_not_take(dev):
    from icm_slam_tpu_torch.ops import pose_lm as k4
    prob, x0, w = _pose_problems(4, 8, True, 1, dev)
    with pytest.raises(ValueError, match="x_next"):
        k4.pose_lm(prob._replace(x_next=prob.x_next[:, :2]), x0, w, 8, True)
    with pytest.raises(ValueError, match="on cpu"):
        k4.pose_lm(prob._replace(dist=prob.dist.cpu()), x0, w, 8, True)
    with pytest.raises(ValueError, match="fold"):
        k4.pose_lm(prob, x0, w, 8, False, torch.zeros(4, dtype=torch.bool,
                                                       device=dev))
    bad = k4.launch_plan(4, 8, True)._replace(shmem=64)   # too little
    with pytest.raises(RuntimeError, match="cudaError_t"):
        k4.launch(prob, x0, w, 8, True, None, bad)


def test_k4_reads_strided_rows_where_they_lie(dev):
    """Fields whose rows are contiguous but lie apart (a frame of a fleet's
    (W, T, B) data, a shared beam-angle row expanded to every problem)
    give what their contiguous copies give, bitwise."""
    from icm_slam_tpu_torch.ops import pose_lm as k4
    prob, x0, w = _pose_problems(6, 40, True, 3, dev)
    wide = prob._replace(**{
        name: torch.cat([a, torch.zeros_like(a)], dim=-1)[
            ..., :a.shape[-1]] if a.dim() == 2 else a
        for name, a in prob._asdict().items()
        if name not in ("matched", "ang")},
        ang=prob.ang[:1].expand(6, 40))
    dense = type(prob)(*(a.contiguous() for a in wide))
    assert not wide.dist.is_contiguous() and wide.ang.stride(0) == 0
    fold = torch.arange(6, device=dev) % 2 == 0
    assert torch.equal(k4.pose_lm(wide, x0, w, 8, True, fold),
                       k4.pose_lm(dense, x0, w, 8, True, fold))


def _torch_order_sum(t, vec, V, s0):
    """``ops.pose_lm.reduce_plan``'s order in NumPy float32: V partials
    (four interleaved accumulators each; ``vec``: four-float vectors from a
    row ``s0`` floats past a 16-byte boundary), then a halving tree."""
    f32, m = np.float32, len(t)

    def part(x):
        a = [f32(0)] * 4
        if not vec:
            for n, k in enumerate(range(x, m, V)):
                a[n % 4] = f32(a[n % 4] + t[k])
        else:
            base, end = 0, m
            if s0:
                if s0 <= x < 4:
                    a[0] = f32(a[0] + t[x - s0])
                base, end = 4 - s0, m - 4 + s0
            i = x
            while i * 4 + 3 < end:
                for j in range(4):
                    a[j] = f32(a[j] + t[base + 4 * i + j])
                i += V
            if end - end % 4 + x < end:
                a[0] = f32(a[0] + t[base + end - end % 4 + x])
        return f32(f32(f32(a[0] + a[1]) + a[2]) + a[3])
    vals = [part(x) for x in range(V)]
    while len(vals) > 1:
        h = len(vals) // 2
        vals = [f32(vals[i] + vals[i + h]) for i in range(h)]
    return vals[0]


@pytest.mark.parametrize("P,m", [(1, 108), (1, 368), (1, 374), (4, 374),
                                 (8, 102), (32, 102), (916, 108),
                                 (3, 128), (64, 130), (2, 30)])
def test_reduce_plan_is_torchs_sum_order(dev, P, m):
    """K4 adds its rows in the order ``reduce_plan`` gives, which must be
    the order torch's CUDA sum over dim 1 adds the plain version's (P, m),
    (P, m, 3) and (P, m, 3, 3) products: bitwise, on values of mixed
    magnitude where the order shows."""
    from icm_slam_tpu_torch.ops.pose_lm import reduce_plan
    rng = np.random.default_rng(P * 1000 + m)
    for outs in (1, 3, 9):
        d = (rng.standard_normal((P, m, outs))
             * 10.0 ** rng.uniform(-4, 4, (P, m, outs))).astype(np.float32)
        t = torch.from_numpy(d[..., 0].copy() if outs == 1 else
                             d.reshape((P, m) + ((3,) if outs == 3
                                                 else (3, 3))))
        got = t.to(dev).sum(dim=1).reshape(P, outs).cpu().numpy()
        vec, V = reduce_plan(P, m, outs)
        for p in sorted({0, 1, 2, 3, P // 2, P - 1} & set(range(P))):
            for o in range(outs):
                want = _torch_order_sum(d[p, :, o], vec, V, p * m % 4)
                assert want.tobytes() == got[p, o].tobytes(), (outs, p, o)


# --- the batched init replayed from a CUDA graph ---------------------------

def _hold_init_graph(dev, W):
    """``BatchedInit``'s steps on ``dev`` one by one and
    ``init_sweep_batched`` there (the first chunk eager, a capture, nc - 1
    replays): map, poses and count bitwise, each kernel counted as
    often."""
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.data.datasets import synthetic_world
    from icm_slam_tpu_torch.solver import cuda_graph, icm
    from icm_slam_tpu_torch.solver.sweeps import (BatchedInit,
                                                  init_sweep_batched, world)
    dss = [synthetic_world(T=240, n_landmarks=12, seed=s)
           for s in (7, 10, 11, 12)[:W]]
    data, seed, x0, cfg, w = icm.prepare_fleet(dss, ICMConfig(
        L=256, cota=20.0, N=1), dev)
    if W == 1:
        data, seed, x0 = (type(data)(*(a[0] for a in data)),
                          type(seed)(*(a[0] for a in seed)), x0[0])
    outs, counts = [], []
    nc = -(-(240 - 1) // cfg.init_chunk_len)
    for graph in (False, True):
        replays = cuda_graph.REPLAYS
        before = collections.Counter(_build.LAUNCHES)
        timings = {}
        if graph:
            outs.append(init_sweep_batched(data, seed, x0, cfg, w, timings))
            assert timings["init_capture_s"] > 0
        else:       # every chunk eagerly, as off the card
            one = W == 1
            run = BatchedInit(*(type(a)(*(f[None] for f in a)) if one else a
                                for a in (data, seed)),
                              x0[None] if one else x0, cfg, w)
            state = run.start
            for _ in range(run.nc):
                state = run.step(*state)
            st, x, n = run.finish(state[0])
            outs.append((world(st), x[0], n[0]) if one else (st, x, n))
        counts.append(_build.LAUNCHES - before)
        assert cuda_graph.REPLAYS - replays == (nc - 1 if graph else 0)
    (s1, x1, n1), (s2, x2, n2) = outs
    assert torch.equal(x1, x2) and torch.equal(n1, n2)
    assert all(torch.equal(a, b) for a, b in zip(s1, s2))
    assert counts[0] == counts[1]
    assert sum(n for (k, _), n in counts[0].items() if k == "pose_lm") == \
        cfg.init_rounds * nc


@pytest.mark.parametrize("W", [1, 4])
def test_graph_init_equals_eager_init(dev, W):
    _hold_init_graph(dev, W)


def test_graph_init_on_a_card_that_is_not_current(dev):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    with torch.cuda.device(0):
        _hold_init_graph(torch.device("cuda:1"), 1)


def test_an_init_capture_that_fails_raises(dev, monkeypatch):
    """A chunk that reads the card from the host cannot be captured: the
    init raises (nothing falls back to eager chunks)."""
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.data.datasets import synthetic_world
    from icm_slam_tpu_torch.solver import icm, sweeps
    ds = synthetic_world(T=120, n_landmarks=10, seed=7)
    cfg = ICMConfig(L=256, cota=20.0, N=1)
    data = icm.prepare(ds, cfg, dev)
    cfg = icm.resolve_config(cfg, data)
    x0 = torch.as_tensor(ds.x0, device=dev).float()
    seed = icm.seed_map(data, x0, cfg)
    chunk = sweeps._init_chunk

    def reads_back(inp, carry, config, w):
        carry, x = chunk(inp, carry, config, w)
        return carry, x + float(x.sum()) * 0.0
    monkeypatch.setattr(sweeps, "_init_chunk", reads_back)
    with pytest.raises(RuntimeError):
        sweeps.init_sweep_batched(data, seed, x0, cfg,
                                  icm.weights(cfg, dev))
