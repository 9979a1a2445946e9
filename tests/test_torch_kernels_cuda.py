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
same runs on the CPU, census exact and poses atol 1e-3.
"""
import numpy as np
import pytest
import torch

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
    before = k1.LAUNCHES
    lab, d2, sums = k1.associate_and_sums(pts, mp, mask, n, 1.0)
    assert k1.LAUNCHES == before + 1
    lab_p, d2_p, sums_p = k1.associate_and_sums_plain(pts, mp, mask, n, 1.0)
    assert torch.equal(lab, lab_p)
    assert torch.equal(d2, d2_p)
    assert float((sums - sums_p).abs().max()) <= 1e-4


@pytest.mark.parametrize("nact", [0, 1, 37, 1024])
def test_k2_kernel_matches_plain(dev, nact):
    pts, mp, _ = _inputs(33, 48, 1024, 4, dev)
    n = torch.tensor(nact, dtype=torch.int32, device=dev)
    before = k2.LAUNCHES
    lab, dist = k2.nearest_landmark(pts, mp, n)
    assert k2.LAUNCHES == before + 1
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
    before = k2.LAUNCHES
    for nact in (0, 1, lanes - 1, lanes + 1, 37, 100, 127, L - 1, L):
        _hold_k2(pts, mp, nact, plan, dev)
    assert k2.LAUNCHES == before + 9


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

    before = k2.LAUNCHES
    st_g, lab_g = call(dev)
    assert k2.LAUNCHES == before + 1
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
    before = k1.LAUNCHES
    gpu = run(ds, cfg, dev)
    assert k1.LAUNCHES == before + 3
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
    before = k2.LAUNCHES
    gpu = run(ds, cfg, dev)
    per_sweep = ds.T if kw.get("sweep_mode") == "sequential" else 1
    assert k2.LAUNCHES - before == ds.T - 1 + cfg.N * per_sweep
    cpu = run(ds, cfg, "cpu")
    assert gpu.map_pos.shape == cpu.map_pos.shape
    for f in ("x_init", "x", "map_pos"):
        np.testing.assert_allclose(getattr(gpu, f), getattr(cpu, f),
                                   atol=1e-3)
