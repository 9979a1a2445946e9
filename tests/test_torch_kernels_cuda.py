"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here carries the ``cuda`` marker and skips where no GPU is
present: a CUDA kernel has no CPU mode.  This file imports neither JAX nor
the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py

Tolerances: labels exact; K1 d2min bitwise (--fmad=false), sums atol 1e-4
(f32 sums in another order); K2 distances atol 1e-5; the per-frame map
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
