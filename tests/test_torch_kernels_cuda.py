"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here carries the ``cuda`` marker and skips where no GPU is
present: a CUDA kernel has no CPU mode.  This file imports neither JAX nor
the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py

Tolerances: labels exact; K1 d2min bitwise (--fmad=false), sums atol 1e-4
(f32 sums in another order); K2 distances atol 1e-5; a small end-to-end
run on the GPU against the same run on the CPU, census exact and poses
atol 1e-3.
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
