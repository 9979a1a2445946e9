"""Port parity of the two kernels' plain versions against the JAX package's
Pallas kernels (interpret mode) and references, and the wrappers' CPU
dispatch.  The CUDA kernels themselves run only on a GPU: their checks
against the plain versions are in test_torch_kernels_cuda.py.

Tolerances: labels exact; K1 d2min rtol 1e-6 where a live column exists
(with none, JAX reports its ~1e18 sentinel distance, the port +inf), sums
atol 1e-4 (f32 sums in another order); K2 distance atol 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icm_slam_tpu.ops.assoc_pallas import (nearest_landmark,
                                           nearest_landmark_reference)
from icm_slam_tpu.ops.assoc_sums_pallas import (associate_and_sums,
                                                associate_and_sums_reference)
from icm_slam_tpu_torch.ops import _build
from icm_slam_tpu_torch.ops import assoc as k2
from icm_slam_tpu_torch.ops import assoc_sums as k1
from tests.torch_parity import assert_close, assert_equal, jf32, tf32


def _k1_inputs(T=24, B=24, K=128, seed=11):
    rng = np.random.default_rng(seed)
    mp = rng.uniform(-10, 10, (K, 2)).astype(np.float32)
    pts = (mp[rng.integers(0, 7, (T, B))]
           + rng.normal(0, 1.0, (T, B, 2))).astype(np.float32)
    mask = rng.uniform(size=(T, B)) < 0.7
    return pts, mp, mask


def _k2_inputs(T=16, B=181, L=256, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 10, (T, B, 2)).astype(np.float32),
            rng.normal(0, 10, (L, 2)).astype(np.float32))


@pytest.mark.parametrize("nact", [0, 1, 7, 128])
def test_k1_plain_matches_jax(nact):
    pts, mp, mask = _k1_inputs()
    n = jnp.asarray(nact, jnp.int32)
    lab_i, d2_i, sums_i = associate_and_sums(jf32(pts), jf32(mp),
                                             jnp.asarray(mask), n, 1.0,
                                             interpret=True)
    lab_r, d2_r, sums_r = associate_and_sums_reference(
        jf32(pts), jf32(mp), jnp.asarray(mask), n, 1.0)
    lab_t, d2_t, sums_t = k1.associate_and_sums_plain(
        tf32(pts), tf32(mp), torch.from_numpy(mask),
        torch.tensor(nact, dtype=torch.int32), 1.0)
    for lab_j, d2_j, sums_j in ((lab_i, d2_i, sums_i),
                                (lab_r, d2_r, sums_r)):
        assert_equal(lab_t, lab_j)
        assert_close(sums_t, sums_j, 1e-4)
        if nact:
            assert_close(d2_t, d2_j, 0.0, rtol=1e-6)
        else:
            assert bool(torch.isinf(d2_t).all())
            assert float(jnp.min(d2_j)) > 1e12
    if nact == 128:
        assert float(sums_t[:, 2].sum()) > 0      # the gate let beams in


@pytest.mark.parametrize("nact", [0, 1, 37, 256])
def test_k2_plain_matches_jax(nact):
    pts, mp = _k2_inputs()
    n = jnp.asarray(nact, jnp.int32)
    lab_i, d_i = nearest_landmark(jf32(pts), jf32(mp), n, interpret=True)
    lab_t, d_t = k2.nearest_landmark_plain(
        tf32(pts), tf32(mp), torch.tensor(nact, dtype=torch.int32))
    assert_equal(lab_t, lab_i)
    if nact:
        assert_close(d_t, d_i, 1e-4)
        lab_r, d_r = nearest_landmark_reference(jf32(pts), jf32(mp), n)
        assert_equal(lab_t, lab_r)
        assert_close(d_t, d_r, 1e-4)
    else:
        assert bool(torch.isinf(d_t).all())
        assert float(jnp.min(d_i)) > 1e6


def test_cpu_dispatch_runs_plain_and_counts_nothing():
    pts, mp, mask = _k1_inputs()
    nact = torch.tensor(50, dtype=torch.int32)
    before = (k1.LAUNCHES, k2.LAUNCHES)
    out = k1.associate_and_sums(tf32(pts), tf32(mp), torch.from_numpy(mask),
                                nact, 1.0)
    ref = k1.associate_and_sums_plain(tf32(pts), tf32(mp),
                                      torch.from_numpy(mask), nact, 1.0)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    out = k2.nearest_landmark(tf32(pts), tf32(mp), nact)
    ref = k2.nearest_landmark_plain(tf32(pts), tf32(mp), nact)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert (k1.LAUNCHES, k2.LAUNCHES) == before == (0, 0)


@pytest.mark.parametrize("bad", ["dtype", "shape", "mask", "nact",
                                 "contiguous"])
def test_k1_wrapper_rejects_bad_inputs(bad):
    pts, mp, mask = tf32(np.zeros((4, 8, 2))), tf32(np.zeros((128, 2))), \
        torch.zeros((4, 8), dtype=torch.bool)
    nact = torch.tensor(3, dtype=torch.int32)
    if bad == "dtype":
        pts = pts.double()
    elif bad == "shape":
        mp = mp[:, :1]
    elif bad == "mask":
        mask = mask.int()
    elif bad == "nact":
        nact = nact[None]
    else:
        pts = pts.transpose(0, 1)
    with pytest.raises(ValueError):
        k1._check(pts, mp, mask, nact)


def test_k2_wrapper_rejects_bad_inputs():
    pts, mp = tf32(np.zeros((4, 8, 2))), tf32(np.zeros((256, 2)))
    with pytest.raises(ValueError):
        k2._check(pts, mp, torch.tensor(3))          # int64 nact
    with pytest.raises(ValueError):
        k2._check(pts[..., :1], mp, torch.tensor(3, dtype=torch.int32))
    k2._check(pts, mp, torch.tensor(3, dtype=torch.int32))


def test_build_key_and_missing_nvcc(monkeypatch):
    path = _build.library_path()
    assert path == _build.library_path()
    assert path.startswith(_build.BUILD_DIR)
    assert "--fmad=false" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert [p.rsplit("/", 1)[-1] for p in _build._sources()] == \
        ["assoc_sums.cu", "nearest_landmark.cu"]
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_launch_error_raises():
    with pytest.raises(RuntimeError, match="cudaError_t 2"):
        _build.check(2, "icm_assoc_sums")
    _build.check(0, "icm_assoc_sums")
