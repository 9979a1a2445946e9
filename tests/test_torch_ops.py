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
    before = dict(_build.LAUNCHES)
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
    assert dict(_build.LAUNCHES) == before
    assert _build.launches("assoc_sums") == 0
    assert _build.launches("nearest_landmark") == 0


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
        ["assoc_sums.cu", "nearest_landmark.cu", "pose_lm.cu",
         "relabel_walk.cu"]
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_launch_error_raises():
    with pytest.raises(RuntimeError, match="cudaError_t 2"):
        _build.check(2, "icm_assoc_sums")
    _build.check(0, "icm_assoc_sums")


# --- the kernels' lane split and launch plans, as far as a CPU reaches ---

def _nact_cases(lanes, width):
    return {"zero": 0, "one": 1, "lanes-1": max(lanes - 1, 0),
            "lanes+1": lanes + 1, "all": width}


@pytest.mark.parametrize("lanes", [1, 8, 32])
@pytest.mark.parametrize("which", ["zero", "one", "lanes-1", "lanes+1",
                                   "all"])
def test_k2_plain_lanes_equal_serial(lanes, which):
    """Columns split over strided lanes and combined by the kernel's rule
    (smaller d2, then smaller index) give the serial result, exactly."""
    pts, mp = _k2_inputs(T=4, B=181, L=256, seed=3)
    nact = torch.tensor(_nact_cases(lanes, 256)[which], dtype=torch.int32)
    lab, dist = k2.nearest_landmark_plain(tf32(pts), tf32(mp), nact,
                                          lanes=lanes)
    lab_1, dist_1 = k2.nearest_landmark_plain(tf32(pts), tf32(mp), nact)
    assert torch.equal(lab, lab_1)
    assert torch.equal(dist, dist_1)
    assert lab.dtype == torch.int32


@pytest.mark.parametrize("lanes", [1, 8, 32])
@pytest.mark.parametrize("which", ["zero", "one", "lanes-1", "lanes+1",
                                   "all"])
def test_k1_plain_lanes_equal_serial(lanes, which):
    pts, mp, mask = _k1_inputs()
    nact = torch.tensor(_nact_cases(lanes, 128)[which], dtype=torch.int32)
    out = k1.associate_and_sums_plain(tf32(pts), tf32(mp),
                                      torch.from_numpy(mask), nact, 1.0,
                                      lanes=lanes)
    ref = k1.associate_and_sums_plain(tf32(pts), tf32(mp),
                                      torch.from_numpy(mask), nact, 1.0)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("lanes", [1, 8, 32])
def test_plain_lanes_keep_first_minimum_on_duplicates(lanes):
    """Every column four times (neighbours, shuffled, in order): each
    point's tie spans lanes, and the first column must win."""
    rng = np.random.default_rng(5)
    cols = rng.uniform(-15, 15, (64, 2)).astype(np.float32)
    order = np.concatenate([np.repeat(np.arange(64), 2),
                            rng.permutation(64), np.arange(64)])
    mp = cols[order]
    pts = (cols[rng.integers(0, 64, (3, 48))]
           + rng.normal(0, 0.8, (3, 48, 2))).astype(np.float32)
    mask = np.ones((3, 48), bool)
    for nact in (2, 127, 129, 200, 256):
        n = torch.tensor(nact, dtype=torch.int32)
        lab, dist = k2.nearest_landmark_plain(tf32(pts), tf32(mp), n,
                                              lanes=lanes)
        lab_1, dist_1 = k2.nearest_landmark_plain(tf32(pts), tf32(mp), n)
        assert torch.equal(lab, lab_1) and torch.equal(dist, dist_1)
        # the winner is the first of its copies among the live columns
        first = np.array([np.flatnonzero(order[:nact] == order[i])[0]
                          for i in lab.numpy().ravel()])
        assert np.array_equal(first, lab.numpy().ravel())
        out = k1.associate_and_sums_plain(
            tf32(pts), tf32(mp), torch.from_numpy(mask), n, 2.0, lanes=lanes)
        ref = k1.associate_and_sums_plain(
            tf32(pts), tf32(mp), torch.from_numpy(mask), n, 2.0)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)


def test_lane_min_rejects_odd_lane_counts():
    with pytest.raises(ValueError):
        k2.lane_min(torch.zeros((2, 8)), 3)


@pytest.mark.parametrize("n_pts,L,lanes", [
    (1833 * 48, 1024, 1),        # the uncapped sweep
    (1833 * 48, 128, 1),         # the non-quirk sweep's first columns
    (181, 1024, 32),             # one frame in landmark_map.update
    (181, 2048, 32),
    (128 * 48, 1024, 1),
    (1, 1, 32), (4096, 7, 32), (4097, 7, 1), (1000003, 30000, 1)])
def test_k2_launch_plan_covers_points_within_shared_memory(n_pts, L, lanes):
    plan = k2.launch_plan(n_pts, L)
    assert plan.lanes == lanes
    assert plan.blocks * plan.threads >= n_pts * plan.lanes
    # no block without a point of its own
    assert (plan.blocks - 1) * plan.threads < n_pts * plan.lanes
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert plan.shmem % 256 == 0 and 256 <= plan.shmem <= 48 * 1024
    assert plan.shmem <= 227 * 1024
    assert plan.shmem >= 8 * min(L, k2.RESIDENT_COLUMNS)


def test_k2_launch_plan_spreads_one_frame_and_launches_nothing_for_none():
    assert k2.launch_plan(181, 1024).blocks > 1
    assert k2.launch_plan(0, 1024).blocks == 0
    lab, dist = k2.nearest_landmark(torch.zeros((0, 8, 2)),
                                    torch.zeros((16, 2)),
                                    torch.tensor(3, dtype=torch.int32))
    assert lab.shape == dist.shape == (0, 8)
    # a chunk narrower than the table, as the checks on the card use it
    plan = k2.plan_for(181, 1024, lanes=32, columns=40)
    assert plan.shmem == 512 and plan.blocks == -(-181 * 32 // 128)
    assert plan.threads == 128


@pytest.mark.parametrize("T,B,K", [(1833, 48, 128), (240, 24, 128),
                                   (7, 181, 130), (0, 48, 128)])
def test_k1_launch_plan_matches_the_kernels_layout(T, B, K):
    plan = k1.launch_plan(T, B, K)
    assert plan.blocks == T and plan.lanes == k1.LANES == 8
    assert plan.threads % (32 * 1) == 0 and plan.threads % plan.lanes == 0
    sums = -(-12 * K // 16) * 16                   # 16-byte aligned sums
    assert plan.shmem == sums + 8 * K + 12 * B <= 48 * 1024


def test_k1_check_follows_the_shared_memory_layout():
    nact = torch.tensor(3, dtype=torch.int32)
    mask = torch.zeros((2, 8), dtype=torch.bool)
    pts = tf32(np.zeros((2, 8, 2)))
    k1._check(pts, tf32(np.zeros((2448, 2))), mask, nact)
    with pytest.raises(ValueError, match="shared memory"):
        k1._check(pts, tf32(np.zeros((2456, 2))), mask, nact)


def test_build_key_holds_the_shared_header():
    assert [p.rsplit("/", 1)[-1] for p in _build._headers()] == \
        ["lane_argmin.cuh"]
    nact = torch.tensor(3, dtype=torch.int32)
    assert _build.as_count(nact, nact.device) is nact
    made = _build.as_count(5, torch.device("cpu"))
    assert made.dtype == torch.int32 and made.shape == () and int(made) == 5


def test_check_refuses_a_view_that_starts_on_an_odd_float():
    """The kernels read (x, y) rows as float2: a contiguous view 4 bytes
    off an 8-byte boundary is refused, an aligned one of the same rows
    passes."""
    nact = torch.tensor(3, dtype=torch.int32)
    mask = torch.zeros((2, 8), dtype=torch.bool)
    pts = tf32(np.zeros((2, 8, 2)))
    flat = torch.zeros(2 * 16 + 2)
    flat = flat[(flat.data_ptr() % 8) // 4:]          # 8-byte aligned start
    good, odd = flat[:32].view(16, 2), flat[1:33].view(16, 2)
    assert odd.is_contiguous() and odd.data_ptr() % 8 == 4
    k2._check(pts, good, nact)
    k1._check(pts, good, mask, nact)
    with pytest.raises(ValueError, match="8-byte"):
        k2._check(pts, odd, nact)
    with pytest.raises(ValueError, match="8-byte"):
        k1._check(pts, odd, mask, nact)
    with pytest.raises(ValueError, match="8-byte"):
        k2._check(flat[1:33].view(2, 8, 2), good, nact)
