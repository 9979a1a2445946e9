"""Port parity: landmark table association, prune/merge and seeding
(nact and counts exact, positions atol 1e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icm_slam_tpu.mapping import landmark_map as jlm
from icm_slam_tpu_torch.mapping import landmark_map as tlm
from tests.torch_parity import assert_close, assert_equal, jf32, tf32

ATOL = 1e-5


def _jmap(pos, counts, nact):
    return jlm.MapState(jf32(pos), jf32(counts), jnp.asarray(nact, jnp.int32))


def _tmap(pos, counts, nact):
    return tlm.MapState(tf32(pos), tf32(counts),
                        torch.tensor(nact, dtype=torch.int32))


def _close_pair_map(L, n, seed):
    """n live landmarks with chains of near-duplicates, exact duplicates
    and counts around cota=10."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((L, 2), np.float32)
    base = rng.uniform(-20, 20, (n, 2))
    src = rng.integers(0, n, n // 3)
    dst = rng.choice(n, n // 3, replace=False)
    base[dst] = base[src] + rng.normal(0, 0.3, (n // 3, 2))
    base[n - 1] = base[0]                          # exact duplicate
    pos[:n] = base
    counts = np.zeros((L,), np.float32)
    counts[:n] = rng.integers(0, 40, n)
    counts[0] = counts[n - 1] = 25
    return pos, counts


def test_associate():
    rng = np.random.default_rng(0)
    L, T, B = 64, 8, 30
    ref = rng.uniform(-10, 10, (L, 2)).astype(np.float32)
    live = np.arange(L) < 41
    pts = (ref[rng.integers(0, 41, (T, B))]
           + rng.normal(0, 0.7, (T, B, 2))).astype(np.float32)
    mask = rng.uniform(size=(T, B)) < 0.8
    lt, dt = tlm.associate(tf32(ref), torch.from_numpy(live), tf32(pts),
                           torch.from_numpy(mask), 1.0)
    for t in range(T):
        lj, dj = jlm.associate(jf32(ref), jnp.asarray(live), jf32(pts[t]),
                               jnp.asarray(mask[t]), 1.0)
        assert_equal(lt[t], lj)
        assert_close(dt[t], dj, ATOL)
    assert (lt == -1).any() and (lt == L).any()


@pytest.mark.parametrize("live_cap", [0, 128])
@pytest.mark.parametrize("seed", [0, 1])
def test_filter_map_close_pairs(live_cap, seed):
    L, n = 256, 90
    pos, counts = _close_pair_map(L, n, seed)
    out_j = jlm.filter_map(_jmap(pos, counts, n), 10.0, 1.0,
                           live_cap=live_cap)
    out_t = tlm.filter_map(_tmap(pos, counts, n), 10.0, 1.0,
                           live_cap=live_cap)
    assert int(out_t.nact) == int(out_j.nact)
    assert int(out_t.nact) < int((counts >= 10).sum())   # merges happened
    assert_equal(out_t.counts, out_j.counts)
    assert_close(out_t.pos, out_j.pos, ATOL)


def test_filter_map_no_close_and_cota_zero():
    rng = np.random.default_rng(3)
    L, n = 128, 30
    pos = np.zeros((L, 2), np.float32)
    pos[:n] = np.stack([np.arange(n) * 3.0, rng.uniform(-1, 1, n)], 1)
    counts = np.zeros((L,), np.float32)
    counts[:n] = rng.integers(1, 5, n)
    for cota in (0.0, 3.0):
        out_j = jlm.filter_map(_jmap(pos, counts, n), cota, 1.0)
        out_t = tlm.filter_map(_tmap(pos, counts, n), cota, 1.0)
        assert int(out_t.nact) == int(out_j.nact)
        assert_equal(out_t.counts, out_j.counts)
        assert_close(out_t.pos, out_j.pos, ATOL)


def test_filter_map_empty():
    L = 64
    out_j = jlm.filter_map(jlm.empty_map(L), 5.0, 1.0)
    out_t = tlm.filter_map(tlm.empty_map(L), 5.0, 1.0)
    assert int(out_t.nact) == int(out_j.nact) == 0
    assert_equal(out_t.counts, out_j.counts)
    assert_equal(out_t.pos, out_j.pos)


def test_seed_from_clusters():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-5, 5, (23, 2)).astype(np.float32)
    labels = rng.integers(0, 7, 23).astype(np.int32)
    labels[0] = 6
    out_j = jlm.seed_from_clusters(64, jf32(pts), jnp.asarray(labels))
    out_t = tlm.seed_from_clusters(64, pts, labels)
    assert int(out_t.nact) == int(out_j.nact) == 7
    assert_equal(out_t.counts, out_j.counts)
    assert_close(out_t.pos, out_j.pos, ATOL)


def test_compact_labels():
    rng = np.random.default_rng(6)
    B = 40
    lab = rng.integers(0, B + 1, B).astype(np.int32)
    valid = rng.uniform(size=B) < 0.7
    out_j = jlm.compact_labels(jnp.asarray(lab), jnp.asarray(valid), B)
    out_t = tlm.compact_labels(torch.from_numpy(lab),
                               torch.from_numpy(valid), B)
    assert_equal(out_t, out_j)
