"""Port parity of the sequential engines and the non-quirk / Jacobi batched
paths, against the JAX package on the CPU.

Unit ops (connected components, label allocation, scatter update, the
per-frame update): labels, counts and nact exact, positions atol 1e-5.
Sweeps, from the same JAX-made state on ``synthetic_world(T=240,
n_landmarks=12, seed=7)`` with L=256, cota=20: census and witnesses
exact, poses and map atol 1e-3.  The port solves every pose with its
analytic Jacobian and the cofactor 3x3 solve, where JAX's sequential
engines use ``jacfwd`` and an LU solve: the same math in another
rounding, which the causal chain carries from frame to frame (measured
here: at most 5.4e-4 over these tests).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icm_slam_tpu.config import ICMConfig as JC
from icm_slam_tpu.core.energy import weights as jweights
from icm_slam_tpu.data.datasets import synthetic_world
from icm_slam_tpu.mapping import landmark_map as jlm
from icm_slam_tpu.solver import icm as jicm
from icm_slam_tpu.solver import sweeps as jsw
from icm_slam_tpu_torch import convert
from icm_slam_tpu_torch.core.energy import weights as tweights
from icm_slam_tpu_torch.mapping import landmark_map as tlm
from icm_slam_tpu_torch.solver import icm as ticm
from icm_slam_tpu_torch.solver import sweeps as tsw
from tests.torch_parity import assert_close, assert_equal, jf32, tf32
from tests.torch_parity import one_thread  # noqa: F401

# one CPU thread: these small worlds run 2-3x faster without threads
pytestmark = pytest.mark.usefixtures("one_thread")

BAND = 1e-3


def _frame(seed, B=60, n_far=25):
    """One frame's points: clusters around a few centres, a chain of points
    0.9 apart (longer than the propagation rounds reach at this B), and
    a mask."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-8, 8, (5, 2))
    pts = centres[rng.integers(0, 5, B)] + rng.normal(0, 0.6, (B, 2))
    chain = np.stack([np.arange(n_far) * 0.9 + 20.0, np.zeros(n_far)], 1)
    pts[B - n_far:] = chain[rng.permutation(n_far)]
    mask = rng.uniform(size=B) < 0.85
    mask[B - n_far:] = True
    return pts.astype(np.float32), mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_connected_component_labels(seed):
    pts, mask = _frame(seed)
    out_j = jlm.connected_component_labels(jf32(pts), jnp.asarray(mask), 1.0)
    out_t = tlm.connected_component_labels(tf32(pts), torch.from_numpy(mask),
                                           1.0)
    assert_equal(out_t, out_j)
    # the chain is longer than the fixed rounds propagate: more than one
    # label survives on it, as in JAX
    assert len(np.unique(out_t.numpy()[-25:])) > 1
    batched = tlm.connected_component_labels(
        torch.stack([tf32(pts)] * 3), torch.from_numpy(np.stack([mask] * 3)),
        1.0)
    for row in batched:
        assert_equal(row, out_j)


def _labels_case(seed, L=64):
    """A frame's associated labels (-1 far, L masked) against a map."""
    pts, mask = _frame(seed)
    rng = np.random.default_rng(seed + 10)
    ref = rng.uniform(-8, 8, (L, 2)).astype(np.float32)
    live = np.arange(L) < 20
    lab, _ = jlm.associate(jf32(ref), jnp.asarray(live), jf32(pts),
                           jnp.asarray(mask), 1.0)
    return pts, mask, ref, np.array(lab)


@pytest.mark.parametrize("quirk", [True, False])
def test_allocate_new_labels(quirk):
    pts, mask, _, lab = _labels_case(3)
    assert (lab == -1).sum() > 25
    lab_j, n_j = jlm.allocate_new_labels(jnp.asarray(lab), jf32(pts),
                                         jnp.asarray(mask), jnp.int32(20),
                                         1.0, quirk)
    lab_t, n_t = tlm.allocate_new_labels(
        torch.from_numpy(lab), tf32(pts), torch.from_numpy(mask),
        torch.tensor(20, dtype=torch.int32), 1.0, quirk)
    assert_equal(lab_t, lab_j)
    assert int(n_t) == int(n_j) == (1 if quirk else int(n_j))
    assert quirk or int(n_t) > 2


def test_scatter_update_with_discards():
    rng = np.random.default_rng(4)
    L, B = 32, 50
    pos = rng.uniform(-5, 5, (L, 2)).astype(np.float32)
    counts = rng.integers(0, 9, L).astype(np.float32)
    pts = rng.uniform(-5, 5, (B, 2)).astype(np.float32)
    labels = rng.integers(0, L + 6, B).astype(np.int32)     # some >= L
    out_j = jlm.scatter_update(
        jlm.MapState(jf32(pos), jf32(counts), jnp.int32(30)), jf32(pts),
        jnp.asarray(labels), jnp.int32(2))
    out_t = tlm.scatter_update(
        tlm.MapState(tf32(pos), tf32(counts),
                     torch.tensor(30, dtype=torch.int32)),
        tf32(pts), torch.from_numpy(labels),
        torch.tensor(2, dtype=torch.int32))
    assert int(out_t.nact) == int(out_j.nact) == 32
    assert_equal(out_t.counts, out_j.counts)
    assert_close(out_t.pos, out_j.pos, 1e-5)


@pytest.mark.parametrize("quirk", [True, False])
def test_update(quirk):
    pts, mask, ref, _ = _labels_case(5)
    L = ref.shape[0]
    rng = np.random.default_rng(6)
    pos = rng.uniform(-8, 8, (L, 2)).astype(np.float32)
    counts = np.where(np.arange(L) < 24, rng.integers(1, 9, L),
                      0).astype(np.float32)
    st_j, lab_j = jlm.update(
        jlm.MapState(jf32(pos), jf32(counts), jnp.int32(24)), jf32(ref),
        jnp.int32(20), jf32(pts), jnp.asarray(mask), 1.0, quirk)
    st_t, lab_t = tlm.update(
        tlm.MapState(tf32(pos), tf32(counts),
                     torch.tensor(24, dtype=torch.int32)),
        tf32(ref), torch.tensor(20, dtype=torch.int32), tf32(pts),
        torch.from_numpy(mask), 1.0, quirk)
    assert_equal(lab_t, lab_j)
    assert int(st_t.nact) == int(st_j.nact) > 24
    assert_equal(st_t.counts, st_j.counts)
    assert_close(st_t.pos, st_j.pos, 1e-5)


@pytest.fixture(scope="module")
def world():
    """The small world's data and seed, and JAX's causal init on it."""
    ds = synthetic_world(T=240, n_landmarks=12, seed=7)
    jc = JC(L=256, cota=20.0, N=1, sweep_mode="sequential")
    data = jicm.prepare(ds, jc)
    jc = jicm.resolve_config(jc, data)
    x0 = jnp.asarray(ds.x0, jnp.float32)
    seed = jicm.seed_map(data, x0, jc)
    state, x_init, raw = jsw.init_sweep(data, seed, x0, jc, jweights(jc))
    return dict(ds=ds, jc=jc, data=data, x0=x0, seed=seed,
                init=(state, x_init, raw),
                cur=jicm._filter_jit(state, jc))


def _t(world, cfg=None):
    tc = convert.config_to_torch(cfg or world["jc"])
    return tc, convert.sweep_data_to_torch(world["data"], "cpu"), \
        tweights(tc, "cpu")


def test_init_sweep(world):
    tc, td, w = _t(world)
    assert tc.obs_cap == 0                     # sequential: all 181 beams
    state_j, x_j, raw_j = world["init"]
    state_t, x_t, raw_t = tsw.init_sweep(
        td, convert.map_to_torch(world["seed"], "cpu"),
        convert.poses_to_torch(world["x0"], "cpu"), tc, w)
    assert int(raw_t) == int(raw_j) == int(state_j.nact)
    assert_equal(state_t.counts, state_j.counts)
    assert_close(state_t.pos, state_j.pos, BAND)
    assert_close(x_t, x_j, BAND)


def test_init_sweep_compacted_and_non_quirk(world):
    """The init of the batched modes: compacted beams (obs_cap resolved)
    and, without the quirk, connected-component labels."""
    jc = dataclasses.replace(world["jc"], sweep_mode="batched", obs_cap=0,
                             replicate_new_obs_quirk=False)
    jc = jicm.resolve_config(jc, world["data"])
    assert 0 < jc.obs_cap < 181
    state_j, x_j, _ = jsw.init_sweep(world["data"], world["seed"],
                                     world["x0"], jc, jweights(jc))
    tc, td, w = _t(world, jc)
    state_t, x_t, _ = tsw.init_sweep(
        td, convert.map_to_torch(world["seed"], "cpu"),
        convert.poses_to_torch(world["x0"], "cpu"), tc, w)
    assert int(state_t.nact) == int(state_j.nact)
    assert_equal(state_t.counts, state_j.counts)
    assert_close(state_t.pos, state_j.pos, BAND)
    assert_close(x_t, x_j, BAND)


def test_causal_step_compaction_matches_full_width(world):
    """The in-step cumsum-scatter compaction (obs_cap on raw data, as the
    online engine runs it) gives the full-width init's census and counts
    exactly and its poses within the band (the pose solve sums its beams
    in another order)."""
    tc, td, w = _t(world)
    seed = convert.map_to_torch(world["seed"], "cpu")
    x0 = convert.poses_to_torch(world["x0"], "cpu")
    cap = tsw.auto_obs_cap(td.mask)
    full = tsw.init_chunk(td, seed, x0, tc, w)
    comp = tsw.init_chunk(td, seed, x0,
                          dataclasses.replace(tc, obs_cap=cap), w)
    assert int(comp[0].nact) == int(full[0].nact)
    assert_equal(comp[0].counts, full[0].counts)
    assert_close(comp[2], full[2], BAND)


def test_refine_sweep_sequential(world):
    tc, td, w = _t(world)
    x = world["init"][1]
    m_j, x_j, w_j = jicm._refine_jit(world["data"], world["cur"], x,
                                     world["jc"])
    m_t, x_t, w_t = ticm._refine_step(td, convert.map_to_torch(world["cur"],
                                                               "cpu"),
                                      convert.poses_to_torch(x, "cpu"), tc, w)
    assert_equal(w_t, w_j)
    assert int(m_t.nact) == int(m_j.nact) > 0
    assert_equal(m_t.counts, m_j.counts)
    assert_close(m_t.pos, m_j.pos, BAND)
    assert_close(x_t, x_j, BAND)


def test_refine_sweep_sequential_empty_frame0(world):
    """An empty frame 0 returns the frozen map and the caller's poses."""
    tc, td, w = _t(world)
    td = td._replace(mask=td.mask.clone())
    td.mask[0] = False
    cur = convert.map_to_torch(world["cur"], "cpu")
    x = convert.poses_to_torch(world["init"][1], "cpu")
    x_before = x.clone()
    m_t, x_t = tsw.refine_sweep_sequential(td, cur, x, tc, w)
    assert torch.equal(x_t, x_before) and torch.equal(x, x_before)
    for a, b in zip(m_t, cur):
        assert torch.equal(a, b)


@pytest.mark.parametrize("capped", [True, False])
def test_batched_associate_non_quirk(world, capped):
    jc = dataclasses.replace(world["jc"], sweep_mode="batched", obs_cap=0,
                             replicate_new_obs_quirk=False)
    jc = jicm.resolve_config(jc, world["data"])
    if not capped:
        jc = dataclasses.replace(jc, map_run_cap=0)
    assert (0 < jc.map_run_cap < jc.L) == capped
    data_j = jsw.compact_data(world["data"], jc.obs_cap)
    # frames 100-119 shifted off their poses: their beams land far from
    # the map and split into new components
    x = np.array(world["init"][1])
    x[100:120, 0] += 1.5
    lab_j, map_j, matched_j = jsw.batched_associate(data_j, world["cur"],
                                                    jnp.asarray(x), jc)
    lab_t, map_t, matched_t = tsw.batched_associate(
        convert.sweep_data_to_torch(data_j, "cpu"),
        convert.map_to_torch(world["cur"], "cpu"),
        convert.poses_to_torch(x, "cpu"), convert.config_to_torch(jc))
    assert_equal(lab_t, lab_j)
    assert int(map_t.nact) > int(world["cur"].nact) + 20   # components
    assert int(map_t.nact) == int(map_j.nact)
    assert_equal(map_t.counts, map_j.counts)
    assert_close(map_t.pos, map_j.pos, 1e-5)
    valid = np.asarray(data_j.mask)
    assert_close(matched_t.numpy()[valid], np.asarray(matched_j)[valid],
                 1e-5)


@pytest.mark.parametrize("quirk", [True, False])
def test_refine_step_jacobi(world, quirk):
    jc = dataclasses.replace(world["jc"], sweep_mode="batched", obs_cap=0,
                             replicate_new_obs_quirk=quirk,
                             pose_update="jacobi")
    jc = jicm.resolve_config(jc, world["data"])
    x = world["init"][1]
    m_j, x_j, w_j = jicm._refine_jit(world["data"], world["cur"], x, jc)
    tc, td, w = _t(world, jc)
    m_t, x_t, w_t = ticm._refine_step(
        td, convert.map_to_torch(world["cur"], "cpu"),
        convert.poses_to_torch(x, "cpu"), tc, w)
    assert_equal(w_t, w_j)
    assert int(m_t.nact) == int(m_j.nact) > 0
    assert_equal(m_t.counts, m_j.counts)
    assert_close(m_t.pos, m_j.pos, 1e-5)
    assert_close(x_t, x_j, 1e-4)


def test_hoist_skips_sequential(world):
    tc, td, _ = _t(world, dataclasses.replace(world["jc"], obs_cap=48))
    assert ticm.hoist_compaction(td, tc) is td
    tb = dataclasses.replace(tc, sweep_mode="batched")
    assert ticm.hoist_compaction(td, tb).dist.shape[1] == 48


@pytest.mark.parametrize("kw", [
    dict(sweep_mode="sequential", N=1),
    dict(replicate_new_obs_quirk=False, pose_update="jacobi", N=2),
])
def test_run_matches_jax(kw):
    """run() end to end on the small world in the new engines."""
    ds = synthetic_world(T=240, n_landmarks=12, seed=7)
    jc = JC(L=256, cota=20.0, **kw)
    j = jicm.run(ds, jc)
    p = ticm.run(ds, convert.config_to_torch(jc), "cpu")
    assert p.map_pos.shape == j.map_pos.shape
    assert_equal(p.map_counts, j.map_counts)
    for f in ("x_init", "x", "map_pos", "changes"):
        assert_close(getattr(p, f), getattr(j, f), BAND)


def _sqrt_tie(seed=0):
    """Two live columns around a point at the origin whose float32 d^2
    differ by an ulp (the first larger) while their sqrt rounds equal."""
    rng = np.random.default_rng(seed)
    while True:
        b = rng.uniform(0.5, 0.9, 2).astype(np.float32)
        r, a = np.float32(np.hypot(*b)), rng.uniform(0, 2 * np.pi)
        ref = np.stack([np.array([r * np.cos(a), r * np.sin(a)],
                                 np.float32), b])
        d2 = torch.from_numpy(ref).pow(2).sum(-1)
        if d2[0] > d2[1] and torch.sqrt(d2[0]) == torch.sqrt(d2[1]):
            return ref


def test_k2_vs_associate_near_tie():
    """K2 takes the argmin of d^2, JAX's ``associate`` that of sqrt(d^2):
    on a sqrt tie of unequal d^2 they pick different columns at the same
    distance, so the gate agrees; away from such ties the labels agree."""
    from icm_slam_tpu_torch.ops.assoc import nearest_landmark_plain
    ref = _sqrt_tie()
    pts, live, mask = np.zeros((1, 2), np.float32), np.ones(2, bool), \
        np.ones(1, bool)
    lab_j, d_j = jlm.associate(jf32(ref), jnp.asarray(live), jf32(pts),
                               jnp.asarray(mask), 5.0)
    lab_a, d_a = tlm.associate(tf32(ref), torch.from_numpy(live), tf32(pts),
                               torch.from_numpy(mask), 5.0)
    lab_k, d_k = nearest_landmark_plain(tf32(pts)[None], tf32(ref),
                                        torch.tensor(2, dtype=torch.int32))
    assert int(lab_j[0]) == int(lab_a[0]) == 0 and int(lab_k[0, 0]) == 1
    assert float(d_j[0]) == float(d_a[0]) == float(d_k[0, 0])
    rng = np.random.default_rng(1)
    ref = rng.uniform(-8, 8, (256, 2)).astype(np.float32)
    pts = rng.uniform(-8, 8, (181, 2)).astype(np.float32)
    nact = torch.tensor(200, dtype=torch.int32)
    lab_a, d_a = tlm.associate(tf32(ref), torch.arange(256) < nact,
                               tf32(pts), torch.ones(181, dtype=torch.bool),
                               1e9)
    lab_k, d_k = nearest_landmark_plain(tf32(pts)[None], tf32(ref), nact)
    assert_equal(lab_k[0], lab_a)
    assert_equal(d_k[0], d_a)
