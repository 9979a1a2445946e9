"""Port parity of the batched sweeps, from the same JAX-made state.

Both packages get the same init map and poses through
``icm_slam_tpu_torch.convert``.  The capped branch is held against JAX
with ``use_pallas_fused_assoc=True`` (the fused kernel, in interpret mode
here), the uncapped one (``map_run_cap=0``) against ``use_pallas_assoc=
True`` (the nearest-landmark kernel): the JAX side reaches the kernel the
port's branch replaces, with the same form of distance gate.

Tolerances: labels, witness and nact exact; map positions atol 1e-5;
poses after one sweep atol 1e-4 (LM near-ties, see
test_torch_gauss_newton.py).  The init's poses: 99% of frames within 1e-4,
all within 2e-3.  Its Picard rounds re-associate every frame from the
previous round's poses and re-solve, so a rounding-level pose difference
can flip a borderline beam across the gate; in a frame with 5 valid beams
that moves the pose by ~1e-3 (measured: one frame of 200, 1.26e-3; the
next largest 7.9e-5).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icm_slam_tpu.config import ICMConfig as JC
from icm_slam_tpu.data.datasets import synthetic_world
from icm_slam_tpu.solver import icm as jicm
from icm_slam_tpu.solver import sweeps as jsw
from icm_slam_tpu_torch import convert
from icm_slam_tpu_torch.core.energy import weights as tweights
from icm_slam_tpu_torch.solver import icm as ticm
from icm_slam_tpu_torch.solver import sweeps as tsw
from tests.torch_parity import assert_close, assert_equal


@pytest.fixture(scope="module")
def world():
    """JAX-made init state on a small world, for both branches."""
    ds = synthetic_world(T=200, n_landmarks=12, seed=7)
    capped = JC(L=256, cota=20.0, N=1, use_pallas_fused_assoc=True)
    data = jicm.prepare(ds, capped)
    capped = jicm.resolve_config(capped, data)
    assert 0 < capped.map_run_cap < capped.L          # the capped branch
    uncapped = dataclasses.replace(capped, map_run_cap=0,
                                   use_pallas_fused_assoc=False,
                                   use_pallas_assoc=True)
    x0 = jnp.asarray(ds.x0, jnp.float32)
    seed = jicm.seed_map(data, x0, capped)
    state, x_init, raw_nact = jicm._init_jit(data, seed, x0, capped)
    cur = jicm._filter_jit(state, capped)
    return dict(ds=ds, data=data, capped=capped, uncapped=uncapped, x0=x0,
                seed=seed, init=(state, x_init, raw_nact), cur=cur)


def test_compact_data_and_obs_cap(world):
    data = world["data"]
    cap = jsw.auto_obs_cap(data.mask)
    td = convert.sweep_data_to_torch(data, "cpu")
    assert tsw.auto_obs_cap(td.mask) == cap
    out_j = jsw.compact_data(data, cap)
    out_t = tsw.compact_data(td, cap)
    for f in ("dist", "mask", "ang", "odom", "u"):
        assert_equal(getattr(out_t, f), getattr(out_j, f))
    assert out_t.ang.shape == (data.dist.shape[0], cap)


@pytest.mark.parametrize("branch", ["capped", "uncapped"])
def test_batched_associate(world, branch):
    jc = world[branch]
    tc = convert.config_to_torch(jc)
    data_j = jsw.compact_data(world["data"], jc.obs_cap)
    x = world["init"][1]
    lab_j, map_j, matched_j = jsw.batched_associate(data_j, world["cur"], x,
                                                    jc)
    lab_t, map_t, matched_t = tsw.batched_associate(
        convert.sweep_data_to_torch(data_j, "cpu"),
        convert.map_to_torch(world["cur"], "cpu"),
        convert.poses_to_torch(x, "cpu"), tc)
    assert_equal(lab_t, lab_j)
    assert int(map_t.nact) == int(map_j.nact)
    assert_close(map_t.counts, map_j.counts, 0.0)
    assert_close(map_t.pos, map_j.pos, 1e-5)
    valid = np.asarray(data_j.mask)
    assert_close(matched_t.numpy()[valid], np.asarray(matched_j)[valid],
                 1e-5)


@pytest.mark.parametrize("branch", ["capped", "uncapped"])
def test_refine_step(world, branch):
    jc = world[branch]
    tc = convert.config_to_torch(jc)
    x = world["init"][1]
    m_j, x_j, w_j = jicm._refine_jit(world["data"], world["cur"], x, jc)
    m_t, x_t, w_t = ticm._refine_step(
        convert.sweep_data_to_torch(world["data"], "cpu"),
        convert.map_to_torch(world["cur"], "cpu"),
        convert.poses_to_torch(x, "cpu"), tc, tweights(tc, "cpu"))
    assert_equal(w_t, w_j)
    assert int(m_t.nact) == int(m_j.nact) > 0
    assert_close(m_t.counts, m_j.counts, 0.0)
    assert_close(m_t.pos, m_j.pos, 1e-5)
    assert_close(x_t, x_j, 1e-4)


def test_refine_sweep_hoisted_equals_unhoisted(world):
    """Compaction hoisted out of the loop gives the same sweep."""
    tc = convert.config_to_torch(world["capped"])
    td = convert.sweep_data_to_torch(world["data"], "cpu")
    args = (convert.map_to_torch(world["cur"], "cpu"),
            convert.poses_to_torch(world["init"][1], "cpu"), tc,
            tweights(tc, "cpu"))
    m_a, x_a = tsw.refine_sweep_batched(td, *args)
    m_b, x_b = tsw.refine_sweep_batched(ticm.hoist_compaction(td, tc), *args)
    assert torch.equal(x_a, x_b)
    assert torch.equal(m_a.pos, m_b.pos)


def test_init_sweep_batched(world):
    jc = world["capped"]
    tc = convert.config_to_torch(jc)
    state_j, x_j, raw_j = world["init"]
    state_t, x_t, raw_t = tsw.init_sweep_batched(
        convert.sweep_data_to_torch(world["data"], "cpu"),
        convert.map_to_torch(world["seed"], "cpu"),
        convert.poses_to_torch(world["x0"], "cpu"), tc, tweights(tc, "cpu"))
    assert int(raw_t) == int(raw_j)
    assert int(state_t.nact) == int(state_j.nact)
    assert_close(state_t.counts, state_j.counts, 0.0)
    err = np.abs(x_t.numpy() - np.asarray(x_j)).max(axis=1)
    assert err.max() <= 2e-3
    assert (err > 1e-4).mean() <= 0.01
    assert_close(state_t.pos, state_j.pos, 1e-3)


def test_se2_scan_matches_sequential_composition():
    rng = np.random.default_rng(0)
    n = 33
    th, tx, ty = (torch.from_numpy(rng.normal(0, 1, n)) for _ in range(3))
    anc = torch.from_numpy(rng.uniform(size=n) < 0.2)
    anc[0] = True
    out = tsw._se2_scan(th, tx, ty, anc)
    ref = [[float(th[0]), float(tx[0]), float(ty[0])]]
    for i in range(1, n):
        if anc[i]:
            ref.append([float(th[i]), float(tx[i]), float(ty[i])])
            continue
        a, x, y = ref[-1]
        ref.append([a + float(th[i]),
                    x + np.cos(a) * float(tx[i]) - np.sin(a) * float(ty[i]),
                    y + np.sin(a) * float(tx[i]) + np.cos(a) * float(ty[i])])
    ref = np.array(ref)
    for k in range(3):
        np.testing.assert_allclose(out[k].numpy(), ref[:, k], atol=1e-9)


def test_convert_round_trip(world):
    m = convert.map_to_torch(world["cur"], "cpu")
    pos, counts, nact = convert.map_to_numpy(m)
    assert_equal(pos, world["cur"].pos)
    assert_equal(counts, world["cur"].counts)
    assert nact == int(world["cur"].nact) and nact.dtype == np.int32
    d = convert.sweep_data_to_numpy(
        convert.sweep_data_to_torch(world["data"], "cpu"))
    for a, b in zip(d, world["data"]):
        assert_equal(a, b)
    x = world["init"][1]
    assert_equal(convert.poses_to_numpy(convert.poses_to_torch(x, "cpu")), x)
