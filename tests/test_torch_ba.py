"""Port parity of the bundle-adjustment backends (``sweep_mode="ba"`` and
``"windowed_ba"``, ``icm_slam_tpu_torch.models``) against the JAX package
on the CPU, from the same JAX-made state.

Unit functions atol 1e-5 (rtol 1e-5 where a value is a sum of thousands
of terms): the BA residuals and energy, the windowed chain and window
residuals with the forward-edge mask.  The Schur system of one GN step
(its mat-vec, right-hand side and block-Jacobi blocks) is held against
JAX's dense Jacobians (``jacfwd`` of ``_residuals``) at rtol 1e-4: the
port forms the same products matrix-free, in another order.  One
``ba_refine`` / ``windowed_ba_refine`` call and whole runs: census
exact, poses and map atol 1e-3 (PCG's f32 dot products sum in another
order than JAX's, and twelve iterations carry that).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icm_slam_tpu import cli as jcli
from icm_slam_tpu.config import ICMConfig as JC
from icm_slam_tpu.core.energy import weights as jweights
from icm_slam_tpu.data.datasets import synthetic_world
from icm_slam_tpu.models import bundle_adjustment as jba
from icm_slam_tpu.models import windowed_ba as jwba
from icm_slam_tpu.solver import icm as jicm
from icm_slam_tpu.solver import sweeps as jsw
from icm_slam_tpu_torch import cli as tcli
from icm_slam_tpu_torch import convert
from icm_slam_tpu_torch.config import ICMConfig as TC
from icm_slam_tpu_torch.core.energy import weights as tweights
from icm_slam_tpu_torch.models import bundle_adjustment as tba
from icm_slam_tpu_torch.models import windowed_ba as twba
from icm_slam_tpu_torch.solver import icm as ticm
from tests.torch_parity import assert_close, assert_equal, jf32, tf32
from tests.torch_parity import one_thread  # noqa: F401

# one CPU thread: these small worlds run 2-3x faster without threads
pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAND = 1e-3
DAMPING = 1e-5
# JAX's association, compiled once (op by op it runs the fused kernel's
# interpret mode ten times slower)
_associate = jax.jit(jsw.batched_associate, static_argnames="config")


@pytest.fixture(scope="module")
def world():
    """JAX-made init state on a small world (capped branch, fused K1), the
    data hoisted and compacted as ``run`` hands it to the refine step."""
    ds = synthetic_world(T=60, n_landmarks=10, seed=2)
    jc = JC(L=256, cota=5.0, N=1, use_pallas_fused_assoc=True)
    raw = jicm.prepare(ds, jc)
    jc = jicm.resolve_config(jc, raw)
    assert 0 < jc.map_run_cap < jc.L and jc.obs_cap < raw.dist.shape[1]
    x0 = jnp.asarray(ds.x0, jnp.float32)
    state, x, _ = jicm._init_jit(raw, jicm.seed_map(raw, x0, jc), x0, jc)
    cur = jicm._filter_jit(state, jc)
    data = jicm.hoist_compaction(raw, jc)
    # poses a little off the init's, so that every GN step has work
    rng = np.random.default_rng(0)
    x = x + jf32(np.concatenate([np.zeros((1, 3)), rng.normal(
        0, 0.02, (x.shape[0] - 1, 3))]))
    tc = convert.config_to_torch(jc)
    return dict(ds=ds, data=data, jc=jc, cur=cur, x=x, tc=tc,
                td=convert.sweep_data_to_torch(data, "cpu"),
                tcur=convert.map_to_torch(cur, "cpu"),
                tx=convert.poses_to_torch(x, "cpu"), w=jweights(jc),
                tw=tweights(tc, "cpu"))


@pytest.fixture(scope="module")
def problem(world):
    """The BA problem of one outer iteration in both packages, built the
    way JAX's ba_refine builds it (icm_slam_tpu/models/
    bundle_adjustment.py:115-132)."""
    data, cur, x, jc = world["data"], world["cur"], world["x"], world["jc"]
    labels, amap, _ = _associate(data, cur, x, config=jc)
    L = cur.pos.shape[0]
    valid = (labels < L) & data.mask
    order = jnp.argsort(~valid, axis=1, stable=True)[:, :jc.obs_cap]

    def take(a):
        return jnp.take_along_axis(a, order, axis=1)
    prob_j = jba.BAProblem(data, take(data.dist), take(data.ang),
                           take(labels), take(valid).astype(x.dtype),
                           amap.counts, amap.counts > 0)
    prob_t, amap_t = tba.ba_problem(world["td"], world["tcur"], world["tx"],
                                    world["tc"])
    return prob_j, amap, prob_t, amap_t


def test_ba_problem_matches_jax(problem):
    prob_j, amap_j, prob_t, amap_t = problem
    for f in ("dist", "ang", "labels", "obs_w", "counts", "live"):
        assert_equal(getattr(prob_t, f), getattr(prob_j, f))
    assert_close(amap_t.pos, amap_j.pos, 1e-5)
    assert int(amap_t.nact) == int(amap_j.nact)


def test_ba_residuals_and_energy_match_jax(world, problem):
    prob_j, amap_j, prob_t, _ = problem
    y = jnp.asarray(amap_j.pos) + 0.01
    r_j = jba._residuals(world["x"], y, prob_j, world["w"])
    r_t = tba._residuals(world["tx"], tf32(np.asarray(y)), prob_t,
                         world["tw"])
    for a, b in zip(r_t, r_j):
        assert a.shape == b.shape
        assert_close(a, b, 1e-5)
    e_j = float(jba.energy(world["x"], y, prob_j, world["w"]))
    e_t = float(tba.energy(world["tx"], tf32(np.asarray(y)), prob_t,
                           world["tw"]))
    assert e_t == pytest.approx(e_j, rel=1e-5)


@pytest.fixture(scope="module")
def dense(world, problem):
    """The Schur-reduced system from JAX's dense Jacobians at (x, y)."""
    prob_j, amap_j, prob_t, _ = problem
    x, y, w = world["x"], jnp.asarray(amap_j.pos), world["w"]
    T, L = x.shape[0], y.shape[0]

    def flat(xx, yy):
        return jnp.concatenate([r.reshape(-1)
                                for r in jba._residuals(xx, yy, prob_j, w)])
    r = flat(x, y)
    Jx = jax.jit(jax.jacfwd(flat, 0))(x, y).reshape(r.shape[0], 3 * T)
    Jy = jax.jit(jax.jacfwd(flat, 1))(x, y).reshape(r.shape[0], 2 * L)
    g = jnp.ones((T, 3), x.dtype).at[0].set(0.0).reshape(-1)
    q = w[1] * w[1]
    hinv = jnp.where(prob_j.live[:, None],
                     1.0 / (prob_j.counts[:, None] * q + DAMPING),
                     0.0).reshape(-1)

    def schur(v):
        jv = Jx @ (g * v)
        jv = jv - Jy @ (hinv * (Jy.T @ jv))
        return g * (Jx.T @ jv) + DAMPING * g * v
    gy = jnp.where(prob_j.live[:, None], (Jy.T @ r).reshape(L, 2),
                   0.0).reshape(-1)
    rhs = -(g * (Jx.T @ r) - g * (Jx.T @ (Jy @ (hinv * gy))))
    H = (g[:, None] * (Jx.T @ Jx) * g[None, :]).reshape(T, 3, T, 3)
    blocks = H[jnp.arange(T), :, jnp.arange(T), :] + DAMPING * jnp.eye(3)
    blocks = blocks.at[0].set(jnp.eye(3))
    lin = tba.linearize(prob_t, world["tx"], tf32(np.asarray(y)),
                        world["tw"], DAMPING)
    return dict(schur=schur, rhs=rhs, blocks=blocks, lin=lin, T=T)


def _rel_close(a, b, rtol=1e-4):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * np.abs(b).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_schur_mat_vec_matches_dense_jax(dense, seed):
    T = dense["T"]
    v = np.random.default_rng(seed).normal(size=(T, 3)).astype(np.float32)
    out_t = dense["lin"].schur_mv(tf32(v))
    out_j = dense["schur"](jf32(v).reshape(-1)).reshape(T, 3)
    assert float(out_t[0].abs().max()) == 0.0       # pose 0 is anchored
    _rel_close(out_t, out_j)


def test_schur_rhs_matches_dense_jax(dense):
    _rel_close(dense["lin"].rhs, dense["rhs"].reshape(dense["T"], 3))


def test_block_jacobi_blocks_match_dense_jax(dense):
    assert_equal(dense["lin"].blocks[0], np.eye(3, dtype=np.float32))
    _rel_close(dense["lin"].blocks, dense["blocks"])


@pytest.mark.parametrize("gn_iters", [1, 4])
def test_ba_refine_matches_jax(world, gn_iters):
    args = (world["cur"], world["x"], world["jc"], world["w"])
    m_j, x_j = jba.ba_refine(world["data"], *args, gn_iters=gn_iters,
                             cg_iters=12)
    rep = {}
    m_t, x_t = tba.ba_refine(world["td"], world["tcur"], world["tx"],
                             world["tc"], world["tw"], gn_iters=gn_iters,
                             cg_iters=12, report=rep)
    assert int(m_t.nact) == int(m_j.nact)
    assert_close(m_t.counts, m_j.counts, 0.0)
    assert_close(m_t.pos, m_j.pos, BAND)
    assert_close(x_t, x_j, BAND)
    assert_equal(x_t[0], world["tx"][0])             # pose 0 is anchored
    e = rep["energies"].numpy()
    assert e.shape == (gn_iters,) and (np.diff(e) <= 0).all()


@pytest.mark.parametrize("mode", ["ba", "windowed_ba"])
def test_run_matches_jax(mode):
    ds = synthetic_world(T=60, n_landmarks=10, seed=2)
    jc = JC(L=256, cota=5.0, N=2, sweep_mode=mode, ba_window=16,
            use_pallas_fused_assoc=True)
    tc = convert.config_to_torch(jc)
    assert ticm.resolve_config(tc, ticm.prepare(ds, tc, "cpu")) == \
        convert.config_to_torch(jicm.resolve_config(jc, jicm.prepare(ds, jc)))
    r_j, r_t = jicm.run(ds, jc), ticm.run(ds, tc, "cpu")
    assert r_t.map_pos.shape == r_j.map_pos.shape
    np.testing.assert_array_equal(r_t.map_counts, r_j.map_counts)
    for f in ("x_init", "x", "map_pos", "changes"):
        assert_close(getattr(r_t, f), getattr(r_j, f), BAND)


def test_ba_config_fields():
    """The BA knobs: JAX's defaults, read from the reference YAML format."""
    for f in ("ba_gn_iters", "ba_cg_iters", "ba_window"):
        assert getattr(TC(), f) == getattr(JC(), f)
    assert (TC().ba_gn_iters, TC().ba_cg_iters, TC().ba_window) == (4, 12, 64)
    cfg = TC.from_yaml(os.path.join(REPO, "configs", "reference.yaml"),
                       ba_window=32, sweep_mode="windowed_ba")
    assert (cfg.ba_window, cfg.sweep_mode) == (32, "windowed_ba")


# --- windowed BA -------------------------------------------------------------

def _window_args(seed, W=4, K=3):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        p=rng.normal(size=(W, 3)).astype(f),
        x_prev=rng.normal(size=3).astype(f),
        x_next=rng.normal(size=3).astype(f),
        dist=rng.uniform(1, 8, (W, K)).astype(f),
        ang=rng.uniform(0, np.pi, (W, K)).astype(f),
        mask=rng.uniform(size=(W, K)) < 0.7,
        matched=rng.normal(size=(W, K, 2)).astype(f),
        u_in=rng.normal(size=(W, 2)).astype(f),
        odo_in=rng.normal(size=(W, 3)).astype(f),
        odo_prev=rng.normal(size=3).astype(f),
        u_last=rng.normal(size=2).astype(f),
        odo_next=rng.normal(size=3).astype(f),
        frame_ok=np.array([True] * (W - 1) + [seed % 2 == 0]))


def test_chain_residuals_match_jax(world):
    rng = np.random.default_rng(3)
    f = np.float32
    xa, xb, odo_a, odo_b = (rng.normal(size=(9, 3)).astype(f)
                            for _ in range(4))
    u = rng.normal(size=(9, 2)).astype(f)
    out_j = jax.vmap(jwba._chain_residuals,
                     in_axes=(0, 0, 0, 0, 0, None))(
        jf32(xa), jf32(xb), jf32(u), jf32(odo_a), jf32(odo_b), world["w"])
    out_t = twba._chain_residuals(tf32(xa), tf32(xb), tf32(u), tf32(odo_a),
                                  tf32(odo_b), world["tw"])
    assert_close(out_t, out_j, 1e-5)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("next_ok", [True, False])
def test_window_residuals_match_jax(world, seed, next_ok):
    a = _window_args(seed)
    j_args = [jnp.asarray(v) if v.dtype == bool else jf32(v)
              for v in a.values()]
    t_args = [torch.from_numpy(v) if v.dtype == bool else tf32(v)
              for v in a.values()]
    out_j = jwba._window_residuals(*j_args, jnp.asarray(next_ok),
                                   world["w"])
    out_t = twba._window_residuals(*t_args, torch.tensor(next_ok),
                                   world["tw"])
    assert out_t.shape == out_j.shape == (2 * 4 * 3 + 6 * 5,)
    assert_close(out_t, out_j, 1e-5)


def test_windowed_forward_edge_masked_at_trajectory_end(world):
    """The port of tests/test_ba.py's forward-edge case: a window ending at
    the last real frame has no real frame after it, so its forward chain
    edge (a self-edge onto the window's own stale last pose) contributes
    zero residuals, and nothing else changes."""
    a = _window_args(0)
    a["x_next"] = a["p"][-1] + np.float32(0.5)
    a["dist"][:] = 0.0
    a["ang"][:] = 0.0
    a["mask"][:] = False
    a["matched"][:] = 0.0
    t_args = [torch.from_numpy(v) if v.dtype == bool else tf32(v)
              for v in a.values()]
    r_on = twba._window_residuals(*t_args, torch.tensor(True), world["tw"])
    r_off = twba._window_residuals(*t_args, torch.tensor(False),
                                   world["tw"])
    assert bool((r_on[-6:] != 0).any())
    assert bool((r_off[-6:] == 0).all())
    assert torch.equal(r_on[:-6], r_off[:-6])


@pytest.fixture(scope="module")
def window_obs(world):
    data, jc = world["data"], world["jc"]
    _, fmap, matched = _associate(data, world["cur"], world["x"], config=jc)
    obs_j = (data.dist, data.ang, data.mask, matched)
    td = world["td"]
    obs_t = (td.dist, td.ang, td.mask, tf32(np.asarray(matched)))
    return obs_j, obs_t


@pytest.mark.parametrize("offset,W", [(0, 16), (8, 16), (40, 64),
                                      (70, 64)])
def test_solve_windows_matches_jax(world, window_obs, offset, W):
    """Full windows, a window that runs past the last frame, and a pass
    whose only window starts past it (inert: JAX's gathers clamp)."""
    jc = dataclasses.replace(world["jc"], ba_gn_iters=3)
    tc = dataclasses.replace(world["tc"], ba_gn_iters=3)
    T = world["x"].shape[0]
    x_j = jwba._solve_windows(world["data"], window_obs[0], world["x"],
                              offset, W, T - 1, jc, world["w"])
    x_t = twba._solve_windows(world["td"], window_obs[1], world["tx"],
                              offset, W, T - 1, tc, world["tw"])
    assert_close(x_t, x_j, BAND)
    # pose 0 is never free; the poses before the first window stay
    assert_equal(x_t[:offset + 1], world["tx"][:offset + 1])
    moved = float((x_t - world["tx"]).abs().max())
    assert (moved > 1e-4) == (offset + 1 < T)


def test_windowed_ba_refine_matches_jax(world):
    args = (world["cur"], world["x"], world["jc"], world["w"])
    m_j, x_j = jwba.windowed_ba_refine(world["data"], *args, window=16)
    m_t, x_t = twba.windowed_ba_refine(world["td"], world["tcur"],
                                       world["tx"], world["tc"],
                                       world["tw"], window=16)
    assert int(m_t.nact) == int(m_j.nact)
    assert_close(m_t.counts, m_j.counts, 0.0)
    assert_close(m_t.pos, m_j.pos, 1e-5)
    assert_close(x_t, x_j, BAND)


@pytest.mark.parametrize("mode", ["ba", "windowed_ba"])
def test_cli_mode_matches_jax(tmp_path, capsys, mode):
    """``--mode ba`` / ``--mode windowed_ba`` through both CLIs (JAX with
    its fused association kernel, the route of the port's capped branch):
    census exact, poses atol 1e-3."""
    common = ["run", "--dataset", "synthetic", "--frames", "60",
              "--config", os.path.join(REPO, "configs", "reference.yaml"),
              "--iters", "1", "--mode", mode, "--quiet"]
    jcli.main(common + ["--cpu", "--pallas-fused",
                        "--out", str(tmp_path / "j.npz")])
    tcli.main(common + ["--device", "cpu", "--out", str(tmp_path / "t.npz")])
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert t["map_pos"].shape == j["map_pos"].shape
        assert_close(t["x"], j["x"], BAND)
        assert_close(t["x_init"], j["x_init"], BAND)
    assert capsys.readouterr().out == ""
