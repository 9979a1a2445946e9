"""Port parity of the custom energy hooks (``config.model``) against the JAX
package on the CPU.

Each hook of ``EnergyModel`` is written twice, in JAX (one problem) and
in torch (the port's batched convention), and held hook by hook: the
one- and two-sided residuals atol 1e-5, their Jacobians (the port's
analytic terms plus forward mode for the hook's own terms) against JAX's
``jacfwd`` of the whole residual atol 1e-4.  A batched LM solve with a
model: one step atol 1e-5, several steps atol 1e-4 (LM near-ties, see
test_torch_gauss_newton.py).  Sweeps, from the same JAX-made state, with
a model that extends the two-sided cost, so that the last frame is
solved on its own (``_solve_one_at``) in Jacobi and in red-black passes,
with the last frame in either parity: witness exact, poses and map atol
1e-3 (JAX against itself, jit against op by op, differs by 3.0e-4
there).  Whole runs on small worlds: census exact, poses and map atol
1e-3.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from icm_slam_tpu.config import ICMConfig as JC
from icm_slam_tpu.core import energy as je
from icm_slam_tpu.core.geometry import wrap_angle as jwrap
from icm_slam_tpu.data.datasets import synthetic_world
from icm_slam_tpu.solver import gauss_newton as jgn
from icm_slam_tpu.solver import icm as jicm
from icm_slam_tpu.solver import sweeps as jsw
from icm_slam_tpu_torch import convert
from icm_slam_tpu_torch.config import ICMConfig as TC
from icm_slam_tpu_torch.core import energy as te
from icm_slam_tpu_torch.core.geometry import wrap_angle as twrap
from icm_slam_tpu_torch.solver import gauss_newton as tgn
from icm_slam_tpu_torch.solver import icm as ticm
from icm_slam_tpu_torch.solver import sweeps as tsw
from tests.torch_parity import (assert_close, jax_problem, jax_weights, jf32,
                                random_problems, tf32, torch_problem,
                                torch_weights)
from tests.torch_parity import one_thread  # noqa: F401

# one CPU thread: these small worlds run 2-3x faster without threads
pytestmark = pytest.mark.usefixtures("one_thread")

BAND = 1e-3


# --- each hook, in JAX (one problem) and in torch (P problems) ---------------

def _j_kin(x, u, dt):
    return jnp.stack([x[..., 0] + dt * u[..., 0] * jnp.cos(x[..., 2]),
                      x[..., 1] + dt * u[..., 0] * jnp.sin(x[..., 2]),
                      x[..., 2] + 1.1 * dt * u[..., 1]], axis=-1)


def _t_kin(x, u, dt):
    return torch.stack([x[..., 0] + dt * u[..., 0] * torch.cos(x[..., 2]),
                        x[..., 1] + dt * u[..., 0] * torch.sin(x[..., 2]),
                        x[..., 2] + 1.1 * dt * u[..., 1]], dim=-1)


def _j_robust_obs(x, p, sqrt_q):
    a = p.ang + x[2] - jnp.pi / 2.0
    pts = x[:2][None, :] + p.dist[:, None] * jnp.stack(
        [jnp.cos(a), jnp.sin(a)], axis=-1)
    r = (pts - p.matched) * sqrt_q[None, :]
    n2 = jnp.sum(r * r, axis=-1, keepdims=True)
    return jnp.where(p.mask[:, None], r / jnp.sqrt(1.0 + n2), 0.0)


def _t_robust_obs(x, p, sqrt_q):
    a = p.ang + x[:, 2:3] - math.pi / 2.0
    pts = x[:, None, :2] + p.dist[..., None] * torch.stack(
        [torch.cos(a), torch.sin(a)], dim=-1)
    r = (pts - p.matched) * sqrt_q
    n2 = (r * r).sum(dim=-1, keepdim=True)
    return torch.where(p.mask[..., None], r / torch.sqrt(1.0 + n2), 0.0)


HOOKS = {
    "obs_scale": (dict(obs_scale=lambda d, a: 1.0 / (1.0 + d)),
                  dict(obs_scale=lambda d, a: 1.0 / (1.0 + d))),
    "extra_one_sided": (
        dict(extra_one_sided=lambda x, p: 5.0 * (x[:2] - p.odo_cur[:2])),
        dict(extra_one_sided=lambda x, p: 5.0 * (x[:, :2]
                                                 - p.odo_cur[:, :2]))),
    "extra_two_sided": (
        dict(extra_two_sided=lambda x, p: 3.0 * jnp.sin(
            x[2:3] - p.odo_next[2:3])),
        dict(extra_two_sided=lambda x, p: 3.0 * torch.sin(
            x[:, 2:3] - p.odo_next[:, 2:3]))),
    "kinematics": (dict(kinematics=_j_kin), dict(kinematics=_t_kin)),
    "obs_model": (dict(obs_model=_j_robust_obs),
                  dict(obs_model=_t_robust_obs)),
    "one_sided": (
        dict(one_sided=lambda x, p, w: jnp.concatenate([
            1.5 * je.one_sided_residuals(x, p, w, je.DEFAULT_MODEL),
            0.1 * x])),
        dict(one_sided=lambda x, p, w: torch.cat([
            1.5 * te.one_sided_residuals(x, p, w, te.DEFAULT_MODEL),
            0.1 * x], dim=1))),
    "two_sided": (
        dict(two_sided=lambda x, p, w: jnp.tanh(
            je.two_sided_residuals(x, p, w, je.DEFAULT_MODEL))),
        dict(two_sided=lambda x, p, w: torch.tanh(
            te.two_sided_residuals(x, p, w, te.DEFAULT_MODEL)))),
}


def _models(name):
    jkw, tkw = HOOKS[name]
    return je.EnergyModel(**jkw), te.EnergyModel(**tkw)


def _jax_batched(fn, fields, x0):
    """fn(x (3,), prob) over every problem of random_problems, by vmap."""
    probs = jax_problem(fields, slice(None))
    return jax.vmap(fn)(jf32(x0), probs)


@pytest.fixture(scope="module")
def problems():
    fields, x0 = random_problems(6, 16, seed=11)
    return fields, x0, jax_weights(), torch_weights()


@pytest.mark.parametrize("hook", sorted(HOOKS))
@pytest.mark.parametrize("side", ["one", "two"])
def test_hook_residuals_match_jax(problems, hook, side):
    fields, x0, jw, tw = problems
    jm, tm = _models(hook)
    jres = getattr(je, f"{side}_sided_residuals")
    tres = getattr(te, f"{side}_sided_residuals")
    r_j = _jax_batched(lambda x, p: jres(x, p, jw, jm), fields, x0)
    r_t = tres(tf32(x0), torch_problem(fields), tw, tm)
    assert r_t.shape == r_j.shape
    assert_close(r_t, r_j, 1e-5)
    # the hook changes the residual against the default model, unless it
    # belongs to the two-sided cost only
    r_d = tres(tf32(x0), torch_problem(fields), tw)
    changed = r_d.shape != r_t.shape or not torch.allclose(r_d, r_t)
    assert changed != (side == "one" and hook.endswith("two_sided"))


@pytest.mark.parametrize("hook", sorted(HOOKS))
def test_hook_jacobians_match_jax_jacfwd(problems, hook):
    fields, x0, jw, tw = problems
    jm, tm = _models(hook)
    for side in ("one", "two"):
        jres = getattr(je, f"{side}_sided_residuals")
        J_j = _jax_batched(jax.jacfwd(lambda x, p: jres(x, p, jw, jm)),
                           fields, x0)
        J_t = getattr(te, f"{side}_sided_jacobian")(
            tf32(x0), torch_problem(fields), tw, tm)
        assert J_t.shape == J_j.shape
        assert_close(J_t, J_j, 1e-4, rtol=1e-5)


def test_hook_jacobian_of_hook_without_pose_is_zero(problems):
    fields, x0, _, _ = problems
    J = te.hook_jacobian(lambda x, p: p.odo_cur * 2.0, tf32(x0),
                         torch_problem(fields))
    assert J.shape == (6, 3, 3) and not J.any()


def test_wrap_angle_has_unit_slope_in_forward_mode():
    """torch.remainder (the port) and jnp.mod (JAX) under forward mode, on
    both sides of every wrap point."""
    a = np.array([-7.0, -math.pi - 1e-3, -math.pi + 1e-3, -1.0, 0.0, 1.0,
                  math.pi - 1e-3, math.pi + 1e-3, 7.0], np.float32)
    with fwAD.dual_level():
        out = fwAD.unpack_dual(twrap(fwAD.make_dual(
            tf32(a), torch.ones(a.shape[0]))))
    d_j = jax.vmap(jax.jacfwd(jwrap))(jf32(a))
    assert_close(out.tangent, d_j, 0.0)
    assert_close(out.tangent, np.ones_like(a), 0.0)
    assert_close(out.primal, jwrap(jf32(a)), 1e-6)


def test_forward_jacobian_matches_jacfwd(problems):
    """``hook_jacobian``, the port's one forward-mode route, over the whole
    two-sided residual: JAX's ``jacfwd`` and the analytic Jacobian."""
    fields, x0, jw, tw = problems
    prob = torch_problem(fields)
    J_t = te.hook_jacobian(
        lambda xx, pp: te.two_sided_residuals(xx, pp, tw), tf32(x0), prob)
    J_j = _jax_batched(jax.jacfwd(
        lambda x, p: je.two_sided_residuals(x, p, jw)), fields, x0)
    assert_close(J_t, J_j, 1e-4, rtol=1e-5)
    assert_close(J_t, te.two_sided_jacobian(tf32(x0), prob, tw), 1e-4,
                 rtol=1e-5)


@pytest.mark.parametrize("iters", [1, 6])
def test_lm_with_model_matches_jax(iters):
    fields, x0 = random_problems(12, 16, seed=3 + iters)
    jw, tw = jax_weights(), torch_weights()
    jm, tm = _models("extra_two_sided")
    jm = dataclasses.replace(jm, obs_scale=HOOKS["obs_scale"][0]["obs_scale"])
    tm = dataclasses.replace(tm, obs_scale=HOOKS["obs_scale"][1]["obs_scale"])
    x_j = _jax_batched(lambda x, p: jgn.lm_minimize(
        lambda xx: je.two_sided_residuals(xx, p, jw, jm), x, iters=iters),
        fields, x0)
    prob = torch_problem(fields)
    x_t = tgn.lm_minimize(lambda xx: te.two_sided_residuals(xx, prob, tw, tm),
                          lambda xx: te.two_sided_jacobian(xx, prob, tw, tm),
                          tf32(x0), iters=iters)
    assert_close(x_t, x_j, 1e-5 if iters == 1 else 1e-4)


# --- sweeps with a model -----------------------------------------------------

@pytest.fixture(scope="module")
def sweep_world():
    """JAX-made init state on a small world (capped branch, fused K1)."""
    ds = synthetic_world(T=40, n_landmarks=10, seed=2)
    jc = JC(L=256, cota=5.0, N=1, use_pallas_fused_assoc=True)
    data = jicm.prepare(ds, jc)
    jc = jicm.resolve_config(jc, data)
    x0 = jnp.asarray(ds.x0, jnp.float32)
    state, x_init, _ = jicm._init_jit(data, jicm.seed_map(data, x0, jc), x0,
                                      jc)
    return dict(data=data, jc=jc, cur=jicm._filter_jit(state, jc), x=x_init)


def _pair_configs(jc, hook_names, **kw):
    """The same config in both packages with the named hooks set."""
    jkw, tkw = {}, {}
    for name in hook_names:
        jkw.update(HOOKS[name][0])
        tkw.update(HOOKS[name][1])
    jc = dataclasses.replace(jc, model=je.EnergyModel(**jkw), **kw)
    tc = dataclasses.replace(
        convert.config_to_torch(dataclasses.replace(jc, model=None)),
        model=te.EnergyModel(**tkw))
    return jc, tc


@pytest.mark.parametrize("update", ["jacobi", "red_black"])
@pytest.mark.parametrize("T", [40, 39])
def test_refine_sweep_unfolded_last_frame(sweep_world, update, T):
    """extra_two_sided keeps the last frame out of the batch: its one-sided
    solve is written into its slot (position last_t - 1 in a Jacobi pass,
    (last_t - start) // 2 in its parity's half-pass).  Poses within the
    1e-3 band: with this hook JAX against itself (jit against op by op)
    differs by 3.0e-4 on the T=120 world of the same seed."""
    jc, tc = _pair_configs(sweep_world["jc"], ["extra_two_sided"],
                           pose_update=update)
    data = sweep_world["data"]
    data = data._replace(**{f: getattr(data, f)[:T]
                            for f in ("dist", "mask", "odom", "u")})
    x = sweep_world["x"][:T]
    m_j, x_j, wit_j = jicm._refine_jit(data, sweep_world["cur"], x, jc)
    m_t, x_t, wit_t = ticm._refine_step(
        convert.sweep_data_to_torch(data, "cpu"),
        convert.map_to_torch(sweep_world["cur"], "cpu"),
        convert.poses_to_torch(x, "cpu"), tc, te.weights(tc, "cpu"))
    assert_close(wit_t, wit_j, 0.0)
    assert int(m_t.nact) == int(m_j.nact)
    assert_close(m_t.pos, m_j.pos, BAND)
    assert_close(x_t, x_j, BAND)
    # the last frame moved: its own one-sided solve was written back
    assert float((x_t[T - 1] - convert.poses_to_torch(x, "cpu")[T - 1])
                 .abs().max()) > 1e-5


def test_solve_one_at_matches_jax(sweep_world):
    jc, tc = _pair_configs(sweep_world["jc"], ["extra_one_sided",
                                               "obs_scale"])
    data = jsw.compact_data(sweep_world["data"], jc.obs_cap)
    x = sweep_world["x"]
    _, _, matched = jax.jit(jsw.batched_associate, static_argnames="config")(
        data, sweep_world["cur"], x, config=jc)
    obs = (data.dist, data.ang, data.mask, matched)
    t = x.shape[0] - 1
    x_j = jax.jit(jsw._solve_one_at, static_argnames=("config", "t"))(
        data, x, obs, config=jc, w=je.weights(jc), t=t)
    td = convert.sweep_data_to_torch(data, "cpu")
    x_t = tsw._solve_one_at(
        td, convert.poses_to_torch(x, "cpu"),
        (td.dist, td.ang, td.mask, tf32(np.asarray(matched))), tc,
        te.weights(tc, "cpu"), t)
    assert_close(x_t, x_j, 1e-4)


# --- whole runs --------------------------------------------------------------

@pytest.mark.parametrize("engine", ["causal_init", "batched_init",
                                    "sequential"])
def test_run_with_hooks_matches_jax(engine):
    """The hooks of tests/test_extensions.py through ``run``: a model sends
    the default init to the causal sweep; ``init_mode="batched"`` and
    the sequential sweep mode take the other engines."""
    ds = synthetic_world(T=40, n_landmarks=8, seed=4)
    kw = {"causal_init": dict(N=1), "batched_init": dict(
        N=2, init_mode="batched"), "sequential": dict(
            N=1, sweep_mode="sequential")}[engine]
    jc, tc = _pair_configs(
        JC(L=128, cota=5.0, use_pallas_fused_assoc=True, **kw),
        ["obs_scale", "extra_one_sided", "extra_two_sided"])
    assert ticm.use_batched_init(tc) == jicm.use_batched_init(jc) == (
        engine == "batched_init")
    r_j, r_t = jicm.run(ds, jc), ticm.run(ds, tc, "cpu")
    assert r_t.map_pos.shape == r_j.map_pos.shape
    np.testing.assert_array_equal(r_t.map_counts, r_j.map_counts)
    for f in ("x_init", "x", "map_pos"):
        assert_close(getattr(r_t, f), getattr(r_j, f), BAND)
    # the hooks moved the solution away from the default model's
    r_d = ticm.run(ds, dataclasses.replace(tc, model=None), "cpu")
    assert np.abs(r_d.x - r_t.x).max() > 1e-5


def test_run_with_robust_obs_model_matches_jax():
    ds = synthetic_world(T=40, n_landmarks=8, seed=4)
    jc, tc = _pair_configs(JC(L=128, cota=5.0, N=1,
                              use_pallas_fused_assoc=True), ["obs_model"])
    r_j, r_t = jicm.run(ds, jc), ticm.run(ds, tc, "cpu")
    assert r_t.map_pos.shape == r_j.map_pos.shape
    for f in ("x_init", "x", "map_pos"):
        assert_close(getattr(r_t, f), getattr(r_j, f), BAND)


def test_config_model_and_conversion():
    """A torch model is a config field; a JAX config with a model does not
    convert (its hooks are JAX code)."""
    tm = te.EnergyModel(**HOOKS["obs_scale"][1])
    assert TC(model=tm).model is tm
    with pytest.raises(ValueError, match="write them again in torch"):
        convert.config_to_torch(JC(model=je.EnergyModel()))
    with pytest.raises(TypeError, match="EnergyModel"):
        ticm.run(synthetic_world(T=20, n_landmarks=4, seed=0),
                 TC(model=je.EnergyModel()), "cpu")


def test_online_and_api_pass_the_model():
    """``api.run_online`` (OnlineSLAM's streamed causal init) and
    ``api.run_offline`` take the config's model as ``run`` does."""
    from icm_slam_tpu_torch import api
    from icm_slam_tpu_torch.data.datasets import Dataset
    from icm_slam_tpu_torch.runtime.replay import stream_dataset
    ds = synthetic_world(T=60, n_landmarks=8, seed=4)
    ds = Dataset(ds.scans, ds.odom, ds.u, ds.odom[0].copy(), ds.name)
    tm = te.EnergyModel(**HOOKS["obs_scale"][1], **HOOKS["extra_one_sided"][1])
    cfg = TC(N=0, L=256, cota=5.0, init_mode="sequential", model=tm)
    ref = ticm.run(ds, cfg, "cpu")
    onl = api.run_online(stream_dataset(ds), cfg, "cpu", refine=False)
    off = api.run_offline(ds, cfg, "cpu")
    assert onl.map_pos.shape == off.map_pos.shape == ref.map_pos.shape
    assert_close(onl.x_init, ref.x_init, 1e-5)
    assert_close(off.x_init, ref.x_init, 0.0)
    default = ticm.run(ds, dataclasses.replace(cfg, model=None), "cpu")
    assert np.abs(default.x_init - ref.x_init).max() > 1e-3
