"""K4 (``ops.pose_lm``): its plain version against JAX, and the sweeps'
dispatch and the batched init's chunk loop against the routes they
replace, on the CPU.

The plain version is held against JAX's ``vmap(lm_minimize)`` with the
analytic Jacobians as ``jac_fn`` (JAX's default-model Jacobians, folded
like the residuals where the problem is folded): one-sided, two-sided and
folded, with masked beams, all-masked problems and starts at a heading
near +-pi, to atol 1e-5 in the poses: in float32 after one LM step, in
float64 after one and after eight.  After several float32 steps a solve
sits where its cost is flat to rounding, and a step that ties to rounding
is taken in one package and not in the other (measured on these problems:
up to 3 of 48 poses 1e-5 to 3.6e-4 apart after 8 steps, their costs
within 1.4e-5 relative; tests/test_torch_gauss_newton.py): in float64 the
same algorithm has no such ties at that scale.  On a CPU tensor
``pose_lm`` is the plain version and counts no launch.  The sweeps' call
sites, which go through ``sweeps._pose_solve``, give bitwise what the
plain ``lm_minimize`` on the residual and Jacobian builders gives
(computed here), for the default model and for a model's hooks; so does
the batched init's chunk loop against a loop over chunk slices, and its
step reads nothing back to the host.  The kernel itself runs only on a
GPU (tests/test_torch_kernels_cuda.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icm_slam_tpu.core import energy as je
from icm_slam_tpu.solver import gauss_newton as jgn
from icm_slam_tpu_torch.config import ICMConfig
from icm_slam_tpu_torch.core import energy as te
from icm_slam_tpu_torch.data.datasets import synthetic_world
from icm_slam_tpu_torch.ops import _build
from icm_slam_tpu_torch.ops import pose_lm as k4
from icm_slam_tpu_torch.solver import icm as ticm
from icm_slam_tpu_torch.solver import sweeps as tsw
from icm_slam_tpu_torch.solver.gauss_newton import lm_minimize
from tests.torch_parity import (assert_close, jax_weights, random_problems,
                                tf32, torch_problem, torch_weights)
from tests.torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ATOL = 1e-5


def _problems(P, B, seed, two_sided, near_pi=False, empty=()):
    """random_problems with every fifth beam masked, the problems
    ``empty`` all masked and, with ``near_pi``, every heading within 1e-3
    of +-pi (the odometry and the start alike)."""
    fields, x0 = random_problems(P, B, seed=seed, two_sided=two_sided)
    fields[2] = fields[2] & (np.arange(B) % 5 != 4)
    fields[2][list(empty)] = False
    if near_pi:
        rng = np.random.default_rng(seed + 1)
        side = np.where(rng.uniform(size=P) < 0.5, -1.0, 1.0)
        th = (side * (np.pi - rng.uniform(0, 1e-3, P))).astype(np.float32)
        for i in (4, 6, 7, 8, 10):            # x_prev ... odo_next
            if two_sided or i < 8:
                fields[i][:, 2] = th
        x0[:, 2] = -th                         # across the cut
    return fields, x0


def _weights(dtype):
    """``torch_parity``'s weights as (JAX's, the port's) in ``dtype``."""
    if dtype == np.float32:
        return jax_weights(), torch_weights()
    jw = tuple(jnp.asarray(a, jnp.float64) for a in jax_weights()[:3])
    tw = tuple(a.double() for a in torch_weights()[:3])
    return jw + (0.1,), tw + (0.1,)


def _jax_lm(fields, x0, two_sided, fold, iters, jw):
    res = je.two_sided_residuals if two_sided else je.one_sided_residuals
    jac = je.two_sided_jacobian if two_sided else je.one_sided_jacobian
    f32 = [jnp.asarray(f) for f in fields]

    def solve(i):
        p = je.PoseProblem(*[f[i] for f in f32])
        if fold is None:
            fr = fj = lambda v: v
        else:
            def fr(v):
                rows = fold[i] & (jnp.arange(v.shape[0]) < 6)
                return jnp.where(rows.reshape((-1,) + (1,) * (v.ndim - 1)),
                                 0.0, v)
            fj = fr
        return jgn.lm_minimize(lambda xx: fr(res(xx, p, jw)),
                               jnp.asarray(x0)[i], iters=iters,
                               jac_fn=lambda xx: fj(jac(xx, p, jw)))
    return np.asarray(jax.vmap(solve)(jnp.arange(x0.shape[0])))


CASES = [  # (two_sided, fold, near_pi)
    (False, False, False), (True, False, False), (True, True, False),
    (False, False, True), (True, False, True), (True, True, True)]


@pytest.mark.parametrize("dtype,iters", [(np.float32, 1), (np.float64, 1),
                                         (np.float64, 8)])
@pytest.mark.parametrize("two_sided,fold,near_pi", CASES)
def test_plain_matches_jax_lm(two_sided, fold, near_pi, dtype, iters):
    P, B = 48, 24
    fields, x0 = _problems(P, B, seed=11 + iters, two_sided=two_sided,
                           near_pi=near_pi, empty=(3, 17))
    fields = [f if f.dtype == bool else f.astype(dtype) for f in fields]
    x0 = x0.astype(dtype)
    fd = (np.arange(P) % 4 == 1) if fold else None
    jw, tw = _weights(dtype)
    x_j = _jax_lm(fields, x0, two_sided, None if fd is None
                  else jnp.asarray(fd), iters, jw)
    x_t = k4.pose_lm_plain(torch_problem(fields), torch.from_numpy(x0), tw,
                           iters, two_sided,
                           None if fd is None else torch.from_numpy(fd))
    assert x_t.dtype == torch.from_numpy(x0).dtype
    assert_close(x_t, x_j, ATOL)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    fields, x0 = _problems(16, 12, seed=3, two_sided=True, empty=(5,))
    prob, w = torch_problem(fields), torch_weights()
    fold = torch.arange(16) % 3 == 0
    before = dict(_build.LAUNCHES)
    out = k4.pose_lm(prob, tf32(x0), w, 8, True, fold)
    assert dict(_build.LAUNCHES) == before
    assert torch.equal(out, k4.pose_lm_plain(prob, tf32(x0), w, 8, True,
                                             fold))


def test_folded_problem_is_the_one_sided_problem():
    """Zeroing the 6 forward rows leaves the one-sided system exactly."""
    fields, x0 = _problems(12, 10, seed=4, two_sided=True)
    prob, w = torch_problem(fields), torch_weights()
    folded = k4.pose_lm_plain(prob, tf32(x0), w, 8, True,
                              torch.ones(12, dtype=torch.bool))
    one = k4.pose_lm_plain(prob, tf32(x0), w, 8, False)
    assert_close(folded, one, 1e-6)


def test_wrapper_refuses_other_devices():
    fields, x0 = _problems(2, 4, seed=5, two_sided=False)
    prob = te.PoseProblem(*[torch.as_tensor(f).to("meta") for f in fields])
    with pytest.raises(ValueError, match="unsupported device"):
        k4.pose_lm(prob, tf32(x0).to("meta"), torch_weights(), 8, False)


@pytest.mark.parametrize("P,B,two_sided,want", [
    (916, 48, True, (1856, 0, 32, 1, 1)), (32, 48, False, (1760, 0, 32, 1, 1)),
    (8, 48, False, (1888, 0, 64, 1, 1)), (1, 181, False, (15104, 1, 64, 256, 64)),
    (1, 181, True, (15200, 1, 64, 256, 64)), (8, 181, True, (7136, 1, 64, 32, 16)),
    (64, 300, True, (10368, 1, 32, 16, 16)), (5, 0, False, (132, 0, 4, 1, 1)),
    (0, 48, True, (1984, 0, 64, 1, 1))])
def test_launch_plan(P, B, two_sided, want):
    """A block a problem; its sums in the order torch's CUDA reduction
    takes at that (P, m) (held against torch's own sums on the card)."""
    assert tuple(k4.launch_plan(P, B, two_sided)) == want


def test_launch_plan_refuses_what_it_does_not_model():
    with pytest.raises(ValueError, match="shared memory"):
        k4.launch_plan(64, 2000, True)
    with pytest.raises(ValueError, match="not modelled"):
        k4.reduce_plan(1, 70000, 3)


# ---------------------------------------------------------------------------
# the sweeps' call sites against the plain lm_minimize route
# ---------------------------------------------------------------------------

def _lm_route(prob, x0, w, config, two_sided, fold=None, iters=None):
    """The plain route: ``lm_minimize`` on the config's model's residual
    and Jacobian builders, the folded rows zeroed."""
    model = tsw._model_of(config)
    res = te.two_sided_residuals if two_sided else te.one_sided_residuals
    jac = te.two_sided_jacobian if two_sided else te.one_sided_jacobian

    def rows(v):
        if fold is None:
            return v
        keep = fold[:, None] & (torch.arange(v.shape[1]) < 6)
        return torch.where(keep.view(keep.shape + (1,) * (v.dim() - 2)),
                           0.0, v)
    return lm_minimize(lambda xx: rows(res(xx, prob, w, model)),
                       lambda xx: rows(jac(xx, prob, w, model)), x0,
                       iters=config.pose_gn_iters if iters is None
                       else iters)


def _hooks():
    return te.EnergyModel(
        obs_scale=lambda d, a: 1.0 / (1.0 + d),
        extra_one_sided=lambda x, p: 5.0 * (x[:, :2] - p.odo_cur[:, :2]))


@pytest.fixture(scope="module")
def small():
    ds = synthetic_world(T=96, n_landmarks=10, seed=7)
    cfg = ICMConfig(L=256, cota=5.0, N=1, init_chunk_len=16)
    data = ticm.prepare(ds, cfg, "cpu")
    cfg = ticm.resolve_config(cfg, data)
    x0 = torch.as_tensor(ds.x0, dtype=torch.float32)
    seed = ticm.seed_map(data, x0, cfg)
    w = te.weights(cfg, "cpu")
    state, x, _ = tsw.init_sweep_batched(data, seed, x0, cfg, w)
    return dict(data=data, cfg=cfg, x0=x0, seed=seed, w=w, x=x,
                map=ticm.filter_map(state, cfg.cota, cfg.dist_thr))


def _obs(small, W=1):
    data_c = tsw.compact_data(small["data"], small["cfg"].obs_cap)
    x = small["x"]
    _, _, matched = tsw.batched_associate(data_c, small["map"], x,
                                          small["cfg"])
    data_w = tsw.with_world_axis(data_c)
    obs = tuple(a[None] for a in (data_c.dist, data_c.ang, data_c.mask,
                                  matched))
    if W > 1:
        data_w = type(data_w)(*(a.repeat((W,) + (1,) * (a.dim() - 1))
                                for a in data_w))
        obs = tuple(a.repeat((W,) + (1,) * (a.dim() - 1)) for a in obs)
        x = x[None].repeat(W, 1, 1) + 1e-3 * torch.arange(W)[:, None, None]
    else:
        x = x[None]
    return data_w, obs, x


@pytest.mark.parametrize("model", [None, "hooks"])
@pytest.mark.parametrize("W", [1, 2])
@pytest.mark.parametrize("folded", [False, True])
def test_solve_two_at_equals_lm_route(small, model, W, folded):
    cfg = dataclasses.replace(small["cfg"],
                              model=_hooks() if model else None)
    data, obs, x = _obs(small, W)
    T = x.shape[1]
    ts = torch.arange(2 - (T - 1) % 2, T, 2)     # the parity of T - 1
    last_t = T - 1 if folded else None
    got = tsw._solve_two_at(data, x, obs, cfg, small["w"], ts, last_t)

    def at(a, i):
        return tsw._flat(a[:, i])
    tm1, tp1 = torch.clamp(ts - 1, min=0), torch.clamp(ts + 1, max=T - 1)
    prob = te.PoseProblem(
        dist=at(obs[0], ts), ang=at(obs[1], ts), mask=at(obs[2], ts),
        matched=at(obs[3], ts), x_prev=at(x, tm1), u_prev=at(data.u, tm1),
        odo_prev=at(data.odom, tm1), odo_cur=at(data.odom, ts),
        x_next=at(x, tp1), u_cur=at(data.u, ts),
        odo_next=at(data.odom, tp1))
    x_init = (prob.x_prev + prob.x_next) / 2.0
    fold = None
    if folded:
        fold = (ts == last_t).repeat(W)
        assert bool(fold.any())
        x_init = torch.where(fold[:, None], tsw._model_of(cfg).kinematics(
            prob.x_prev, prob.u_prev, cfg.deltat), x_init)
    want = _lm_route(prob, x_init, small["w"], cfg, True, fold)
    assert torch.equal(got, want.view(W, -1, 3))


@pytest.mark.parametrize("model", [None, "hooks"])
@pytest.mark.parametrize("W", [1, 3])
def test_solve_one_at_equals_lm_route(small, model, W):
    cfg = dataclasses.replace(small["cfg"],
                              model=_hooks() if model else None)
    data, obs, x = _obs(small, W)
    t = x.shape[1] - 1
    got = tsw._solve_one_at(data, x, obs, cfg, small["w"], t)
    z3 = torch.zeros((W, 3))
    prob = te.PoseProblem(
        dist=obs[0][:, t], ang=obs[1][:, t], mask=obs[2][:, t],
        matched=obs[3][:, t], x_prev=x[:, t - 1], u_prev=data.u[:, t - 1],
        odo_prev=data.odom[:, t - 1], odo_cur=data.odom[:, t], x_next=z3,
        u_cur=z3[:, :2], odo_next=z3)
    x_init = tsw._model_of(cfg).kinematics(x[:, t - 1], data.u[:, t - 1],
                                           cfg.deltat)
    assert torch.equal(got, _lm_route(prob, x_init, small["w"], cfg, False))


@pytest.fixture
def lm_route(monkeypatch):
    """``sweeps._pose_solve`` replaced by the plain lm_minimize route."""
    monkeypatch.setattr(tsw, "_pose_solve", _lm_route)


@pytest.mark.parametrize("obs_cap", [0, 16])
def test_causal_step_equals_lm_route(small, obs_cap, monkeypatch):
    cfg = dataclasses.replace(small["cfg"], obs_cap=obs_cap)
    data = tsw._per_frame_ang(small["data"])
    outs = []
    for route in ("k4", "lm"):
        if route == "lm":
            monkeypatch.setattr(tsw, "_pose_solve", _lm_route)
        state, xt = small["seed"], small["x0"]
        for t in range(1, 12):
            frame = (data.dist[t], data.mask[t], data.ang[t], data.u[t - 1],
                     data.odom[t - 1], data.odom[t])
            state, xt = tsw._causal_step(state, xt, frame, cfg, small["w"])
        outs.append((state, xt))
    (s1, x1), (s2, x2) = outs
    assert torch.equal(x1, x2)
    assert all(torch.equal(a, b) for a, b in zip(s1, s2))


def _init_by_slices(data, seed, x0, config, w):
    """The batched init as a plain loop over the chunks' slices, the
    poses concatenated, then the merge."""
    run = tsw.BatchedInit(data, seed, x0, config, w)
    carry, xs = run.start[0], []
    for ci in range(run.nc):
        inp = tsw._InitChunk(*(a[:, ci] for a in run.chunks))
        carry, x = tsw._init_chunk(inp, carry, config, w)
        xs.append(x)
    run.xs.copy_(torch.stack(xs, dim=1))
    return run.finish(carry)


@pytest.mark.parametrize("fleet", [False, True])
def test_init_loop_equals_chunk_slices_and_lm_route(small, fleet,
                                                       monkeypatch):
    data, seed, x0 = small["data"], small["seed"], small["x0"]
    cfg, w = small["cfg"], small["w"]
    if fleet:
        data, seed = (tsw.with_world_axis(data), tsw.with_world_axis(seed))
        data = type(data)(*(a.repeat((2,) + (1,) * (a.dim() - 1))
                            for a in data))
        seed = type(seed)(*(a.repeat((2,) + (1,) * (a.dim() - 1))
                            for a in seed))
        x0 = x0[None].repeat(2, 1) + torch.tensor([[0.0, 0.0, 0.0],
                                                   [0.02, -0.01, 0.001]])
    timings = {}
    got = tsw.init_sweep_batched(data, seed, x0, cfg, w, timings)
    assert timings == {"init_capture_s": 0.0}
    monkeypatch.setattr(tsw, "_pose_solve", _lm_route)
    if not fleet:
        data, seed, x0 = (tsw.with_world_axis(data),
                          tsw.with_world_axis(seed), x0[None])
    want = _init_by_slices(data, seed, x0, cfg, w)
    if not fleet:
        want = (tsw.world(want[0]), want[1][0], want[2][0])
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_init_step_reads_nothing_back(small, no_host_read):
    cfg = small["cfg"]
    run = tsw.BatchedInit(tsw.with_world_axis(small["data"]),
                          tsw.with_world_axis(small["seed"]),
                          small["x0"][None], cfg, small["w"])
    state = run.start
    with no_host_read():
        for _ in range(2):
            state = run.step(*state)
    assert int(state[1]) == 2


@pytest.fixture
def no_host_read(monkeypatch):
    from tests.test_torch_relabel import _NoHostRead

    def refuse(self, *a, **k):
        raise AssertionError("host read")
    monkeypatch.setattr(torch.Tensor, "numpy", refuse)
    monkeypatch.setattr(torch.Tensor, "tolist", refuse)
    return _NoHostRead
