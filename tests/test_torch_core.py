"""Port parity: core geometry, residuals and analytic Jacobians (atol 1e-5).

The Jacobians the port's LM uses are held against JAX ``jacfwd`` of the
JAX package's residuals, including the last frame's folded rows.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icm_slam_tpu.core import energy as je
from icm_slam_tpu.core import geometry as jg
from icm_slam_tpu_torch.core import energy as te
from icm_slam_tpu_torch.core import geometry as tg
from tests.torch_parity import (assert_close, assert_equal, jax_problem,
                                jax_weights, jf32, random_problems, tf32,
                                torch_problem, torch_weights)

ATOL = 1e-5


def test_wrap_angle_boundaries_and_multiples():
    pi = np.float32(np.pi)
    a = np.array([0.0, pi, -pi, 2 * pi, -2 * pi, 3 * pi, -3 * pi,
                  np.nextafter(pi, np.float32(4)), np.nextafter(-pi, 0),
                  100 * pi, -100 * pi, 1e4 + 0.3, -1e4 - 0.3, 1e6, -1e6,
                  0.5, -0.5], np.float32)
    out_j = np.asarray(jg.wrap_angle(jf32(a)))
    out_t = tg.wrap_angle(tf32(a)).numpy()
    assert_equal(out_t, out_j)
    assert (out_t > -np.pi - 1e-6).all() and (out_t <= np.pi + 1e-6).all()


def test_wrap_angle_random():
    a = np.random.default_rng(0).uniform(-50, 50, 4096).astype(np.float32)
    assert_equal(tg.wrap_angle(tf32(a)), jg.wrap_angle(jf32(a)))


def test_rot2_unicycle_beams():
    rng = np.random.default_rng(1)
    th = rng.uniform(-4, 4, 64).astype(np.float32)
    assert_close(tg.rot2(tf32(th)), jg.rot2(jf32(th)), ATOL)
    x = rng.uniform(-5, 5, (64, 3)).astype(np.float32)
    u = rng.uniform(-1, 1, (64, 2)).astype(np.float32)
    assert_close(tg.unicycle_step(tf32(x), tf32(u), 0.1),
                 jg.unicycle_step(jf32(x), jf32(u), 0.1), ATOL)
    assert_close(tg.beam_angles(181), jg.beam_angles(181), 0.0)
    dist = rng.uniform(0, 10, (64, 181)).astype(np.float32)
    ang = np.asarray(jg.beam_angles(181))
    assert_close(tg.beams_to_world(tf32(x), tf32(dist), tf32(ang)),
                 jg.beams_to_world(jf32(x), jf32(dist), jf32(ang)), ATOL)


@pytest.mark.parametrize("two_sided", [False, True])
def test_residuals(two_sided):
    P, B = 6, 16
    fields, x = random_problems(P, B, seed=3, two_sided=two_sided)
    jw, tw = jax_weights(), torch_weights()
    fn_j = je.two_sided_residuals if two_sided else je.one_sided_residuals
    fn_t = te.two_sided_residuals if two_sided else te.one_sided_residuals
    r_t = fn_t(tf32(x), torch_problem(fields), tw)
    r_j = np.stack([np.asarray(fn_j(jf32(x[i]), jax_problem(fields, i), jw))
                    for i in range(P)])
    assert r_t.shape == (P, (12 if two_sided else 6) + 2 * B)
    assert_close(r_t, r_j, ATOL)
    o_t = te.obs_residuals(tf32(x), torch_problem(fields), tw[1])
    o_j = np.stack([np.asarray(je.obs_residuals(jf32(x[i]),
                                                jax_problem(fields, i),
                                                jw[1])) for i in range(P)])
    assert_close(o_t, o_j, ATOL)


@pytest.mark.parametrize("two_sided", [False, True])
def test_analytic_jacobian_matches_jacfwd(two_sided):
    P, B = 6, 16
    fields, x = random_problems(P, B, seed=4, two_sided=two_sided)
    jw, tw = jax_weights(), torch_weights()
    fn_j = je.two_sided_residuals if two_sided else je.one_sided_residuals
    jac_t = te.two_sided_jacobian if two_sided else te.one_sided_jacobian
    J_t = jac_t(tf32(x), torch_problem(fields), tw)
    J_j = np.stack([np.asarray(jax.jacfwd(
        lambda xx, p=jax_problem(fields, i): fn_j(xx, p, jw))(jf32(x[i])))
        for i in range(P)])
    assert J_t.shape == J_j.shape
    assert_close(J_t, J_j, ATOL)


def test_folded_last_frame_rows():
    """The folded last frame: 6 forward rows zeroed in r and J leave the
    one-sided system (sweeps._solve_two_at in both packages)."""
    P, B = 4, 12
    fields, x = random_problems(P, B, seed=5)
    jw, tw = jax_weights(), torch_weights()
    m = 12 + 2 * B
    head = jnp.arange(m) < 6

    def folded(xx, p):
        return jnp.where(head, 0.0, je.two_sided_residuals(xx, p, jw))

    J_j = np.stack([np.asarray(jax.jacfwd(folded)(jf32(x[i]),
                                                  jax_problem(fields, i)))
                    for i in range(P)])
    r_j = np.stack([np.asarray(folded(jf32(x[i]), jax_problem(fields, i)))
                    for i in range(P)])
    prob = torch_problem(fields)
    fold = torch.arange(m) < 6
    J_t = torch.where(fold[:, None], 0.0,
                      te.two_sided_jacobian(tf32(x), prob, tw))
    r_t = torch.where(fold, 0.0, te.two_sided_residuals(tf32(x), prob, tw))
    assert_close(J_t, J_j, ATOL)
    assert_close(r_t, r_j, ATOL)
    # the remaining rows are the one-sided system exactly
    assert_close(r_t[:, 6:], te.one_sided_residuals(tf32(x), prob, tw), 0.0)


def test_weights():
    from icm_slam_tpu.config import ICMConfig as JC
    from icm_slam_tpu_torch.config import ICMConfig as TC
    kw = dict(R=(1.0, 4.0, 9.0), Q=(2.0, 3.0), cte_odom=0.25, deltat=0.2)
    w_j = je.weights(JC(**kw))
    w_t = te.weights(TC(**kw))
    for a, b in zip(w_t[:3], w_j[:3]):
        assert_close(a, b, 0.0)
    assert w_t[3] == w_j[3] == 0.2
    assert math.isclose(float(w_t[2]), 0.5)


def test_config_yaml_and_conversion(tmp_path):
    from icm_slam_tpu.config import ICMConfig as JC
    from icm_slam_tpu_torch import convert
    from icm_slam_tpu_torch.config import ICMConfig as TC
    path = tmp_path / "cfg.yaml"
    path.write_text("D:\n  N: 7\n  Q: [2, 3]\n  cota: 11\n"
                    "  topic_laser: /scan\n  use_pallas_assoc: true\n")
    t = TC.from_yaml(str(path), L=512)
    j = JC.from_yaml(str(path), L=512)
    assert (t.N, t.Q, t.cota, t.L) == (7, (2.0, 3.0), 11, 512)
    assert convert.config_to_torch(j) == t
    assert "use_pallas_assoc" not in convert.config_dict(j)
