"""Port parity: the batched LM against JAX ``vmap(lm_minimize)``.

JAX differentiates the residuals with ``jacfwd``; the port uses the
analytic Jacobians, which agree to rounding.  One LM step agrees to atol
1e-5.  After several steps each solve sits at its minimum, where the
float32 cost is flat to rounding over ~1e-4 in x: there the ``f_new < fx``
test of a near-tie step can go either way (measured: one of 24 problems
keeps a 4e-5 step in one package and rejects it in the other), so the
converged poses are held at atol 1e-4 and their energies at rtol 1e-5.
"""
import jax
import numpy as np
import pytest

from icm_slam_tpu.core import energy as je
from icm_slam_tpu.solver import gauss_newton as jgn
from icm_slam_tpu_torch.core import energy as te
from icm_slam_tpu_torch.solver import gauss_newton as tgn
from tests.torch_parity import (assert_close, jax_problem, jax_weights, jf32,
                                random_problems, tf32, torch_problem,
                                torch_weights)

ATOL = 1e-5


def test_solve3():
    rng = np.random.default_rng(0)
    M = rng.normal(size=(32, 3, 3))
    A = (M @ M.transpose(0, 2, 1) + 0.5 * np.eye(3)).astype(np.float32)
    b = rng.normal(size=(32, 3)).astype(np.float32)
    out_t = tgn._solve3(tf32(A), tf32(b))
    out_j = np.stack([np.asarray(jgn._solve3(jf32(A[i]), jf32(b[i])))
                      for i in range(32)])
    assert_close(out_t, out_j, ATOL, rtol=1e-5)


@pytest.mark.parametrize("two_sided", [False, True])
@pytest.mark.parametrize("iters", [1, 8])
def test_lm_batched_matches_jax_vmap(two_sided, iters):
    P, B = 24, 16
    fields, x0 = random_problems(P, B, seed=7 + iters, two_sided=two_sided)
    jw, tw = jax_weights(), torch_weights()
    res_j = je.two_sided_residuals if two_sided else je.one_sided_residuals
    res_t = te.two_sided_residuals if two_sided else te.one_sided_residuals
    jac_t = te.two_sided_jacobian if two_sided else te.one_sided_jacobian

    def solve(i):
        p = jax.tree.map(lambda f: f[i], jax_problem(fields, slice(None)))
        return jgn.lm_minimize(lambda xx: res_j(xx, p, jw), jf32(x0)[i],
                               iters=iters)

    x_j = jax.vmap(solve)(jax.numpy.arange(P))
    prob = torch_problem(fields)
    x_t = tgn.lm_minimize(lambda xx: res_t(xx, prob, tw),
                          lambda xx: jac_t(xx, prob, tw), tf32(x0),
                          iters=iters)
    assert_close(x_t, x_j, ATOL if iters == 1 else 1e-4)
    e_j = (res_t(tf32(np.asarray(x_j)), prob, tw) ** 2).sum(1)
    assert_close((res_t(x_t, prob, tw) ** 2).sum(1), e_j, 0.0, rtol=1e-5)
    # the solve lowered the energy of every problem
    e0 = (res_t(tf32(x0), prob, tw) ** 2).sum(1)
    e1 = (res_t(x_t, prob, tw) ** 2).sum(1)
    assert bool((e1 <= e0).all()) and bool((e1 < e0).any())
