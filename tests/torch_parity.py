"""Shared helpers of the parity tests between icm_slam_tpu (JAX) and
icm_slam_tpu_torch (PyTorch), both on the CPU.

Inputs are made with NumPy from a seed and handed to both packages as
float32 (tests/conftest.py turns on jax_enable_x64, so every JAX input is
cast explicitly).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch


def jf32(a):
    return jnp.asarray(np.asarray(a, np.float32))


def tf32(a):
    return torch.from_numpy(np.array(a, np.float32))


def np_of(a):
    """NumPy view of a JAX array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def assert_close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np_of(a), np_of(b), atol=atol, rtol=rtol)


def assert_equal(a, b):
    np.testing.assert_array_equal(np_of(a), np_of(b))


def random_problems(P, B, seed, two_sided=True):
    """P random pose problems near a consistent configuration, as float32
    NumPy fields (PoseProblem order) plus a start pose (P, 3)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x_prev = np.concatenate([rng.uniform(-5, 5, (P, 2)),
                             rng.uniform(-np.pi, np.pi, (P, 1))], 1)
    u_prev = np.stack([rng.uniform(0.5, 1.5, P), rng.uniform(-0.3, 0.3, P)],
                      1)
    x = x_prev + 0.1 * np.stack([u_prev[:, 0] * np.cos(x_prev[:, 2]),
                                 u_prev[:, 0] * np.sin(x_prev[:, 2]),
                                 u_prev[:, 1]], 1)
    u_cur = np.stack([rng.uniform(0.5, 1.5, P), rng.uniform(-0.3, 0.3, P)],
                     1)
    x_next = x + 0.1 * np.stack([u_cur[:, 0] * np.cos(x[:, 2]),
                                 u_cur[:, 0] * np.sin(x[:, 2]),
                                 u_cur[:, 1]], 1)
    odo_prev = x_prev + rng.normal(0, 0.02, (P, 3))
    odo_cur = x + rng.normal(0, 0.02, (P, 3))
    odo_next = x_next + rng.normal(0, 0.02, (P, 3))
    dist = rng.uniform(1.0, 9.0, (P, B))
    ang = np.sort(rng.uniform(0, np.pi, (P, B)), axis=1)
    mask = rng.uniform(size=(P, B)) < 0.8
    a = ang + x[:, 2:3] - np.pi / 2
    pts = x[:, None, :2] + dist[..., None] * np.stack([np.cos(a), np.sin(a)],
                                                      -1)
    matched = pts + rng.normal(0, 0.05, (P, B, 2))
    if not two_sided:
        x_next = np.zeros_like(x_next)
        u_cur = np.zeros_like(u_cur)
        odo_next = np.zeros_like(odo_next)
    fields = [dist, ang, mask, matched, x_prev, u_prev, odo_prev, odo_cur,
              x_next, u_cur, odo_next]
    fields = [m if m.dtype == bool else m.astype(f) for m in fields]
    x_start = (x + rng.normal(0, 0.05, (P, 3))).astype(f)
    return fields, x_start


def jax_problem(fields, i):
    """Problem ``i`` of random_problems as a JAX PoseProblem."""
    from icm_slam_tpu.core.energy import PoseProblem
    return PoseProblem(*[jnp.asarray(f[i]) for f in fields])


def torch_problem(fields):
    from icm_slam_tpu_torch.core.energy import PoseProblem
    return PoseProblem(*[torch.as_tensor(f) for f in fields])


def jax_weights(R=(1.0, 2.0, 0.5), Q=(1.5, 0.7), cte=0.8, deltat=0.1):
    f = jnp.float32
    return (jnp.sqrt(jnp.asarray(R, f)), jnp.sqrt(jnp.asarray(Q, f)),
            jnp.sqrt(jnp.asarray(cte, f)), deltat)


def torch_weights(R=(1.0, 2.0, 0.5), Q=(1.5, 0.7), cte=0.8, deltat=0.1):
    f = torch.float32
    return (torch.sqrt(torch.tensor(R, dtype=f)),
            torch.sqrt(torch.tensor(Q, dtype=f)),
            torch.sqrt(torch.tensor(cte, dtype=f)), deltat)


@pytest.fixture(scope="module")
def one_thread():
    """One CPU thread for a module of small worlds: their ops are
    thousands of elements, where torch's threads cost more than they
    share (the results are the same)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
