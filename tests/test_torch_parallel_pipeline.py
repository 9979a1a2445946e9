"""The GPipe stage pipeline of the port's ``parallel/``, on three gloo CPU
ranks (spawned once for the module, ``tests/torch_dist_workers.py``):
``pipeline_stages`` on tests/test_pipeline.py's arithmetic pipeline
(exact), and ``pipelined_refine_pass`` at chunks of 16 and 64 against the
port's barrier sweep (``refine_sweep_batched``) and JAX's
``pipelined_refine_pass`` on three of its eight virtual devices, with
tests/test_pipeline.py's bands (poses 5e-4, map 1e-5, the census exact).
The world is ``synthetic_world(T=201, n_landmarks=12, seed=3)`` (the
reference's dataset that tests/test_pipeline.py slices is not in the
tree) after the port's init and map filter, ``map_run_cap=0``; it is
probed first: scaling JAX's odometry by 1 +- 1e-6 moves JAX's barrier
sweep by less than half the pose band.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from icm_slam_tpu.config import ICMConfig as JC
from icm_slam_tpu.core.energy import weights as jweights
from icm_slam_tpu.mapping.landmark_map import MapState as JMap
from icm_slam_tpu.parallel.pipeline import make_stage_mesh
from icm_slam_tpu.parallel.pipeline import \
    pipelined_refine_pass as jax_pipelined
from icm_slam_tpu.solver.sweeps import SweepData as JData
from icm_slam_tpu.solver.sweeps import refine_sweep_batched as jax_barrier
from icm_slam_tpu_torch import convert
from icm_slam_tpu_torch.core.energy import weights
from icm_slam_tpu_torch.solver.sweeps import refine_sweep_batched
from tests import torch_dist_workers as tw
from tests.torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return tw.spawn(tw.pipeline_worker, 3, tmp_path_factory.mktemp("pipe"))


@pytest.fixture(scope="module")
def inputs(one_thread):
    data, cur, x, cfg = tw.pipe_inputs()
    barrier = refine_sweep_batched(data, cur, x, cfg, weights(cfg, "cpu"))
    return dict(data=data, cur=cur, x=x, cfg=cfg, barrier=barrier)


def test_pipeline_stages_generic(ranks):
    expect = (np.arange(24, dtype=np.float32).reshape(6, 4) + 1.0) * 2.0 \
        - 3.0
    for o in ranks:
        np.testing.assert_array_equal(o["generic"], expect)


def _jax_inputs(inputs, scale=1.0):
    data = JData(*(jnp.asarray(a) for a in
                   convert.sweep_data_to_numpy(inputs["data"])))
    return (data._replace(odom=data.odom * scale),
            JMap(*(jnp.asarray(a.numpy()) for a in inputs["cur"])),
            jnp.asarray(inputs["x"].numpy()) * scale)


def test_inputs_have_a_map_and_are_not_rounding_sensitive(inputs):
    assert int(inputs["cur"].nact) > 0
    assert inputs["cfg"].map_run_cap == 0
    jc = JC(**convert.config_dict(inputs["cfg"]))
    w = jweights(jc)
    step = jax.jit(lambda d, m, xx: jax_barrier(d, m, xx, jc, w))
    x0 = np.asarray(step(*_jax_inputs(inputs))[1])
    for s in (1 + 1e-6, 1 - 1e-6):
        moved = np.abs(np.asarray(step(*_jax_inputs(inputs, s))[1]) - x0)
        assert moved.max() < 2.5e-4


@pytest.mark.parametrize("chunk", tw.PIPE_CHUNKS)
def test_pipelined_refine_matches_barrier(ranks, inputs, chunk):
    m_ref, x_ref = inputs["barrier"]
    for o in ranks:
        got = o[f"refine_{chunk}"]
        assert got["nact"] == int(m_ref.nact)
        np.testing.assert_allclose(got["x"], x_ref.numpy(), atol=5e-4)
        np.testing.assert_allclose(got["pos"], m_ref.pos.numpy(), atol=1e-5)
        for k in ("x", "pos", "counts"):
            assert np.array_equal(got[k], ranks[0][f"refine_{chunk}"][k])


@pytest.mark.parametrize("chunk", tw.PIPE_CHUNKS)
def test_pipelined_refine_matches_jax_pipelined(ranks, inputs, chunk):
    jc = JC(**convert.config_dict(inputs["cfg"]))
    w = jweights(jc)
    mesh = make_stage_mesh(3)
    m_j, x_j = jax.jit(lambda d, m, xx: jax_pipelined(
        d, m, xx, jc, w, mesh, chunk=chunk))(*_jax_inputs(inputs))
    got = ranks[2][f"refine_{chunk}"]
    assert got["nact"] == int(m_j.nact)
    np.testing.assert_allclose(got["x"], np.asarray(x_j), atol=5e-4)
    np.testing.assert_allclose(got["pos"], np.asarray(m_j.pos), atol=1e-5)
