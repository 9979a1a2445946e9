"""The port's main path end to end against icm_slam_tpu.solver.icm.run, and
the port's boundaries: no JAX (and no PyYAML) import, ``models/``, fleet
mode and the live transport (``runtime/ingest``, ``runtime/
fake_rosbridge``) included, no CPU fallback for a CUDA device, TypeError
on a model that is not the port's, chip_smoke.py failing without a GPU.

The world resolves to obs_cap=16, map_run_cap=128 < L=256: the capped
branch, which JAX runs through its fused association kernel with
``use_pallas_fused_assoc=True``.  Tolerances: census exact; map, x_init,
x and map changes atol 1e-3 (the band JAX itself needs between fusion
orders).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from icm_slam_tpu.config import ICMConfig as JC
from icm_slam_tpu.data.datasets import synthetic_world
from icm_slam_tpu.solver import icm as jicm
from icm_slam_tpu_torch import convert
from icm_slam_tpu_torch.config import ICMConfig as TC
from icm_slam_tpu_torch.solver import icm as ticm
from tests.torch_parity import assert_close
from tests.torch_parity import one_thread  # noqa: F401

# one CPU thread: these small worlds run 2-3x faster without threads
pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def runs():
    ds = synthetic_world(T=240, n_landmarks=12, seed=7)
    jc = JC(L=256, cota=20.0, N=3, use_pallas_fused_assoc=True)
    resolved = jicm.resolve_config(jc, jicm.prepare(ds, jc))
    tc = convert.config_to_torch(jc)
    return dict(ds=ds, resolved=resolved, jax=jicm.run(ds, jc),
                port=ticm.run(ds, tc, "cpu"), tc=tc)


def test_resolves_to_capped_branch(runs):
    r = runs["resolved"]
    assert (r.obs_cap, r.map_run_cap) == (16, 128)
    t = ticm.resolve_config(runs["tc"],
                            ticm.prepare(runs["ds"], runs["tc"], "cpu"))
    assert (t.obs_cap, t.map_run_cap) == (16, 128)


def test_census_exact(runs):
    j, p = runs["jax"], runs["port"]
    assert p.map_pos.shape == j.map_pos.shape
    assert j.map_pos.shape[0] == 5
    np.testing.assert_array_equal(p.map_counts, j.map_counts)


@pytest.mark.parametrize("field", ["x_init", "x", "map_pos", "changes"])
def test_outputs_within_band(runs, field):
    a, b = getattr(runs["port"], field), getattr(runs["jax"], field)
    assert a.shape == b.shape
    assert np.isfinite(a).all()
    assert_close(a, b, 1e-3)


def test_timings_callback_verbose(capsys):
    ds = synthetic_world(T=80, n_landmarks=8, seed=1)
    seen = []
    res = ticm.run(ds, TC(L=256, cota=5.0, N=2), "cpu", verbose=True,
                   callback=lambda k, m, x: seen.append((k, x.shape)))
    assert seen == [(0, (80, 3)), (1, (80, 3))]
    assert capsys.readouterr().out.count("[icm] iter") == 2
    assert res.changes.shape == (2, 3)
    for k in ("prepare_s", "init_s", "hoist_s", "refine_s",
              "refine_per_iter_s"):
        assert res.timings[k] >= 0.0
    res0 = ticm.run(ds, TC(L=256, cota=5.0), "cpu", n_iters=0)
    assert res0.changes.shape == (0, 3)
    np.testing.assert_array_equal(res0.x, res0.x_init)


@pytest.mark.parametrize("kw", [
    dict(model=object()), dict(sweep_mode="sequential"),
    dict(replicate_new_obs_quirk=False), dict(init_mode="sequential"),
    dict(pose_update="jacobi"), dict(sweep_mode="ba"),
    dict(sweep_mode="windowed_ba")])
def test_unported_configs_raise(kw):
    """A model that is not the port's EnergyModel raises TypeError; every
    other configuration, the BA sweep modes included, runs one sweep."""
    ds = synthetic_world(T=20, n_landmarks=4, seed=0)
    cfg = TC(L=256, N=1, **kw)
    if "model" in kw:
        with pytest.raises(TypeError):
            ticm.run(ds, cfg, "cpu")
        return
    ticm.check_supported(cfg)
    res = ticm.run(ds, cfg, "cpu")
    assert res.x.shape == res.x_init.shape == (20, 3)
    assert res.changes.shape == (1, 3)
    assert res.map_pos.shape == (res.map_counts.shape[0], 2)
    for a in (res.x, res.x_init, res.map_pos, res.changes):
        assert np.isfinite(a).all()


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-fallback case needs none")
    ds = synthetic_world(T=20, n_landmarks=4, seed=0)
    with pytest.raises((RuntimeError, AssertionError)):
        ticm.run(ds, TC(L=256, N=1), "cuda")


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import icm_slam_tpu_torch as p\n"
        "sys.modules['yaml'] = None\n"
        "import icm_slam_tpu_torch.solver.icm\n"
        "import icm_slam_tpu_torch.api, icm_slam_tpu_torch.cli\n"
        "import icm_slam_tpu_torch.runtime.online\n"
        "import icm_slam_tpu_torch.runtime.replay\n"
        "import icm_slam_tpu_torch.runtime.ingest\n"
        "import icm_slam_tpu_torch.runtime.fake_rosbridge\n"
        "import icm_slam_tpu_torch.utils.checkpoint\n"
        "import icm_slam_tpu_torch.utils.export\n"
        "import icm_slam_tpu_torch.utils.metrics\n"
        "import icm_slam_tpu_torch.models.bundle_adjustment\n"
        "import icm_slam_tpu_torch.models.windowed_ba\n"
        "import icm_slam_tpu_torch.models.loop_closure\n"
        "import icm_slam_tpu_torch.models.pose_graph\n"
        "import icm_slam_tpu_torch.parallel.distributed\n"
        "import icm_slam_tpu_torch.parallel.mesh\n"
        "import icm_slam_tpu_torch.parallel.pipeline\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "p.ICMConfig.from_yaml('configs/reference.yaml')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.split('.')[0] == 'icm_slam_tpu']\n"
        "assert not bad, bad\n"
        "assert 'icm_slam_tpu_torch.models.loop_closure' in sys.modules\n"
        "assert 'icm_slam_tpu_torch.runtime.ingest' in sys.modules\n"
        "assert {'icm_slam_tpu_torch.parallel.' + m for m in"
        " ('distributed', 'mesh', 'pipeline')} <= set(sys.modules)\n"
        "from icm_slam_tpu_torch.solver.icm import run_batched\n"
        "from icm_slam_tpu_torch.api import run_batched as api_rb\n"
        "assert api_rb is run_batched\n"
        "print('ok', len([m for m in sys.modules"
        " if m.startswith('icm_slam_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = _smoke(REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    out = _smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
