"""The port's user entry points and their host-side pieces, against the JAX
package on the CPU: the YAML reader, the config fields and resolution,
dataset loading, the NumPy utils (bitwise), the online engine, the
offline API with checkpoint/resume, and the CLI.

Tolerances: the NumPy copies and the CPU runs of one package against
itself bitwise; the port against JAX census exact, poses and map atol
1e-3 (tests/test_torch_sequential.py explains the band).
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from icm_slam_tpu.config import ICMConfig as JC
from icm_slam_tpu.data import datasets as jds
from icm_slam_tpu.runtime.online import OnlineSLAM as JOnline
from icm_slam_tpu.solver import icm as jicm
from icm_slam_tpu.utils import checkpoint as jckpt
from icm_slam_tpu.utils import export as jexport
from icm_slam_tpu.utils import metrics as jmetrics
from icm_slam_tpu_torch import api, cli, convert
from icm_slam_tpu_torch.config import ICMConfig as TC
from icm_slam_tpu_torch.config import read_yaml
from icm_slam_tpu_torch.core.energy import weights as tweights
from icm_slam_tpu_torch.data import datasets as tds
from icm_slam_tpu_torch.runtime.online import OnlineSLAM
from icm_slam_tpu_torch.runtime.replay import stream_dataset
from icm_slam_tpu_torch.solver import icm as ticm
from icm_slam_tpu_torch.solver import sweeps as tsw
from icm_slam_tpu_torch.utils import checkpoint as tckpt
from icm_slam_tpu_torch.utils import export as texport
from icm_slam_tpu_torch.utils import metrics as tmetrics
from tests.torch_parity import assert_close
from tests.torch_parity import one_thread  # noqa: F401

# one CPU thread: these small worlds run 2-3x faster without threads
pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAND = 1e-3

_STYLE_FILE = """\
# reference-style file with the forms the reader accepts
D:
    N: 3   # trailing comment
    deltat: 0.05
    Q: [1.5, 2]
    R: [1, 1, 1.0e-3]
    file: 'it''s.mat'
    topic: "/a#b"
    topic_laser: /scan_raw.v-2
    sweep_mode: sequential
    replicate_new_obs_quirk: false
    obs_cap: 0
    cota: -2
    L: +1024
    dist_thr: 1.
    empty: []
top: 7
"""


# --- R1: the YAML reader -----------------------------------------------------

@pytest.mark.parametrize("name", ["reference.yaml", "fast.yaml", "style"])
def test_read_yaml_matches_pyyaml(name, tmp_path):
    if name == "style":
        path = tmp_path / "style.yaml"
        path.write_text(_STYLE_FILE)
    else:
        path = os.path.join(REPO, "configs", name)
    mine, ref = read_yaml(str(path)), yaml.safe_load(open(path))
    assert mine == ref
    typed = lambda d: {k: (type(v), v) for k, v in d["D"].items()}
    assert typed(mine) == typed(ref)


def test_from_yaml_without_pyyaml(monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)     # import yaml fails
    for name in ("reference.yaml", "fast.yaml"):
        path = os.path.join(REPO, "configs", name)
        got = TC.from_yaml(path, N=4)
        assert got == convert.config_to_torch(JC.from_yaml(path, N=4))


@pytest.mark.parametrize("text", [
    "D:\n    a:\n        b: 1\n",        # deeper nesting
    "D:\n    a: 1_024\n", "D:\n    a: 0x5a\n", "D:\n    a: 017\n",
    "D:\n    a: 1e-3\n", "D:\n    a: .5\n", "D:\n    a: .inf\n",
    "D:\n    a: ~\n", "D:\n    a: null\n", "D:\n    a: yes\n",
    "D:\n    a: True\n", "D:\n    a: [1, [2]]\n", "D:\n    a: {b: 1}\n",
    "D:\n    on: 1\n", "  a: 1\n"])
def test_read_yaml_rejects_other_formats(tmp_path, text):
    """Forms outside the reference format (several of which PyYAML types
    as ints, floats, bools or None) raise instead of being misread."""
    path = tmp_path / "other.yaml"
    path.write_text(text)
    with pytest.raises(ValueError):
        read_yaml(str(path))


# --- R2, R3: config fields and resolution --------------------------------------

def test_config_has_online_fields():
    assert TC().n_beams == JC().n_beams == 181
    assert convert.config_to_torch(JC(n_beams=90, time=3.0)).n_beams == 90


@pytest.fixture(scope="module")
def small_data():
    ds = jds.synthetic_world(T=80, n_landmarks=8, seed=1)
    return ds, jicm.prepare(ds, JC()), ticm.prepare(ds, TC(), "cpu")


@pytest.mark.parametrize("mode", ["sequential", "batched", "ba",
                                  "windowed_ba"])
@pytest.mark.parametrize("obs_cap", [0, 48, 4])
def test_resolve_config_matches_jax(small_data, mode, obs_cap):
    _, jd, td = small_data
    jc = JC(sweep_mode=mode, obs_cap=obs_cap, L=256, cota=5.0)
    tc = convert.config_to_torch(jc)
    if obs_cap == 4:                       # below the per-frame valid count
        with pytest.raises(ValueError):
            jicm.resolve_config(jc, jd)
        with pytest.raises(ValueError):
            ticm.resolve_config(tc, td)
        return
    assert ticm.resolve_config(tc, td) == convert.config_to_torch(
        jicm.resolve_config(jc, jd))
    assert (ticm.resolve_config(tc, td).obs_cap == 0) == (
        mode == "sequential" and obs_cap == 0)


def test_check_supported():
    """Every configuration the JAX ``run`` takes passes; a model that is
    not the port's EnergyModel (JAX hooks are JAX code) raises."""
    from icm_slam_tpu.core.energy import EnergyModel as JEM
    from icm_slam_tpu_torch.core.energy import EnergyModel as TEM
    with pytest.raises(TypeError):
        ticm.check_supported(TC(model=JEM()))
    for kw in (dict(sweep_mode="sequential"), dict(init_mode="sequential"),
               dict(replicate_new_obs_quirk=False),
               dict(pose_update="jacobi"), dict(init_mode="batched"),
               dict(sweep_mode="ba"), dict(sweep_mode="windowed_ba")):
        ticm.check_supported(TC(**kw))
        assert ticm.use_batched_init(TC(**kw)) == jicm.use_batched_init(
            JC(**kw))
    for kw in (dict(), dict(init_mode="batched"),
               dict(sweep_mode="sequential")):
        ticm.check_supported(TC(model=TEM(), **kw))
        assert ticm.use_batched_init(TC(model=TEM(), **kw)) == \
            jicm.use_batched_init(JC(model=JEM(), **kw))


# --- datasets and utils -------------------------------------------------------

def test_load(tmp_path, monkeypatch):
    a = tds.load("synthetic", T=50, seed=3)
    b = jds.load("synthetic", T=50, seed=3)
    for f in ("scans", "odom", "u", "x0"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for name in ("data_IJAC2018.mat", "datos_palomar1.mat"):
        with pytest.raises(FileNotFoundError):
            tds.load(str(tmp_path / name))
    monkeypatch.delenv("ICM_REFERENCE_DIR", raising=False)
    for name in ("ijac2018", "palomar"):
        with pytest.raises(FileNotFoundError, match="ICM_REFERENCE_DIR"):
            tds.load(name)
    monkeypatch.setenv("ICM_REFERENCE_DIR", str(tmp_path))
    for name in ("ijac2018", "palomar"):
        with pytest.raises(FileNotFoundError, match=str(tmp_path)):
            tds.load(name)
    with pytest.raises(ValueError):
        tds.load("nope")


def test_metrics_bitwise(tmp_path):
    rng = np.random.default_rng(0)
    x, y = rng.normal(0, 3, (60, 3)), rng.normal(0, 3, (60, 3))
    assert tmetrics.ate(x, y) == jmetrics.ate(x, y)
    assert tmetrics.ate(x, y, align=True) == jmetrics.ate(x, y, align=True)
    assert tmetrics.rpe(x, y, delta=7) == jmetrics.rpe(x, y, delta=7)
    rows = []
    for mod in (tmetrics, jmetrics):
        path = tmp_path / f"{mod.__name__}.jsonl"
        log = mod.JsonlLogger(str(path))
        log.log("iteration", k=np.int32(3), v=np.float32(0.5),
                a=np.arange(3))
        log.close()
        rec = json.loads(path.read_text())
        rec.pop("t")
        rows.append(rec)
    assert rows[0] == rows[1]


def test_checkpoint_bitwise(tmp_path):
    rng = np.random.default_rng(1)
    x, pos = rng.normal(size=(40, 3)), rng.normal(size=(9, 2))
    cnt = rng.integers(1, 50, 9).astype(np.float32)
    for k, mod in enumerate((tckpt, jckpt)):
        mod.save(str(tmp_path / mod.__name__ / f"icm_ckpt_{k + 9}.npz"),
                 k + 9, x, pos, cnt, 9, x_init=x * 2)
    for save_mod, load_mod in ((tckpt, jckpt), (jckpt, tckpt)):
        d = str(tmp_path / save_mod.__name__)
        assert tckpt.latest(d) == jckpt.latest(d)
        a = load_mod.load(load_mod.latest(d))
        b = save_mod.load(save_mod.latest(d))
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    assert tckpt.latest(str(tmp_path / "none")) is None


def test_export_bitwise(tmp_path):
    rng = np.random.default_rng(2)
    lm, traj = rng.uniform(-5, 5, (12, 2)), rng.uniform(-6, 6, (30, 3))
    files = []
    for mod in (texport, jexport):
        d = tmp_path / mod.__name__
        d.mkdir()
        mod.save_map_pgm(str(d / "m.pgm"), lm, trajectory=traj)
        mod.save_trajectory_tum(str(d / "t.txt"), traj, deltat=0.1)
        files.append([(d / f).read_bytes() for f in ("m.pgm", "m.yaml",
                                                     "t.txt")])
        np.testing.assert_array_equal(
            texport.load_trajectory_tum(str(d / "t.txt")),
            jexport.load_trajectory_tum(str(d / "t.txt")))
    assert files[0] == files[1]


# --- the online engine --------------------------------------------------------

@pytest.fixture(scope="module")
def online_world():
    ds = jds.synthetic_world(T=200, n_landmarks=12, seed=7)
    jc = JC(N=0, L=256, cota=20.0, init_mode="sequential")
    tc = convert.config_to_torch(jc)
    data = ticm.prepare(ds, tc, "cpu")
    x0 = torch.as_tensor(ds.odom[0]).float()   # the online engine's x0
    state, x, _ = tsw.init_sweep(data, ticm.seed_map(data, x0, tc), x0, tc,
                                 tweights(tc, "cpu"))
    eng = JOnline(jc, chunk_size=64)
    for frame in stream_dataset(ds):
        eng.push(*frame)
    return dict(ds=ds, jc=jc, tc=tc, init=(state, x),
                jax=eng.finish(refine=False))


@pytest.mark.parametrize("chunk", [8, 64])
def test_online_equals_init_sweep(online_world, chunk):
    """The streamed chunks are the causal init frame for frame: bitwise
    the port's init_sweep on the CPU, within the band of JAX's engine."""
    eng = OnlineSLAM(online_world["tc"], "cpu", chunk_size=chunk)
    for frame in stream_dataset(online_world["ds"]):
        eng.push(*frame)
    state, x = online_world["init"]
    res = eng.finish(refine=False)
    np.testing.assert_array_equal(res.x_init, x.numpy())
    for a, b in zip(eng._state, state):
        assert torch.equal(a, b)
    j = online_world["jax"]
    assert res.map_pos.shape == j.map_pos.shape
    np.testing.assert_array_equal(res.map_counts, j.map_counts)
    assert_close(res.map_pos, j.map_pos, BAND)
    assert_close(res.x_init, j.x_init, BAND)


def test_online_refine_carries_the_streamed_state(online_world):
    cfg = dataclasses.replace(online_world["tc"], N=1)
    eng = OnlineSLAM(cfg, "cpu", chunk_size=32)
    for frame in stream_dataset(online_world["ds"]):
        eng.push(*frame)
    res = eng.finish(refine=True)
    ref = ticm.run(online_world["ds"], cfg, "cpu")
    assert res.map_pos.shape == ref.map_pos.shape
    assert res.changes.shape == (1, 3)
    ate = np.sqrt(((res.x[:, :2] - ref.x[:, :2]) ** 2).sum(1)).mean()
    assert ate < 5e-3, ate


def test_online_edge_cases():
    ds = tds.synthetic_world(T=40, n_landmarks=6, seed=5)
    ds.scans[0] = 10.0                               # empty first frame
    res = api.run_online(stream_dataset(ds), TC(N=0, L=64, cota=2.0),
                         "cpu", refine=False)
    assert res.x_init.shape == (40, 3) and np.isfinite(res.x_init).all()
    with pytest.raises(RuntimeError, match="captured no frames"):
        OnlineSLAM(TC(N=1, L=64), "cpu").finish()


# --- run_offline: checkpoint / resume -------------------------------------------

@pytest.fixture(scope="module")
def offline_world():
    return (tds.synthetic_world(T=200, n_landmarks=15, seed=4),
            TC(N=6, L=128, cota=5.0))


def _ckpts(d):
    return sorted(f for f in os.listdir(d) if f.startswith("icm_ckpt_"))


def test_checkpointed_run_matches_unobserved(offline_world, tmp_path):
    ds, cfg = offline_world
    base = api.run_offline(ds, cfg, "cpu")
    ck = api.run_offline(ds, cfg, "cpu", checkpoint_dir=str(tmp_path / "ck"),
                         checkpoint_every=5)
    np.testing.assert_array_equal(base.x, ck.x)
    np.testing.assert_array_equal(base.map_pos, ck.map_pos)
    np.testing.assert_array_equal(base.changes, ck.changes)
    assert _ckpts(tmp_path / "ck") == ["icm_ckpt_4.npz", "icm_ckpt_5.npz"]
    jax_res = jicm.run(ds, JC(**convert.config_dict(cfg)))
    assert base.map_pos.shape == jax_res.map_pos.shape
    assert_close(base.x, jax_res.x, BAND)


def test_resume_from_segment_boundary(offline_world, tmp_path):
    ds, cfg = offline_world
    ckdir = str(tmp_path / "ck")
    full = api.run_offline(ds, cfg, "cpu", checkpoint_dir=ckdir,
                           checkpoint_every=3)
    for f in _ckpts(ckdir):
        if f != "icm_ckpt_2.npz":
            os.remove(os.path.join(ckdir, f))
    res = api.run_offline(ds, cfg, "cpu", checkpoint_dir=ckdir, resume=True,
                          checkpoint_every=3)
    np.testing.assert_array_equal(res.x, full.x)
    np.testing.assert_array_equal(res.map_pos, full.map_pos)
    np.testing.assert_array_equal(res.x_init, full.x_init)
    np.testing.assert_array_equal(res.changes, full.changes[3:])
    assert "icm_ckpt_5.npz" in _ckpts(ckdir)


def test_overflow_raises_before_checkpoint_persists(tmp_path):
    ds = tds.synthetic_world(T=600, n_landmarks=28, seed=0, odo_drift=2e-3)
    ckdir = tmp_path / "ck"
    with pytest.raises(RuntimeError,
                       match="table overflow in refinement sweep"):
        api.run_offline(ds, TC(N=2, L=256), "cpu",
                        checkpoint_dir=str(ckdir), checkpoint_every=2)
    assert _ckpts(ckdir) == []


def test_logger_keeps_per_iteration_rows(offline_world, tmp_path):
    ds, cfg = offline_world
    log = tmp_path / "m.jsonl"
    api.run_offline(ds, cfg, "cpu", checkpoint_dir=str(tmp_path / "ck"),
                    log_path=str(log), checkpoint_every=5)
    rows = [json.loads(line) for line in open(log)]
    assert [r["k"] for r in rows if r["event"] == "iteration"] == \
        list(range(cfg.N))
    assert rows[-1]["event"] == "done"
    assert len(_ckpts(tmp_path / "ck")) == cfg.N


# --- CLI -----------------------------------------------------------------------

def test_cli_run_and_replay(tmp_path, capsys):
    out = tmp_path / "r.npz"
    cli.main(["run", "--dataset", "synthetic", "--frames", "120",
              "--config", os.path.join(REPO, "configs", "reference.yaml"),
              "--iters", "2", "--device", "cpu", "--out", str(out),
              "--export-tum", str(tmp_path / "t.txt"),
              "--export-map", str(tmp_path / "m.pgm"),
              "--log", str(tmp_path / "l.jsonl")])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["frames"] == 120
    with np.load(out) as z:
        assert z["x"].shape == (120, 3) and z["changes"].shape == (2, 3)
    for f in ("t.txt", "m.pgm", "m.yaml", "l.jsonl"):
        assert (tmp_path / f).stat().st_size > 0
    cli.main(["replay", "--dataset", "synthetic", "--frames", "80",
              "--iters", "1", "--device", "cpu", "--quiet", "--jacobi",
              "--mode", "sequential", "--out", str(tmp_path / "p.npz")])
    with np.load(tmp_path / "p.npz") as z:
        assert z["x"].shape == (80, 3) and np.isfinite(z["x"]).all()


def test_cli_refuses_what_the_port_lacks(capsys):
    """The TPU knobs and plotting are argparse errors; ``--loop-close`` and
    the BA modes are flags of the port (their parity: test_torch_ba.py,
    test_torch_loop_closure.py)."""
    for flag in ("--pallas", "--pallas-fused", "--plot-live"):
        with pytest.raises(SystemExit):
            cli.main(["run", "--dataset", "synthetic", flag])
    if not torch.cuda.is_available():
        # past argparse, the default device refuses to fall back
        for extra in (["--loop-close"], ["--mode", "ba"],
                      ["--mode", "windowed_ba"]):
            with pytest.raises(RuntimeError):
                cli.main(["run", "--dataset", "synthetic", "--frames", "20",
                          *extra])
    with pytest.raises(SystemExit):
        cli.main(["run", "--plot", "d"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            cli.main(["run", "--dataset", "synthetic", "--frames", "20"])
