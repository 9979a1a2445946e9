"""The port's plotting, profiling and leftover helpers against the JAX
package's, on the CPU: ``utils.viz`` (the plotted line data equal to
JAX's), ``api.run_offline(live_plot=...)`` (the per-sweep census exact and
the poses within 1e-3 of JAX's live plot; bitwise the run without one),
the CLI's ``--plot`` / ``--plot-live`` (both PNGs written; without
matplotlib the command exits first, naming it), ``sweeps.compact_obs``
(bitwise), ``energy.energy`` (rtol 1e-6), and ``utils.profiling``
(``PhaseTimer.report()``'s keys and counts; ``device_trace`` writes a
Chrome trace that parses, and a CUDA request without CUDA raises).

JAX's and the port's ``plot_slam`` draw into the same matplotlib figure
numbers in one process, so each figure's lines are read before the next
call.
"""
import glob
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from icm_slam_tpu import api as japi
from icm_slam_tpu.config import ICMConfig as JC
from icm_slam_tpu.core import energy as jenergy
from icm_slam_tpu.data import datasets as jds
from icm_slam_tpu.solver import sweeps as jsw
from icm_slam_tpu.utils import profiling as jprof
from icm_slam_tpu.utils import viz as jviz
from icm_slam_tpu_torch import api, cli
from icm_slam_tpu_torch.config import ICMConfig as TC
from icm_slam_tpu_torch.core import energy as tenergy
from icm_slam_tpu_torch.data import datasets as tds
from icm_slam_tpu_torch.mapping.landmark_map import MapState
from icm_slam_tpu_torch.runtime import fake_rosbridge as frb
from icm_slam_tpu_torch.runtime.replay import publish_to_rosbridge
from icm_slam_tpu_torch.solver import sweeps as tsw
from icm_slam_tpu_torch.utils import profiling as tprof
from icm_slam_tpu_torch.utils import viz as tviz
from tests.torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

BAND = 1e-3
SMALL = dict(L=256, cota=20.0, N=3)


def _lines(fig):
    """Each line of the figure's axes: (xy data, label, colour, marker,
    style), read now (the next plot may reuse the figure)."""
    (ax,) = fig.axes
    return [(ln.get_xydata().copy(), ln.get_label(), ln.get_color(),
             ln.get_marker(), ln.get_linestyle()) for ln in ax.get_lines()]


def _axes_text(fig):
    (ax,) = fig.axes
    legend = ax.get_legend()
    return (ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
            [t.get_text() for t in legend.get_texts()] if legend else None)


def _assert_same_lines(la, lb):
    assert len(la) == len(lb)
    for (xa, *sa), (xb, *sb) in zip(la, lb):
        assert np.array_equal(xa, xb)
        assert sa == sb


def _snapshot(fig):
    return _lines(fig), _axes_text(fig)


def _png(path):
    assert os.path.getsize(path) > 1000, path


def _trajectory(T, seed):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.normal(0, 0.1, (T, 3)), 0).astype(np.float32)
    return x, (x + rng.normal(0, 0.05, (T, 3))).astype(np.float32)


@pytest.mark.parametrize("odom,n_landmarks,title", [
    (True, 7, "synthetic: trajectory + 7 landmarks"),
    (False, 3, None),
    (True, 0, "no landmarks")])
def test_plot_slam_draws_jax_lines(tmp_path, odom, n_landmarks, title):
    x, od = _trajectory(120, 1)
    lm = np.random.default_rng(2).uniform(-5, 5, (n_landmarks, 2)).astype(
        np.float32)
    od = od if odom else None
    out = {}
    for name, mod in (("jax", jviz), ("port", tviz)):
        path = str(tmp_path / f"{name}.png")
        fig = mod.plot_slam(x, lm, od, path=path, title=title)
        assert fig.number == 0
        out[name] = _snapshot(fig)
        _png(path)
    _assert_same_lines(out["jax"][0], out["port"][0])
    assert out["jax"][1] == out["port"][1]
    labels = [ln[1] for ln in out["port"][0]]
    assert labels == (["trajectory"] + (["odometry"] if odom else [])
                      + (["landmarks"] if n_landmarks else []))


@pytest.mark.parametrize("n", [0, 1, 6])
def test_plot_convergence_draws_jax_lines(tmp_path, n):
    changes = np.abs(np.random.default_rng(n).normal(0, 1, (n, 3)))
    out = {}
    for name, mod in (("jax", jviz), ("port", tviz)):
        path = str(tmp_path / f"{name}.png")
        fig = mod.plot_convergence(changes, path=path)
        assert fig.number == 100
        out[name] = _snapshot(fig)
        _png(path)
    _assert_same_lines(out["jax"][0], out["port"][0])
    assert out["jax"][1] == out["port"][1]
    assert [ln[1] for ln in out["port"][0]] == (["min", "max", "mean"]
                                                if n else [])


def test_live_plot_updates_headless():
    x, od = _trajectory(60, 3)
    lm = np.ones((4, 2), np.float32)
    lp = tviz.LivePlot()
    assert (lp.figure, lp.pause) == (11, 0.01)
    lp.update(x, lm, odom=od)
    port = _lines(tviz._plt().figure(11))
    jviz.LivePlot().update(x, lm, odom=od)
    _assert_same_lines(port, _lines(jviz._plt().figure(11)))
    assert [ln[1] for ln in port] == ["trajectory", "odometry", "landmarks"]


class Recorder:
    """Stands in for LivePlot: keeps copies of what each update got."""

    def __init__(self):
        self.calls = []

    def update(self, x, landmarks, odom=None):
        self.calls.append((np.array(x), np.array(landmarks), odom))


@pytest.fixture(scope="module")
def small_worlds():
    kw = dict(T=240, n_landmarks=12, seed=7)
    return jds.synthetic_world(**kw), tds.synthetic_world(**kw)


def test_run_offline_live_plot_against_jax(small_worlds):
    jworld, tworld = small_worlds
    jrec, trec = Recorder(), Recorder()
    jres = japi.run_offline(jworld, JC(**SMALL), live_plot=jrec)
    tres = api.run_offline(tworld, TC(**SMALL), "cpu", live_plot=trec)
    assert len(jrec.calls) == len(trec.calls) == SMALL["N"]
    for (jx, jl, jo), (tx, tl, to) in zip(jrec.calls, trec.calls):
        assert isinstance(tx, np.ndarray) and tx.shape == (240, 3)
        assert tl.shape == jl.shape                  # the census, a sweep
        np.testing.assert_allclose(tx, jx, atol=BAND)
        np.testing.assert_allclose(tl, jl, atol=BAND)
        assert to is tworld.odom and jo is jworld.odom
    # the last update is the result
    assert np.array_equal(trec.calls[-1][0], tres.x)
    assert np.array_equal(trec.calls[-1][1], tres.map_pos)
    assert tres.map_pos.shape == jres.map_pos.shape

    # the observer only reads: the run without it is the same, bit for bit
    plain = api.run_offline(tworld, TC(**SMALL), "cpu")
    for f in ("x_init", "x", "map_pos", "map_counts", "changes"):
        assert np.array_equal(getattr(tres, f), getattr(plain, f)), f


@pytest.mark.parametrize("live_plot,updates", [(True, 2), (False, 0)])
def test_live_plot_true_makes_a_liveplot(monkeypatch, live_plot, updates):
    made = []

    class Fake(Recorder):
        def __init__(self):
            super().__init__()
            made.append(self)

    monkeypatch.setattr(tviz, "LivePlot", Fake)
    ds = tds.synthetic_world(T=120, n_landmarks=10, seed=7)
    res = api.run_offline(ds, TC(L=256, cota=20.0, N=2), "cpu",
                          live_plot=live_plot)
    assert len(made) == (1 if live_plot else 0)
    assert sum(len(m.calls) for m in made) == updates
    if made:
        assert np.array_equal(made[0].calls[-1][0], res.x)


def test_cli_run_and_replay_plot(tmp_path, capsys):
    d = tmp_path / "run"
    cli.main(["run", "--dataset", "synthetic", "--device", "cpu",
              "--frames", "200", "--iters", "2", "--plot", str(d),
              "--plot-live"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for f in ("slam.png", "convergence.png"):
        _png(d / f)
    title = tviz._plt().figure(0).axes[0].get_title()
    assert title == f"synthetic: trajectory + {summary['landmarks']} " \
                    f"landmarks"
    d = tmp_path / "replay"
    cli.main(["replay", "--dataset", "synthetic", "--device", "cpu",
              "--frames", "120", "--iters", "1", "--plot", str(d),
              "--plot-live", "--quiet"])
    for f in ("slam.png", "convergence.png"):
        _png(d / f)


def _wait(cond, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def test_cli_online_plot_on_the_loopback(tmp_path, monkeypatch):
    server = frb.FakeRosBridgeServer().start()
    monkeypatch.setitem(sys.modules, "roslibpy", frb.client_module())
    yaml = tmp_path / "cfg.yaml"
    yaml.write_text("D:\n    N: 1\n    L: 256\n    cota: 20.0\n"
                    "    time: 60.0\n")
    ds = tds.synthetic_world(T=60, seed=3)
    errors = []

    def feed():
        try:
            _wait(lambda: len(server._subs) == 2, "the CLI's subscriptions")
            publish_to_rosbridge(ds, TC.from_yaml(str(yaml)), hz=10.0,
                                 speedup=100.0, host=server.host,
                                 port=server.port)
            time.sleep(1.0)
            lib = sys.modules["roslibpy"]
            client = lib.Ros(host=server.host, port=server.port)
            client.run()
            lib.Service(client, "/icm_slam/iterative_flag",
                        "std_srvs/SetBool").call({"data": True}, timeout=10)
            client.terminate()
        except Exception as e:   # surfaced below, in the test's thread
            errors.append(e)

    th = threading.Thread(target=feed, daemon=True)
    th.start()
    d = tmp_path / "plots"
    try:
        cli.main(["online", "--device", "cpu", "--config", str(yaml),
                  "--host", server.host, "--port", str(server.port),
                  "--plot", str(d), "--quiet"])
    finally:
        th.join(timeout=60)
        server.stop()
    assert not th.is_alive() and not errors, errors
    for f in ("slam.png", "convergence.png"):
        _png(d / f)
    title = tviz._plt().figure(0).axes[0].get_title()
    assert title.startswith("online: trajectory + ")


@pytest.mark.parametrize("argv", [
    ["run", "--plot", "{d}"], ["run", "--plot-live"],
    ["replay", "--plot", "{d}"], ["replay", "--plot-live"],
    ["online", "--plot", "{d}"]])
def test_plot_flags_without_matplotlib_exit_first(tmp_path, monkeypatch,
                                                  capsys, argv):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    d = tmp_path / "plots"
    common = (["--dataset", "synthetic", "--frames", "50"]
              if argv[0] != "online" else ["--port", "1"])
    with pytest.raises(SystemExit) as e:
        cli.main([a.format(d=d) for a in argv] + common + ["--device",
                                                           "cpu"])
    assert e.value.code != 0 and "matplotlib" in str(e.value.code)
    assert capsys.readouterr().out == ""     # no work, no summary
    assert not d.exists()


def _masked_world(T, B, seed):
    rng = np.random.default_rng(seed)
    dist = rng.uniform(0.5, 9.0, (T, B)).astype(np.float32)
    mask = rng.uniform(size=(T, B)) < 0.2
    mask[3] = False                              # an empty frame
    mask[5] = True                               # a full one
    ang = np.linspace(0, np.pi, B, dtype=np.float32)
    odom = rng.normal(0, 1, (T, 3)).astype(np.float32)
    u = rng.normal(0, 1, (T, 2)).astype(np.float32)
    matched = rng.normal(0, 3, (T, B, 2)).astype(np.float32)
    return (dist, mask, ang, odom, u), matched


@pytest.mark.parametrize("cap", [None, 8])
def test_compact_obs_is_jax_bitwise(cap):
    import jax.numpy as jnp
    fields, matched = _masked_world(12, 40, 5)
    cap = cap or int(fields[1].sum(1).max())
    j = jsw.compact_obs(jsw.SweepData(*map(jnp.asarray, fields)),
                        jnp.asarray(matched), cap)
    t = tsw.compact_obs(tsw.SweepData(*map(torch.as_tensor, fields)),
                        torch.as_tensor(matched), cap)
    for a, b in zip(j, t):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_compact_obs_fleet_is_each_world():
    worlds = [_masked_world(12, 40, s) for s in (1, 2, 3)]
    stacked = tsw.SweepData(*[torch.as_tensor(np.stack(
        [w[0][i] for w in worlds])) if i != 2 else torch.as_tensor(
        worlds[0][0][2]) for i in range(5)])
    matched = torch.as_tensor(np.stack([w[1] for w in worlds]))
    fleet = tsw.compact_obs(stacked, matched, 16)
    for k, (fields, m) in enumerate(worlds):
        one = tsw.compact_obs(tsw.SweepData(*map(torch.as_tensor, fields)),
                              torch.as_tensor(m), 16)
        for a, b in zip(fleet, one):
            assert torch.equal(a[k], b)


@pytest.mark.parametrize("n", [1, 37, 1000])
def test_energy_matches_jax(n):
    import jax.numpy as jnp
    r = np.random.default_rng(n).normal(0, 2, n).astype(np.float32)
    e_t = tenergy.energy(torch.as_tensor(r))
    e_j = jenergy.energy(jnp.asarray(r))
    assert e_t.dtype == torch.float32 and e_t.shape == ()
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-6)


def test_phase_timer_reports_jax_keys_and_counts():
    import jax.numpy as jnp
    seq = ["assoc", "solve", "assoc", "filter", "assoc"]
    jt, tt = jprof.PhaseTimer(), tprof.PhaseTimer()
    for name in seq:
        with jt.phase(name, block_on={"a": [jnp.ones(3) * 2]}):
            pass
        made = []
        with tt.phase(name, block_on=made):
            made.append(MapState(torch.ones(4, 2), torch.ones(4),
                                 torch.tensor(2, dtype=torch.int32)))
    with tt.phase("plain"):
        pass
    with jt.phase("plain"):
        pass
    jr, tr = jt.report(), tt.report()
    assert list(jr) == list(tr) == ["assoc", "filter", "plain", "solve"]
    for k in jr:
        assert set(jr[k]) == set(tr[k]) == {"total_s", "mean_ms", "count"}
        assert jr[k]["count"] == tr[k]["count"]
        assert tr[k]["total_s"] == round(tt.totals[k], 4)
        assert tr[k]["mean_ms"] == round(
            tt.totals[k] / tt.counts[k] * 1e3, 3)
    assert tr["assoc"]["count"] == 3


def test_device_trace_cpu_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64)
    with tprof.device_trace(str(tmp_path), device="cpu"):
        b = (a @ a).relu().sum()
    assert torch.isfinite(b)
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        trace = json.load(f)
    ops = [e["name"] for e in trace["traceEvents"]
           if e.get("cat") == "cpu_op"]
    assert {"aten::mm", "aten::relu", "aten::sum"} <= set(ops), set(ops)
    assert not any(e.get("cat") == "kernel" for e in trace["traceEvents"])


def test_device_trace_cuda_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        with tprof.device_trace(str(tmp_path)):
            pass
    assert not os.listdir(tmp_path)
