"""The live transport of the port: ``runtime/ingest``, ``runtime/
fake_rosbridge`` and ``runtime/replay.publish_to_rosbridge`` (NumPy and
standard-library copies of the JAX package's) against the originals,
bitwise; the loopback chain publisher -> fake rosbridge ->
``RosBridgeSource`` -> ``OnlineSLAM`` on the CPU; and ``python -m
icm_slam_tpu_torch online`` as a subprocess against the loopback.

roslibpy is not installed: its stand-in is ``fake_rosbridge.
client_module()``, put in ``sys.modules`` in this process and, for the
CLI's process, by a one-line ``roslibpy.py`` on its PYTHONPATH.  The
frames the transport delivers are the dataset's rows with the ranges
clipped at the sensor's range and the heading passed through a quaternion
(wrapped into (-pi, pi]): equal to ``_as_transported`` bitwise.  The
loopback chain is held to the port's offline causal init on those frames
from the same first pose (census equal, x_init atol 1e-5), the CLI's file
to ``api.run_online`` over the same frames (census equal, x_init atol
1e-5).
This replaces, on synthetic data, tests/test_rosbridge_loopback.py, which
needs the reference's ``.mat`` file.
"""
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from icm_slam_tpu.config import ICMConfig as JC
from icm_slam_tpu.data.datasets import synthetic_world
from icm_slam_tpu.runtime import fake_rosbridge as jfrb
from icm_slam_tpu.runtime import ingest as jing
from icm_slam_tpu.runtime import replay as jrep
from icm_slam_tpu_torch import api, cli
from icm_slam_tpu_torch.config import ICMConfig as TC
from icm_slam_tpu_torch.data.datasets import Dataset
from icm_slam_tpu_torch.runtime import fake_rosbridge as frb
from icm_slam_tpu_torch.runtime import ingest as ing
from icm_slam_tpu_torch.runtime import replay as rep
from icm_slam_tpu_torch.solver import icm as ticm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STOP = ("/icm_slam/iterative_flag", "std_srvs/SetBool")


# --- ingest: both packages on the same messages, bitwise ---------------------

def _laser_msg(ranges, angle_min=-math.pi / 2, inc=math.pi / 180, secs=1,
               nsecs=0):
    return {"header": {"stamp": {"secs": secs, "nsecs": nsecs}, "seq": 0},
            "ranges": list(ranges), "angle_min": angle_min,
            "angle_increment": inc}


def _laser_cases():
    rng = np.random.default_rng(4)
    return {
        "nan_radius_clip": (_laser_msg([float("nan"), 9.95, 5.0]
                                       + [10.0] * 178), 10.0, 0.137),
        "resample": (_laser_msg(np.linspace(1.0, 8.0, 362),
                                inc=math.pi / 360), 10.0, 0.0),
        "left_sector": (_laser_msg([5.0] * 90, angle_min=0.0), 10.0, 0.0),
        "random": (_laser_msg([*rng.uniform(0.0, 12.0, 179).tolist(),
                               float("inf"), float("nan")]), 10.0, 0.137),
        "wide": (_laser_msg(rng.uniform(0.0, 12.0, 400).tolist(),
                            angle_min=-2.0, inc=0.01), 10.0, 0.2),
    }


@pytest.mark.parametrize("case", sorted(_laser_cases()))
def test_parse_laser_scan_is_the_jax_copy(case):
    msg, max_range, radio = _laser_cases()[case]
    a = ing.parse_laser_scan(msg, max_range, radio)
    b = jing.parse_laser_scan(msg, max_range, radio)
    assert a.dtype == b.dtype and a.shape == b.shape == (181,)
    np.testing.assert_array_equal(a, b)


def test_stamp_quat_and_odometry_are_the_jax_copy():
    msg = _laser_msg([1.0], secs=7, nsecs=123456789)
    assert ing.stamp_of(msg) == jing.stamp_of(msg)
    for yaw in np.linspace(-3.1, 3.1, 29):
        q = (0.0, 0.0, math.sin(yaw / 2), math.cos(yaw / 2))
        assert ing.quat_to_yaw(*q) == jing.quat_to_yaw(*q)
        assert abs(ing.quat_to_yaw(*q) - yaw) < 1e-12
        odo = {"pose": {"pose": {
            "position": {"x": 1.5, "y": -2.0, "z": 0.0},
            "orientation": dict(zip("xyzw", q))}},
            "twist": {"twist": {"linear": {"x": 0.5, "y": 0, "z": 0},
                                "angular": {"x": 0, "y": 0, "z": -0.2}}}}
        for a, b in zip(ing.parse_odometry(odo), jing.parse_odometry(odo)):
            np.testing.assert_array_equal(a, b)


def _feed(sync, case):
    rng = np.random.default_rng(9)
    for k in range(60):
        if case == "jitter":
            tl = k * 0.1 + rng.uniform(-0.03, 0.03)
            to = k * 0.1 + rng.uniform(-0.03, 0.03)
        else:
            tl, to = k * 0.1, k * 0.1 + 0.01
        sync.feed_laser(tl, np.full(181, float(k)))
        if not (case == "gap" and 10 <= k <= 12):
            sync.feed_odometry(to, np.array([k, 0.0, 0.1 * k]),
                               np.array([1.0, 0.05]))


@pytest.mark.parametrize("case", ["grid", "gap", "jitter"])
def test_synchronizer_is_the_jax_copy(case):
    port, ref = ing.FrameSynchronizer(0.1), jing.FrameSynchronizer(0.1)
    for sync in (port, ref):
        _feed(sync, case)
    a, b = list(port.drain()), list(ref.drain())
    assert len(a) == len(b) >= 40
    for fa, fb in zip(a, b):
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(x, y)
    assert port.stats == ref.stats
    if case == "gap":
        assert port.stats["dropped"] >= 1


# --- the loopback: the port's server with the JAX client and back ------------

@pytest.fixture()
def bridge(monkeypatch):
    server = frb.FakeRosBridgeServer().start()
    monkeypatch.setitem(sys.modules, "roslibpy", frb.client_module())
    yield server
    server.stop()


def _wait(cond, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.mark.parametrize("server_of,client_of", [
    ("port", "jax"), ("jax", "port"), ("port", "port")])
def test_fake_rosbridge_speaks_the_jax_protocol(server_of, client_of):
    """Each package's loopback server carries the other's client: topics
    fan out, a service answers, an unadvertised one says so."""
    mods = {"port": frb, "jax": jfrb}
    server = mods[server_of].FakeRosBridgeServer().start()
    lib = mods[client_of].client_module()
    try:
        sub, pub = lib.Ros(server.host, server.port), \
            lib.Ros(server.host, server.port)
        sub.run()
        pub.run()
        got = []
        lib.Topic(sub, "/t", "std_msgs/String").subscribe(got.append)
        lib.Service(sub, *STOP).advertise(
            lambda req, resp: resp.update(message=f"got {req['data']}")
            or True)
        _wait(lambda: server._subs.get("/t"), "the subscription")
        topic = lib.Topic(pub, "/t", "std_msgs/String")
        for k in range(5):
            topic.publish(lib.Message({"data": k, "s": [1.5, "x"]}))
        _wait(lambda: len(got) == 5, "five messages")
        assert got == [{"data": k, "s": [1.5, "x"]} for k in range(5)]
        assert lib.Service(pub, *STOP).call({"data": True}) == \
            {"message": "got True"}
        assert lib.Service(pub, "/nobody/home", "std_srvs/SetBool").call(
            {"data": True}, timeout=5)["message"] == "service not advertised"
        sub.terminate()
        pub.terminate()
    finally:
        server.stop()


def _published(publish, ds, cfg):
    """Every message ``publish`` sends for ``ds``, as a subscriber on a
    fresh loopback receives them."""
    server = frb.FakeRosBridgeServer().start()
    lib = frb.client_module()
    old = sys.modules.get("roslibpy")
    sys.modules["roslibpy"] = lib
    try:
        ros = lib.Ros(server.host, server.port)
        ros.run()
        got = {"laser": [], "odom": []}
        lib.Topic(ros, cfg.topic_laser, cfg.topic_laser_msg).subscribe(
            got["laser"].append)
        lib.Topic(ros, cfg.topic_odometry, cfg.topic_odometry_msg).subscribe(
            got["odom"].append)
        _wait(lambda: len(server._subs) == 2, "the subscriptions")
        publish(ds, cfg, hz=10.0, speedup=1000.0, host=server.host,
                port=server.port)
        _wait(lambda: len(got["laser"]) == len(got["odom"]) == ds.T,
              "every message")
        ros.terminate()
        return got
    finally:
        if old is None:
            sys.modules.pop("roslibpy", None)
        else:
            sys.modules["roslibpy"] = old
        server.stop()


def test_publish_to_rosbridge_is_the_jax_copy():
    ds = synthetic_world(T=12, n_landmarks=4, seed=1)
    a = _published(rep.publish_to_rosbridge, ds, TC())
    b = _published(jrep.publish_to_rosbridge, ds, JC())

    def stamp(m):
        s = m["header"].pop("stamp")
        return s["secs"] + s["nsecs"] * 1e-9

    for topic in ("laser", "odom"):
        ta = [stamp(m) for m in a[topic]]
        tb = [stamp(m) for m in b[topic]]
        # the same messages, stamped on the same 10 Hz grid from another t0
        assert a[topic] == b[topic]
        np.testing.assert_allclose(np.diff(ta), 0.1, atol=1e-6)
        np.testing.assert_allclose(np.diff(tb), 0.1, atol=1e-6)


# --- the chain, in process and through the CLI -------------------------------

def _stop_capture(host, port):
    lib = sys.modules["roslibpy"]
    client = lib.Ros(host=host, port=port)
    client.run()
    resp = lib.Service(client, *STOP).call({"data": True}, timeout=10)
    client.terminate()
    return resp


def _as_transported(ds, n, cfg):
    """The first ``n`` frames of ``ds`` as the transport delivers them:
    ranges clipped at the sensor's range (the tree radius stays with the
    engine), the heading through the quaternion, so wrapped into
    (-pi, pi]."""
    yaw = [ing.quat_to_yaw(0.0, 0.0, math.sin(t / 2), math.cos(t / 2))
           for t in ds.odom[:n, 2]]
    odom = np.concatenate([ds.odom[:n, :2], np.array(yaw)[:, None]], 1)
    return Dataset(np.minimum(ds.scans[:n], cfg.rango_laser_max), odom,
                   ds.u[:n].copy(), odom[0].copy(), "transported")


def test_transport_end_to_end_matches_offline_causal_init(bridge):
    T = 120
    ds = synthetic_world(T=T, seed=0)
    cfg = TC(N=0, L=256, cota=20.0, init_mode="sequential")
    src = ing.RosBridgeSource(cfg, host=bridge.host, port=bridge.port)
    src.connect()
    _wait(lambda: len(bridge._subs) == 2, "the source's subscriptions")
    pub = threading.Thread(target=rep.publish_to_rosbridge, args=(ds, cfg),
                           kwargs=dict(hz=10.0, speedup=100.0,
                                       host=bridge.host, port=bridge.port),
                           daemon=True)
    pub.start()
    pub.join(timeout=60)
    assert not pub.is_alive()
    _wait(lambda: src.sync.stats["laser_buffered"] >= T
          and src.sync.stats["odo_buffered"] >= T, "every frame")
    assert _stop_capture(bridge.host, bridge.port)["message"] == "Working..."
    assert src.iterations_flag is True

    from icm_slam_tpu_torch.runtime.online import OnlineSLAM
    eng = OnlineSLAM(cfg, "cpu", chunk_size=32)
    frames = list(src.frames(duration=30.0))
    src.disconnect()
    n = len(frames)
    assert n >= T - 2 and src.sync.stats["dropped"] == 0, src.sync.stats
    # the JSON round trip and the parsers give the dataset's rows back
    sent = _as_transported(ds, n, cfg)
    for k, (ranges, pose, u) in enumerate(frames):
        np.testing.assert_array_equal(ranges, sent.scans[k])
        np.testing.assert_array_equal(pose, sent.odom[k])
        np.testing.assert_array_equal(u, sent.u[k])
    for f in frames:
        eng.push(*f)
    res = eng.finish(refine=False)

    ref = ticm.run(sent, TC(N=0, L=256, cota=20.0, sweep_mode="sequential"),
                   "cpu")
    assert res.map_pos.shape == ref.map_pos.shape
    assert res.map_pos.shape[0] >= 1
    np.testing.assert_allclose(res.x_init, ref.x_init, atol=1e-5)


def _shim(tmp_path):
    """A directory whose ``roslibpy`` is the loopback client, for a
    process of the CLI (the package itself never installs one)."""
    d = tmp_path / "shim"
    d.mkdir()
    (d / "roslibpy.py").write_text(
        "import sys\n"
        "from icm_slam_tpu_torch.runtime.fake_rosbridge import "
        "client_module\n"
        "sys.modules[__name__] = client_module()\n")
    return str(d)


def test_cli_online_subprocess_against_loopback(bridge, tmp_path):
    T = 100
    ds = synthetic_world(T=T, seed=3)
    yaml = tmp_path / "cfg.yaml"
    yaml.write_text("D:\n    N: 1\n    L: 256\n    cota: 20.0\n"
                    "    time: 60.0\n")
    out, tum = tmp_path / "online.npz", tmp_path / "traj.txt"
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([_shim(tmp_path), REPO]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "icm_slam_tpu_torch", "online", "--device",
         "cpu", "--config", str(yaml), "--host", bridge.host, "--port",
         str(bridge.port), "--out", str(out), "--export-tum", str(tum)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        _wait(lambda: len(bridge._subs) == 2 or proc.poll() is not None,
              "the CLI's subscriptions", timeout=120)
        assert proc.poll() is None, proc.communicate()
        cfg = TC.from_yaml(str(yaml))
        rep.publish_to_rosbridge(ds, cfg, hz=10.0, speedup=100.0,
                                 host=bridge.host, port=bridge.port)
        time.sleep(1.0)           # the server's fan-out settles
        _stop_capture(bridge.host, bridge.port)
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, stderr[-3000:]
    assert '"dropped": 0' in stdout
    with np.load(out) as z:
        x, x_init, census = z["x"], z["x_init"], z["map_pos"].shape[0]
    n = x.shape[0]
    assert n >= T - 10 and np.isfinite(x).all()
    assert tum.read_text().count("\n") == n
    ref = api.run_online(rep.stream_dataset(_as_transported(ds, n, cfg)),
                         cfg, "cpu")
    assert census == ref.map_pos.shape[0] >= 1
    np.testing.assert_allclose(x_init, ref.x_init, atol=1e-5)


def test_config_time_is_read_from_the_reference_yaml(bridge, tmp_path):
    path = os.path.join(REPO, "configs", "reference.yaml")
    assert TC.from_yaml(path).time == JC.from_yaml(path).time == 275.0
    assert TC().time == JC().time
    for f in ("topic_laser", "topic_laser_msg", "topic_odometry",
              "topic_odometry_msg"):
        assert getattr(TC(), f) == getattr(JC(), f)
    # without --duration the capture window is config.time: nothing is
    # published, so a window of 0.3 s ends in an empty session
    yaml = tmp_path / "short.yaml"
    yaml.write_text("D:\n    time: 0.3\n")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="captured no frames"):
        cli.main(["online", "--device", "cpu", "--config", str(yaml),
                  "--host", bridge.host, "--port", str(bridge.port),
                  "--quiet"])
    assert time.monotonic() - t0 < 20.0
