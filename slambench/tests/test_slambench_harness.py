"""CPU tests of the benchmark's harness (``slambench/``).

    python -m pytest slambench/tests -q

The ``cuda`` tests run on a machine with a card (they skip elsewhere).
"""
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from slambench.harness import bench, guard, readers, stats, tracing  # noqa
from slambench.harness import bounds, drive  # noqa: E402
from slambench.harness.registry import Registry  # noqa: E402
from slambench.harness.worlds import synthetic_world, world_seeds  # noqa
from conftest import copy_checkout  # noqa: E402

SMALL = {"world": {"T": 120, "n_landmarks": 10},
         "solver": {"N": 2, "L": 256, "cota": 5.0}}


def _digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


# a mix of another shape of load, with its entry, as new files: requests
# of run() arriving at a fixed rate (an open loop), each timed from its
# arrival, so a request that waits for the one before it counts the wait
PACED = """
import time

from slambench.harness import drive


class Entry(drive.Entry):
    def n_worlds(self, traffic, config):
        return int(traffic["pool"])

    def request(self, i, arrival=None):
        from icm_slam_tpu_torch.solver.icm import run
        k = i % len(self.worlds)
        t0 = time.perf_counter() if arrival is None else arrival
        res = run(self.datasets[k], self.solver, self.device)
        return drive.Request([k], [drive.answer(res)], t0,
                             time.perf_counter(), self.worlds[k].T,
                             res.timings)

    def window(self, seconds):
        period = 1.0 / float(self.traffic["rate_hz"])
        out, t0 = [], time.perf_counter()
        while len(out) * period < seconds:
            due = t0 + len(out) * period
            time.sleep(max(0.0, due - time.perf_counter()))
            out.append(self.request(len(out), due))
        return out
"""


def test_new_config_traffic_metric_and_limits_are_files_only(
        tmp_path, one_thread):
    """A cell with a new configuration, a mix of a new shape of load (an
    open loop) with its entry, a new metric and limits needs new files and
    new entries in BENCHMARK.json only: every file that was there stays as
    it was, and the cell runs."""
    root = copy_checkout(tmp_path)
    before = _digests(root / "slambench")
    sb = root / "slambench"
    cfg = json.loads((sb / "configs" / "grove_t1833.json").read_text())
    cfg["name"] = "tiny_grove"
    cfg["world"].update(T=100, n_landmarks=8)
    cfg["solver"].update(N=1, L=128, cota=5.0)
    (sb / "configs" / "tiny_grove.json").write_text(json.dumps(cfg))
    (sb / "traffic" / "pair.json").write_text(json.dumps(
        {"entry": "paced", "pool": 2, "rate_hz": 4.0,
         "trace": {"requests": 1}}))
    (sb / "entries" / "paced.py").write_text(PACED)
    (sb / "metrics" / "requests_served.py").write_text(
        "def read(ctx):\n    return float(len(ctx.requests))\n")
    # one sweep (N=1) leaves the map short of where another sweep puts it
    (sb / "limits" / "tiny.pair.json").write_text(json.dumps(
        {"check_worlds": 2, "limits": {"x_gap_median": 0.01,
                                       "init_gap_median": 0.01,
                                       "refine_shift_gap": 0.05,
                                       "map_self_gap": 0.5}}))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny_grove", "source": "test",
                         "file": "slambench/configs/tiny_grove.json",
                         "reduced": ["world"], "why": "test"})
    b["workloads"].append({"name": "tiny.pair", "config": "tiny_grove",
                           "traffic": "pair", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "requests_served", "unit": "requests",
                           "better": "higher", "source": "host_clock",
                           "layer": "test", "moves": "setup_s",
                           "workloads": ["tiny.pair"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    reg = Registry(root)
    assert reg.config("tiny_grove")["world"]["T"] == 100
    assert reg.traffic("pair")["pool"] == 2
    assert [m["name"] for m in reg.per_layer("tiny.pair")] == [
        "requests_served"]
    assert [m["name"] for m in reg.end_to_end("tiny.pair")] == ["setup_s"]
    res, rows = bench.run_cell("tiny.pair", 3, 0.5, True,
                               time.perf_counter(), device="cpu",
                               registry=reg, log=lambda m: None)
    assert res["correct"], res["checks"]
    assert res["metrics"]["requests_served"]["value"] == res["attempted"]
    # the open loop's arrivals: a request every 0.25 s, in the window
    assert res["attempted"] == 2
    now = _digests(root / "slambench")
    assert {k: v for k, v in now.items() if k in before} == before


# a reference of another solver path, as a file of its own: the causal
# init (``init_mode="sequential"``) followed by the batched sweeps, composed
# of ``reference/icm.py``'s pieces; its ``Params`` adds ``init_mode``
SEQINIT_REFERENCE = """
import dataclasses

import numpy as np
import torch

from slambench.reference import icm
from slambench.reference.icm import remap  # noqa: F401

CALLS = []          # (N, dtype) of every offline run, for the tests


@dataclasses.dataclass(frozen=True)
class Params(icm.Params):
    init_mode: str = "auto"

    SUPPORTED = dict(icm.Params.SUPPORTED, init_mode="sequential")


def offline(world, p, device, dtype=torch.float32):
    if p.init_mode != "sequential":
        raise ValueError("this reference runs the causal init only")
    CALLS.append((p.N, dtype))
    w = icm.Weights(p, dtype, device)
    dist, mask, ang, odom, u = icm._inputs(world, p, dtype, device)
    x0 = torch.as_tensor(np.asarray(world.x0), device=device).to(dtype)
    m0 = icm.seed(dist[0], mask[0], ang, x0, p)
    m, x_init = icm.causal_init(dist, mask, ang, odom, u, x0, m0, p, w)
    m = icm.filter_map(m, p.cota, p.dist_thr)
    m, x = icm.refine(dist, mask, ang, odom, u, m, x_init, p, w)
    return icm._result(m, x_init, x)
"""

# a world generator of its own: the grove loop driven twice, so that every
# frame of the second lap revisits the first's trunks
TWO_LAPS = """
from slambench.harness.worlds import synthetic_world


def generate(seed, **kw):
    return synthetic_world(seed=seed, laps=2, **kw)
"""

# one sweep (N=1) leaves the map short of where another sweep puts it
TINY_LIMITS = {"check_worlds": 2, "limits": {"x_gap_median": 0.01,
                                             "init_gap_median": 0.01,
                                             "refine_shift_gap": 0.05,
                                             "map_self_gap": 0.5}}


def add_seqinit_cell(root: Path) -> None:
    """The cell ``tiny_seq.offline``: a configuration that names the
    reference ``seqinit`` and the generator ``two_laps``, served by the
    ``offline`` mix through ``run()``, added as files and entries in
    BENCHMARK.json alone."""
    sb = root / "slambench"
    cfg = json.loads((sb / "configs" / "grove_t1833.json").read_text())
    cfg["name"] = "tiny_seq"
    cfg["reference"] = "seqinit"
    cfg["world"].update(generator="two_laps", T=100, n_landmarks=8)
    cfg["solver"].update(N=1, L=128, cota=5.0, init_mode="sequential")
    (sb / "configs" / "tiny_seq.json").write_text(json.dumps(cfg))
    (sb / "reference" / "seqinit.py").write_text(SEQINIT_REFERENCE)
    (sb / "worlds").mkdir(exist_ok=True)
    (sb / "worlds" / "two_laps.py").write_text(TWO_LAPS)
    (sb / "limits" / "tiny_seq.offline.json").write_text(
        json.dumps(TINY_LIMITS))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny_seq", "source": "test",
                         "file": "slambench/configs/tiny_seq.json",
                         "reduced": ["world"], "why": "test"})
    b["workloads"].append({"name": "tiny_seq.offline", "config": "tiny_seq",
                           "traffic": "offline", "chips": 1, "why": "test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "grove.offline" in m.get("workloads", []):
            m["workloads"].append("tiny_seq.offline")
    (root / "BENCHMARK.json").write_text(json.dumps(b))


@pytest.fixture(scope="module")
def with_seqinit(tmp_path_factory):
    """A checkout whose BENCHMARK.json holds the ``tiny_seq.offline``
    cell."""
    root = copy_checkout(tmp_path_factory.mktemp("seqinit"))
    add_seqinit_cell(root)
    return Registry(root)


def _spy_references(monkeypatch) -> list:
    """The reference modules the registry loads, in order."""
    loaded = []
    real = Registry.reference

    def spy(self, name):
        loaded.append(real(self, name))
        return loaded[-1]
    monkeypatch.setattr(Registry, "reference", spy)
    return loaded


def test_a_config_of_another_solver_path_is_files_only(
        tmp_path, one_thread, monkeypatch, capsys):
    """A configuration of another solver path (the causal init, then the
    batched sweeps) with a reference and a world generator of its own
    needs new files and entries in BENCHMARK.json only: every file that
    was there stays as it was, the cell runs and comes out correct, held
    to its own reference, and ``control.py`` reads that reference."""
    root = copy_checkout(tmp_path)
    before = _digests(root / "slambench")
    add_seqinit_cell(root)
    reg = Registry(root)
    loaded = _spy_references(monkeypatch)
    res, rows = bench.run_cell("tiny_seq.offline", 3, 0.3, False,
                               time.perf_counter(), device="cpu",
                               registry=reg, log=lambda m: None)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(TINY_LIMITS["limits"])
    assert [m.__name__ for m in loaded] == ["slambench_reference_seqinit"]
    # the check ran the cell's reference, at the configuration's N
    assert loaded[0].CALLS and set(loaded[0].CALLS) == {(1, torch.float32)}
    now = _digests(root / "slambench")
    assert {k: v for k, v in now.items() if k in before} == before

    # control.py of that checkout: its readings come from the same file
    spec = importlib.util.spec_from_file_location(
        "slambench_test_control", root / "slambench" / "control.py")
    control = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(control)
    monkeypatch.setattr(sys, "path", list(sys.path))
    capsys.readouterr()
    assert control.main(["--workload", "tiny_seq.offline", "--seeds", "3",
                         "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(lines) == 2
    for x in lines:
        assert set(TINY_LIMITS["limits"]) <= set(x["sound"])
        assert all(x["sound"][n] <= lim
                   for n, lim in TINY_LIMITS["limits"].items()), x
    calls = loaded[-1].CALLS
    assert loaded[-1].__name__ == "slambench_reference_seqinit"
    assert calls == [(1, torch.float32), (1, torch.bfloat16),
                     (0, torch.float32)] * 2


@pytest.mark.parametrize("solver", [{"sweep_mode": "windowed_ba"},
                                    {"sweep_mode": "sequential"},
                                    {"init_mode": "sequential"},
                                    {"pose_update": "jacobi"},
                                    {"replicate_new_obs_quirk": False}])
def test_a_path_the_reference_does_not_implement_fails_before_warm_up(
        solver, monkeypatch):
    """A configuration that names no reference of its own but asks for a
    path that ``reference/icm.py`` does not implement is refused at
    set-up, with the refusal's message: no world is served, the warm-up
    never runs."""
    warmed = []
    monkeypatch.setattr(drive.Entry, "warm",
                        lambda self: warmed.append(self))
    (key, value), = solver.items()
    with pytest.raises(ValueError, match=f"implements {key}="):
        bench.run_cell("grove.offline", 1, 0.1, False, time.perf_counter(),
                       device="cpu", log=lambda m: None,
                       overrides={"solver": solver})
    assert warmed == []


@pytest.mark.parametrize("override,missing", [
    ({"reference": "no_such_reference"}, "reference"),
    ({"world": {"generator": "no_such_generator"}}, "worlds")])
def test_an_unknown_reference_or_generator_fails_at_set_up(
        override, missing, monkeypatch):
    warmed = []
    monkeypatch.setattr(drive.Entry, "warm",
                        lambda self: warmed.append(self))
    with pytest.raises(KeyError, match=f"no {missing} 'no_such_"):
        bench.run_cell("grove.offline", 1, 0.1, False, time.perf_counter(),
                       device="cpu", log=lambda m: None, overrides=override)
    assert warmed == []


def test_a_generator_file_found_by_name_makes_the_worlds(with_seqinit):
    """``worlds/<name>.py``'s ``generate`` makes the worlds, one from each
    of the seeds every generator shares; ``synthetic_world`` is the
    harness's own."""
    from slambench.harness.worlds import make_worlds
    spec = {"generator": "two_laps", "T": 60, "n_landmarks": 6}
    got = make_worlds(spec, 2 ** 31 + 9, 3, with_seqinit.world_generator)
    seeds = world_seeds(2 ** 31 + 9, 3)
    for w, s in zip(got, seeds):
        want = synthetic_world(T=60, n_landmarks=6, seed=s, laps=2)
        for f in ("scans", "odom", "u", "x0"):
            assert np.array_equal(getattr(w, f), getattr(want, f))
    plain = make_worlds(dict(spec, generator="synthetic_world"), 2 ** 31 + 9,
                        3, with_seqinit.world_generator)
    assert [w.x0.tolist() for w in plain] != [w.x0.tolist() for w in got] \
        or any(not np.array_equal(a.u, b.u) for a, b in zip(plain, got))
    for w, s in zip(plain, seeds):
        want = synthetic_world(T=60, n_landmarks=6, seed=s)
        assert np.array_equal(w.scans, want.scans)


def test_the_entry_holds_the_configurations_reference(with_seqinit):
    """The entry resolves the configuration's reference and builds its
    ``Params`` at set-up; a configuration that names none gets
    ``reference/icm.py``'s."""
    reg = with_seqinit
    gen = reg.generator("offline", reg.config("tiny_seq"), 5, "cpu")
    assert gen.ref.__name__ == "slambench_reference_seqinit"
    assert type(gen.params).__name__ == "Params"
    assert gen.params.init_mode == "sequential" and gen.params.N == 1
    assert gen.params.replace_n(0).init_mode == "sequential"
    cfg = reg.config("grove_t1833")
    del cfg["reference"]
    cfg["world"].update(T=60)
    gen = reg.generator("offline", cfg, 5, "cpu")
    assert gen.ref.__name__ == "slambench_reference_icm"
    assert not hasattr(gen.params, "init_mode")
    assert gen.params == gen.ref.Params.from_solver(cfg["solver"])


def test_cells_find_every_piece_by_name():
    reg = Registry()
    names = {c["name"] for c in reg.bench["configs"]}
    for c in reg.bench["workloads"]:
        assert c["config"] in names
        assert reg.config(c["config"])["name"] == c["config"]
        assert issubclass(reg.entry(reg.traffic(c["traffic"])["entry"]),
                          drive.Entry)
        from slambench.reference import compare
        held = set(reg.limits(c["name"])["limits"])
        assert set(compare.WHOLE[:3]) <= held <= set(compare.WHOLE)
        assert reg.end_to_end(c["name"]) and reg.per_layer(c["name"])
        for m in reg.end_to_end(c["name"]) + reg.per_layer(c["name"]):
            assert callable(reg.reader(m["name"]))
    for c in reg.bench["configs"]:
        assert (ROOT / c["file"]).is_file()


class _Req:
    def __init__(self, start, end, frames, chunk_s=()):
        self.start, self.end, self.frames = start, end, frames
        self.chunk_s = list(chunk_s)


def test_rate_is_all_work_over_all_time():
    reqs = [_Req(10.0, 11.0, 100), _Req(11.5, 12.0, 300), _Req(12.0, 14.0,
                                                              600)]
    assert stats.rate(reqs) == pytest.approx(1000 / 4.0)
    with pytest.raises(ValueError):
        stats.rate([])


def test_p95_is_over_all_samples_not_chunk_medians():
    # two sessions: their own medians are 1 and 100; the window's p95 is
    # the 95th percentile of all 40 chunks
    a = [1.0] * 30
    b = [100.0] * 10
    assert stats.percentile(a + b, 95) == 100.0
    assert stats.percentile(list(range(1, 101)), 95) == 95
    assert stats.percentile([5.0], 95) == 5.0
    ctx = bench.Context("c", {}, 1.0, [_Req(0, 1, 10, [0.001] * 19 + [0.5]),
                                   _Req(1, 2, 10, [0.001] * 20)])
    read = Registry().reader("chunk_p95_ms")
    assert read(ctx) == pytest.approx(1.0)      # 39 of 40 at 1 ms


class _Ev:
    """A stand-in for one of the profiler's raw events, as torch 2.11 gives
    them (no activity type)."""

    def __init__(self, name, kind, start, end, cuda=False, thread=1):
        self._n, self._k, self._s, self._e = name, kind, start, end
        self._d, self._t = cuda, thread

    def name(self):
        return self._n

    def is_user_annotation(self):
        return "annotation" in self._k

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def start_thread_id(self):
        return self._t


class _EvTyped(_Ev):
    """The same with the activity type later torches give."""

    def activity_type(self):
        return self._k


def _trace(events, launches=None, frames=0):
    return tracing.from_events(events, launches or {}, frames)


@pytest.mark.parametrize("_Ev", [_Ev, _EvTyped])
def test_idle_share_on_synthetic_intervals(_Ev):
    ev = [_Ev(tracing.WINDOW, "user_annotation", 0, 1000),
          _Ev("slambench.solve", "user_annotation", 0, 1000),
          _Ev("aten::add", "cpu_op", 50, 950),
          _Ev("k_a", "kernel", 100, 300, cuda=True),
          _Ev("k_b", "kernel", 200, 400, cuda=True),        # overlaps k_a
          _Ev("Memcpy HtoD", "gpu_memcpy", 600, 700, cuda=True),
          _Ev("k_c", "kernel", 900, 1200, cuda=True),       # clipped at 1000
          _Ev("gpu span", "gpu_user_annotation", 0, 1000, cuda=True),
          _Ev("k_out", "kernel", 1500, 1600, cuda=True)]    # outside
    t = _trace(ev, frames=4)
    assert t.busy == [(100, 400), (600, 700), (900, 1000)]
    assert t.busy_s == pytest.approx(500e-9)
    assert t.window_s == pytest.approx(1000e-9)
    assert readers.idle_pct(t) == pytest.approx(50.0)
    assert readers.launches_per_frame(t) == pytest.approx(3 / 4)
    assert t.gaps() == [(0, 100), (400, 600), (700, 900)]
    bd = t.breakdown()
    assert bd["idle_gaps"][0][0] == "slambench.solve/aten::add"
    assert sum(s for _, s in bd["idle_gaps"]) == pytest.approx(500e-9)
    assert [n for n, _ in bd["device_ops"]] == ["k_c", "k_a", "k_b"]
    # a trace in which the device ran nothing has no idle share to read
    empty = _trace([_Ev(tracing.WINDOW, "user_annotation", 0, 1000)])
    assert readers.idle_pct(empty) is None
    assert readers.launches_per_frame(empty) is None
    assert readers.k4_roofline(empty, 8) is None


def test_k4_roofline_reads_bound_over_device_time():
    k4 = readers.K4_KERNEL + "(Problems)"
    ev = [_Ev(tracing.WINDOW, "user_annotation", 0, 10 ** 6),
          _Ev(k4, "kernel", 0, 31_000, cuda=True),
          _Ev(k4, "kernel", 40_000, 71_000, cuda=True)]
    shape = (916, 48, "two")
    t = _trace(ev, {("pose_lm", shape): 2})
    want = 100 * 2 * bounds.k4_shape_bound_us(*shape, iters=8) / 62.0
    assert readers.k4_roofline(t, 8) == pytest.approx(want)
    assert 0 < readers.k4_roofline(t, 8) < 100
    # fewer LM steps, a lower bound
    assert readers.k4_roofline(t, 6) <= readers.k4_roofline(t, 8)
    # counts that disagree with the trace give no reading
    assert readers.k4_roofline(_trace(ev, {("pose_lm", shape): 3}),
                               8) is None


@pytest.mark.parametrize("solver,iters", [
    ({"pose_gn_iters": 8, "init_gn_iters": 0}, 8),
    ({"pose_gn_iters": 6}, 6),
    ({"pose_gn_iters": 8, "init_gn_iters": 4}, 4)])
def test_k4_iters_come_from_the_cells_solver(solver, iters):
    assert readers.k4_iters(solver) == iters
    ctx = bench.Context("c", {"solver": solver}, 1.0, [])
    assert Registry().reader("k4_roofline")(ctx) is None      # no trace


def test_bounds_are_chip_smokes_at_perfs_shapes():
    import chip_smoke
    assert bounds.PEAK_F32_FLOPS == chip_smoke.PEAK_F32_FLOPS
    assert bounds.PEAK_BYTES_PER_S == chip_smoke.PEAK_BYTES_PER_S
    for args in (("k1", 1833, 48, 128, 6), ("k2", 1833, 48, 1024, 6),
                 ("k1", 1833, 152, 128, 20, 8), ("k2", 1, 181, 1024, 30)):
        assert bounds.kernel_bound_us(*args) == \
            chip_smoke.kernel_bound_us(*args)
    from icm_slam_tpu_torch.core.energy import PoseProblem
    g = torch.Generator().manual_seed(0)
    for P, B, two in ((916, 48, True), (32, 48, False), (1, 181, False),
                      (7328, 152, True)):
        def r(*s):
            return torch.rand(s, generator=g)
        prob = PoseProblem(r(P, B), r(P, B), r(P, B) < 0.1, r(P, B, 2),
                           r(P, 3), r(P, 2), r(P, 3), r(P, 3), r(P, 3),
                           r(P, 2), r(P, 3))
        fold = (torch.arange(P) == P - 1) if two else None
        w = (torch.ones(3), torch.ones(2), torch.tensor(1.0), 0.1)
        mine = bounds.k4_bound_us(prob, r(P, 3), w, fold, two)
        assert mine == chip_smoke.k4_bound_us(prob, r(P, 3), w, fold, two)
        shape = bounds.k4_shape_bound_us(P, B, "two" if two else "one", 8)
        assert shape <= mine[0]
        if mine[1] == "bytes":
            assert shape == pytest.approx(mine[0])
    # PERF's K4 bound at (916, 48, two): 0.25 us, set by the bytes
    assert bounds.k4_shape_bound_us(916, 48, "two", 8) == pytest.approx(
        0.25, abs=0.005)
    assert bounds.k4_shape_bound_us(1, 181, "one", 8) == pytest.approx(
        0.0009, abs=0.0001)


@pytest.mark.parametrize("kw", [dict(T=200, n_landmarks=12, seed=7),
                                dict(T=1833, n_landmarks=40, seed=2 ** 31 + 5),
                                dict(T=300, seed=0, odo_drift=0.0)])
def test_world_generator_is_the_programs_bitwise(kw):
    from icm_slam_tpu_torch.data.datasets import synthetic_world as theirs
    a, b = synthetic_world(**kw), theirs(**kw)
    for f in ("scans", "odom", "u", "x0"):
        assert np.array_equal(getattr(a, f), getattr(b, f))


def test_world_seeds_take_any_whole_number():
    assert world_seeds(5, 4) == world_seeds(5, 4)
    assert world_seeds(5, 4) != world_seeds(6, 4)
    assert len(set(world_seeds(2 ** 40 + 3, 8))) == 8


def test_forbidden_modules_compare_whole_top_level_names():
    assert guard.forbidden_modules(["icm_slam_tpu_torch",
                                    "icm_slam_tpu_torch.ops", "numpy",
                                    "jaxtyping", "flaxen"]) == []
    assert guard.forbidden_modules(["icm_slam_tpu.solver.icm"]) == [
        "icm_slam_tpu"]
    assert guard.forbidden_modules(["jax", "jaxlib.xla_client", "flax.nn",
                                    "numpy"]) == ["flax", "jax", "jaxlib"]


def _run(args, cwd, timeout=300):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("cell", ["grove.offline", "fleet8.offline",
                                  "grove.stream", "tiny_seq.offline"])
def test_a_run_loads_no_jax(cell, with_stream, with_seqinit):
    """The harness, the program and the reference on a small cell load no
    JAX and no JAX package (a fresh process); ``tiny_seq.offline`` names a
    reference file and a generator file of its own."""
    reg = with_seqinit if cell == "tiny_seq.offline" else with_stream
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from slambench.harness import bench, guard\n"
        "from slambench.harness.registry import Registry\n"
        "res, _ = bench.run_cell(%r, 4, 0.3, True, "
        "time.perf_counter(), device='cpu', overrides=%r, "
        "log=lambda m: None, registry=Registry(%r))\n"
        "assert res['correct'], res\n"
        "print(guard.forbidden_modules())\n") % (
            str(ROOT), cell, SMALL, str(reg.root))
    out = _run(["-c", code], ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_refuses_without_a_card():
    out = _run(["slambench/run.py", "--workload", "grove.offline", "--seed",
                "1", "--seconds", "1", "--trace", "0"], ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "torch.cuda.is_available() is False" in out.stderr


def test_refuses_in_a_checkout_without_the_program(tmp_path):
    root = copy_checkout(tmp_path)
    out = _run(["slambench/run.py", "--workload", "grove.offline", "--seed",
                "1", "--seconds", "1", "--trace", "0"], root)
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "slambench/run.py", "--workload", "grove.offline",
         "--seed", "7", "--seconds", "2", "--trace", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert 0 < res["metrics"]["k4_roofline"]["value"] < 100
