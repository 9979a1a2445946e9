"""The port's spans (``utils.profiling.span``) on the CPU: ``run()`` and
``run_batched()`` under torch.profiler name their phases as one tree on
the host thread (``icm.run*`` at the top, ``icm.prepare``'s three
children, ``icm.init`` and ``icm.refine`` in order, every span closed on
return); without a profiler no span touches ``record_function`` and the
``timings`` keep their keys; ``PhaseTimer.phase`` is a span.  On a card,
the captures and replays of the CUDA graphs are spans too (``cuda``).
This file imports no JAX, so that the card runs it.
"""
import subprocess
import sys
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from icm_slam_tpu_torch.config import ICMConfig
from icm_slam_tpu_torch.data.datasets import synthetic_world
from icm_slam_tpu_torch.solver import cuda_graph, icm
from icm_slam_tpu_torch.utils import profiling

CFG = ICMConfig(N=2, L=256, cota=5.0)
SEEDS = (7, 10)

# what each entry point reported before its phases were spans, and the
# graphs it took from the cache of captured steps
KEYS = {"run": {"prepare_s", "init_s", "init_capture_s", "hoist_s",
                "refine_s", "capture_s", "refine_per_iter_s", "graph_hits"}}
KEYS["run_batched"] = KEYS["run"] | {"pipeline_s", "per_world_s"}


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: these small worlds run faster without threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _worlds():
    return [synthetic_world(T=120, n_landmarks=10, seed=s) for s in SEEDS]


def _call(entry, device="cpu"):
    worlds = _worlds()
    if entry == "run":
        return [icm.run(worlds[0], CFG, device)]
    return icm.run_batched(worlds, CFG, device)


class _Node:
    def __init__(self, name, start, end, parent):
        self.name, self.start, self.end = name, start, end
        self.parent, self.children = parent, []

    def names(self):
        return [c.name for c in self.children]

    def find(self, name):
        return [c for c in self.children if c.name == name]

    def phases(self):
        """The children, ``run_batched``'s ``icm.pipeline`` replaced by
        its own children."""
        out = []
        for c in self.children:
            out.extend(c.children if c.name == "icm.pipeline" else [c])
        return out

    def phase(self, name):
        return [c for c in self.phases() if c.name == name]


def _tree(prof):
    """The host's user spans as a forest: each span's parent is the
    innermost span that holds it."""
    spans = sorted(((e.start_ns(), -e.end_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.is_user_annotation()
                    and not str(e.device_type()).endswith("CUDA")))
    roots, stack = [], []
    for start, neg_end, name in spans:
        while stack and stack[-1].end <= start:
            stack.pop()
        node = _Node(name, start, -neg_end, stack[-1] if stack else None)
        (stack[-1].children if stack else roots).append(node)
        stack.append(node)
    return roots


class _Balance:
    """``record_function`` counting the ranges it opens and closes."""

    def __init__(self, real):
        self.real, self.open, self.opened = real, 0, 0

    def __call__(self, name):
        outer, rf = self, self.real(name)

        class _Range:
            def __enter__(self):
                outer.open += 1
                outer.opened += 1
                return rf.__enter__()

            def __exit__(self, *exc):
                outer.open -= 1
                return rf.__exit__(*exc)
        return _Range()


@pytest.mark.parametrize("entry", ["run", "run_batched"])
def test_a_call_emits_the_span_tree(entry, monkeypatch):
    balance = _Balance(profiling.record_function)
    monkeypatch.setattr(profiling, "record_function", balance)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _call(entry)
    assert balance.opened > 0 and balance.open == 0      # all closed
    roots = _tree(prof)
    assert [r.name for r in roots] == [f"icm.{entry}"]
    top = roots[0]
    W = 1 if entry == "run" else len(SEEDS)

    assert top.names().count("icm.pipeline") == (entry == "run_batched")
    names = [c.name for c in top.phases()]
    for phase in ("icm.prepare", "icm.init", "icm.hoist", "icm.refine"):
        assert names.count(phase) == 1, names
    order = [names.index(p) for p in ("icm.prepare", "icm.init",
                                      "icm.hoist", "icm.refine")]
    assert order == sorted(order)
    prep, init, refine = (top.phase(p)[0] for p in ("icm.prepare",
                                                     "icm.init",
                                                     "icm.refine"))
    assert init.start >= prep.end and refine.start >= init.end
    assert sorted(set(prep.names())) == ["icm.prepare.resolve",
                                         "icm.prepare.scans",
                                         "icm.prepare.seed_map"]
    assert prep.names().count("icm.prepare.scans") == W
    assert prep.names().count("icm.prepare.seed_map") == W
    # the CPU runs every init chunk and every sweep eagerly
    assert set(init.names()) == {"icm.init.eager", "icm.init.merge",
                                 "icm.filter_map"}
    assert init.names()[-2:] == ["icm.init.merge", "icm.filter_map"]
    assert refine.names().count("icm.refine.eager") == CFG.N
    assert "icm.check" in names and "icm.result" in names
    # no card: no graph, no barrier
    every = []
    todo = [top]
    while todo:
        n = todo.pop()
        every.append(n.name)
        todo.extend(n.children)
        assert top.start <= n.start <= n.end <= top.end
    assert not any(n.startswith(("icm.graph.", "icm.sync", "icm.gather"))
                   for n in every)


@pytest.mark.parametrize("entry", ["run", "run_batched"])
def test_no_profiler_no_record_function_and_the_same_timings(entry,
                                                              monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(profiling, "record_function", refuse)
    for res in _call(entry):
        assert set(res.timings) == KEYS[entry]
        assert all(v >= 0.0 for v in res.timings.values())
        assert res.timings["init_capture_s"] == 0.0
        assert res.timings["capture_s"] == 0.0
        assert res.timings["graph_hits"] == 0
        assert res.timings["refine_per_iter_s"] == pytest.approx(
            res.timings["refine_s"] / CFG.N)
    if entry == "run_batched":
        t = res.timings
        assert t["pipeline_s"] >= t["init_s"] + t["hoist_s"] + t["refine_s"]
        assert t["per_world_s"] == pytest.approx(
            t["pipeline_s"] / len(SEEDS))


def test_span_stores_its_host_seconds_and_closes_on_error():
    timings = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer", timings, "outer_s"):
            time.sleep(0.02)
            with pytest.raises(ValueError):
                with profiling.span("inner", timings, "inner_s"):
                    raise ValueError("in the block")
    assert timings["outer_s"] >= 0.02
    assert 0.0 <= timings["inner_s"] <= timings["outer_s"]
    (outer,) = _tree(prof)
    assert (outer.name, outer.names()) == ("outer", ["inner"])


def test_phase_timer_phase_is_a_span():
    timer = profiling.PhaseTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with timer.phase("assoc", block_on=[torch.ones(3)]):
                time.sleep(0.005)
    assert [r.name for r in _tree(prof)] == ["assoc", "assoc"]
    assert timer.counts == {"assoc": 2}
    assert timer.totals["assoc"] >= 0.01


def test_profiling_loads_no_solver():
    """``solver`` imports ``span``: ``utils.profiling`` itself imports no
    part of the solver (``device_trace`` does, when called)."""
    code = ("import sys, icm_slam_tpu_torch.utils.profiling\n"
            "print(sorted(m for m in sys.modules "
            "if m.startswith('icm_slam_tpu_torch.solver')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["run", "run_batched"])
def test_graphs_are_spans_on_the_card(entry):
    """On a card, in a call that finds no graph in the cache, the init's
    chunks after the first and the sweeps after the first are replays:
    one capture span each (the recording inside it), one replay span a
    replay, the barriers as ``icm.sync``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _call(entry, "cuda")                   # the kernels' library, once
    cuda_graph.GRAPHS.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = _call(entry, "cuda")
    (top,) = _tree(prof)
    init, refine = top.phase("icm.init")[0], top.phase("icm.refine")[0]
    for phase, key in ((init, "init_capture_s"), (refine, "capture_s")):
        (cap,) = phase.find("icm.graph.capture")
        assert cap.names() == ["icm.graph.record"]
        assert res[0].timings[key] > 0
    nc = -(-(120 - 1) // max(2, int(CFG.init_chunk_len)))
    assert len(init.find("icm.graph.replay")) == nc - 1
    assert init.names().count("icm.init.eager") == 1
    assert len(refine.find("icm.graph.replay")) == CFG.N - 1
    assert refine.names().count("icm.refine.eager") == 1
    for phase in ("icm.prepare", "icm.init", "icm.hoist", "icm.refine"):
        assert top.phase(phase)[0].names()[-1] == "icm.sync"


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["run", "run_batched"])
def test_a_hit_replays_every_step_on_the_card(entry):
    """A call whose graphs an earlier call with the same shapes left in
    the cache: one load span and only replays in the init (nc) and in the
    sweeps (N), no capture and no eager step; zero capture seconds and
    two hits in its timings."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _call(entry, "cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = _call(entry, "cuda")
    (top,) = _tree(prof)
    init, refine = top.phase("icm.init")[0], top.phase("icm.refine")[0]
    nc = -(-(120 - 1) // max(2, int(CFG.init_chunk_len)))
    for phase, replays in ((init, nc), (refine, CFG.N)):
        assert phase.names().count("icm.graph.load") == 1
        assert phase.names().count("icm.graph.replay") == replays
        assert not {"icm.graph.capture", "icm.init.eager",
                    "icm.refine.eager"} & set(phase.names())
    for r in res:
        assert r.timings["graph_hits"] == 2
        assert r.timings["init_capture_s"] == r.timings["capture_s"] == 0.0


WBA = ICMConfig(N=2, L=256, cota=5.0, sweep_mode="windowed_ba", ba_window=16)
WBA_KEYS = {"wba_passes", "wba_windows", "wba_steps", "wba_accepted",
            "wba_pass_s", "wba_rows", "wba_cols"}


def _wba_call(entry):
    worlds = _worlds()
    if entry == "run":
        return [icm.run(worlds[0], WBA, "cpu")]
    return icm.run_batched(worlds, WBA, "cpu")


@pytest.mark.parametrize("entry", ["run", "run_batched"])
def test_a_windowed_ba_call_opens_its_spans_and_counts(entry):
    """Each ``windowed_ba`` sweep: ``icm.wba.assoc``, two ``icm.wba.pass``
    (each holding a ``jacobian``, ``normal`` and ``accept`` span a window
    LM step), ``icm.wba.fill``; the timings count the passes, the windows
    (a world's T=120 frames: 8 windows of 16 in the first pass, 7 in the
    offset one), their LM steps and the accepted ones, the passes' host
    seconds, and the rows and columns of the systems solved, read as host
    numbers."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _wba_call(entry)
    (top,) = _tree(prof)
    (refine,) = top.phase("icm.refine")
    sweeps = refine.find("icm.refine.eager")
    assert len(sweeps) == WBA.N
    for sw in sweeps:
        assert sw.names() == ["icm.wba.assoc", "icm.wba.pass",
                              "icm.wba.pass", "icm.wba.fill"]
        for p in sw.find("icm.wba.pass"):
            assert p.names() == ["icm.wba.jacobian", "icm.wba.normal",
                                 "icm.wba.accept"] * WBA.ba_gn_iters
    W = 1 if entry == "run" else len(SEEDS)
    for r in res:
        t = r.timings
        assert set(t) == KEYS[entry] | WBA_KEYS
        assert t["wba_passes"] == 2 * WBA.N
        assert t["wba_windows"] == WBA.N * (8 + 7) * W
        assert t["wba_steps"] == t["wba_windows"] * WBA.ba_gn_iters
        assert type(t["wba_accepted"]) is int
        assert 0 < t["wba_accepted"] <= t["wba_steps"]
        assert 0 < t["wba_pass_s"] <= t["refine_s"]
        assert t["wba_cols"] == t["wba_steps"] * 3 * WBA.ba_window
        # a system's rows: 2 a beam of its frames, 6 an edge (17 edges)
        assert t["wba_rows"] % t["wba_steps"] == 0
        assert (t["wba_rows"] // t["wba_steps"] - 6 * 17) % 32 == 0


def test_a_windowed_ba_run_is_bitwise_the_same_under_the_profiler():
    """The spans and counters change no arithmetic: answers with the
    profiler on are the answers with it off, bit for bit."""
    (off,) = _wba_call("run")
    with profile(activities=[ProfilerActivity.CPU]):
        (on,) = _wba_call("run")
    for f in ("x_init", "x", "map_pos", "map_counts"):
        assert getattr(on, f).tobytes() == getattr(off, f).tobytes(), f
    assert on.timings["wba_accepted"] == off.timings["wba_accepted"]
