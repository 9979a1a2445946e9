"""The solver's cache of captured steps (``solver.cuda_graph.GRAPHS``) on
the CPU.  A stand-in for the capture (``EagerStep``: the same static
state, each replay the step run eagerly) lets the graph path of
``run()``, ``run_batched()``, ``init_sweep_batched`` and
``refine_sweeps`` run here: the key follows the shapes, the config, the
device and the call site's flags, never the data; the cache keeps both
graphs of four keys in turn and evicts the least recently used past its
bound; a nested call with a key in use misses and captures its own; a hit
reports ``graph_hits`` and zero capture seconds, its answers are a miss's
bit for bit, and what a call returns aliases no buffer the cache keeps.
This file imports no JAX; the same on the card is in
``tests/test_torch_kernels_cuda.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from icm_slam_tpu_torch.config import ICMConfig
from icm_slam_tpu_torch.core.energy import weights
from icm_slam_tpu_torch.data.datasets import Dataset, synthetic_world
from icm_slam_tpu_torch.mapping.landmark_map import MapState
from icm_slam_tpu_torch.solver import cuda_graph, icm
from icm_slam_tpu_torch.solver.sweeps import init_sweep_batched

CFG = ICMConfig(N=2, L=256, cota=5.0)


class EagerStep:
    """``cuda_graph.CapturedStep`` off the card: the same static state
    and outputs, and each replay runs the step eagerly on the state."""

    def __init__(self, step, *state):
        self.state = tuple(cuda_graph._clone(s) for s in state)
        self.device = cuda_graph._device(self.state)
        self.step, self.outs, self.pool_bytes = step, (), 0
        cuda_graph.CAPTURES += 1

    def replay(self):
        out = self.step(*self.state)
        n = len(self.state)
        for dst, src in zip(self.state, out[:n]):
            cuda_graph._copy(dst, src)
        self.outs = tuple(out[n:])
        cuda_graph.REPLAYS += 1


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def graphs(monkeypatch):
    """The card's graph path on the CPU, on an empty cache; returns a
    function that turns it off and on (``graphs(False)``: the CPU path)."""
    monkeypatch.setattr(cuda_graph, "CapturedStep", EagerStep)
    cuda_graph.GRAPHS.clear()

    def turn(on=True):
        monkeypatch.setattr(cuda_graph, "captures", lambda device: on)
    turn()
    yield turn
    cuda_graph.GRAPHS.clear()


def _world(T=120, seed=7):
    return synthetic_world(T=T, n_landmarks=10, seed=seed)


def _other_data(ds):
    """``ds``'s shape and beams with other odometry, controls and start:
    the same resolved config, other answers."""
    rng = np.random.default_rng(3)
    return Dataset(ds.scans, ds.odom + rng.normal(0, 1e-3, ds.odom.shape),
                   ds.u + rng.normal(0, 1e-3, ds.u.shape),
                   ds.x0 + np.array([0.01, -0.02, 0.003]))


def _same(a, b):
    return all(np.array_equal(u, v) for u, v in zip(
        (a.x_init, a.x, a.map_pos, a.map_counts, a.changes),
        (b.x_init, b.x, b.map_pos, b.map_counts, b.changes)))


# --- the key --------------------------------------------------------------

def _key_inputs(W=1, T=120, B=48, dtype=torch.float32, device="cpu",
                fill=0.0):
    data = tuple(torch.full((W, T, B), fill, dtype=dtype, device=device)
                 for _ in range(3))
    state = (MapState(torch.zeros((W, 256, 2), dtype=dtype, device=device),
                      torch.zeros((W, 256), dtype=dtype, device=device),
                      torch.zeros((W,), dtype=torch.int32, device=device)),
             torch.zeros((W, T, 3), dtype=dtype, device=device))
    w = (torch.ones(3, dtype=dtype, device=device),
         torch.ones(2, dtype=dtype, device=device), 0.1)
    return data, w, state


CHANGES = {
    "other values": (dict(fill=3.0), {}, {}),
    "T": (dict(T=121), {}, {}),
    "W": (dict(W=2), {}, {}),
    "B and obs_cap": (dict(B=64), dict(obs_cap=64), {}),
    "map_run_cap": ({}, dict(map_run_cap=256), {}),
    "a config field": ({}, dict(cota=6.0), {}),
    "dtype": (dict(dtype=torch.float64), {}, {}),
    "device": (dict(device="meta"), {}, {}),
    "change=": ({}, {}, dict(change=False)),
}


@pytest.mark.parametrize("what", sorted(CHANGES))
def test_the_key_follows_shapes_config_device_and_flags(what):
    shapes, fields, flags = CHANGES[what]
    base = dataclasses.replace(CFG, obs_cap=48, map_run_cap=128)
    key = cuda_graph.graph_key("refine", base, *_key_inputs(), change=True)
    again = cuda_graph.graph_key("refine", base, *_key_inputs(),
                                 change=True)
    other = cuda_graph.graph_key(
        "refine", dataclasses.replace(base, **fields),
        *_key_inputs(**shapes), **{"change": True, **flags})
    assert key == again and hash(key) == hash(again)
    assert (key == other) == (what == "other values")
    assert key != cuda_graph.graph_key("init", base, *_key_inputs(),
                                       change=True)


# --- the cache: LRU order, the bound, check-out -------------------------

def _entry(nbytes=0):
    """A captured entry of ``nbytes`` input bytes (a stand-in capture)."""
    e = cuda_graph.CachedStep(torch.zeros(nbytes // 4))
    e.capture(lambda x: (x + 1,), torch.zeros(1))
    return e


def test_both_graphs_of_four_keys_stay(monkeypatch):
    monkeypatch.setattr(cuda_graph, "CapturedStep", EagerStep)
    cache = cuda_graph.GraphCache()
    keys = [(site, world) for world in range(4) for site in ("init",
                                                             "refine")]
    hits = cuda_graph.CACHE_HITS
    for rnd in range(3):
        for k in keys:
            e = cache.take(k)
            assert (e is None) == (rnd == 0)
            cache.give(k, e or _entry())
    assert len(cache) == 8 and set(cache.keys()) == set(keys)
    assert cuda_graph.CACHE_HITS - hits == 2 * len(keys)
    assert cuda_graph.MAX_ENTRIES >= 8


def test_the_least_recently_used_goes_first(monkeypatch):
    monkeypatch.setattr(cuda_graph, "CapturedStep", EagerStep)
    cache = cuda_graph.GraphCache()
    n = cuda_graph.MAX_ENTRIES
    for k in range(n):
        cache.give(k, _entry())
    cache.give(0, cache.take(0))             # 0 used last: 1 is the oldest
    cache.give(n, _entry())
    assert cache.keys() == list(range(2, n)) + [0, n]


def test_the_memory_bound_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(cuda_graph, "CapturedStep", EagerStep)
    monkeypatch.setattr(cuda_graph, "_budget", lambda device: 2500)
    cache = cuda_graph.GraphCache()
    one = _entry(1000).nbytes()
    assert 1000 <= one < 1250
    for k in range(3):
        cache.give(k, _entry(1000))
    assert cache.keys() == [1, 2]
    cache.give("big", _entry(4000))          # over the budget alone
    assert cache.keys() == ["big"]


def test_a_checked_out_entry_is_a_miss_until_given_back(monkeypatch):
    monkeypatch.setattr(cuda_graph, "CapturedStep", EagerStep)
    cache = cuda_graph.GraphCache()
    outer = _entry()
    cache.give("k", outer)
    assert cache.take("k") is outer
    assert cache.take("k") is None           # a nested call: a miss
    inner = _entry()
    cache.give("k", inner)
    cache.give("k", outer)                   # the outer call ends last
    assert cache.keys() == ["k"] and cache.take("k") is outer


# --- the call sites -----------------------------------------------------

def test_a_b_a_prime_hit_bitwise_as_misses(graphs):
    a, b = _world(), _world(T=96, seed=10)
    a2 = _other_data(a)
    graphs(False)
    plain = [icm.run(ds, CFG, "cpu") for ds in (a, b, a2)]
    assert all(r.timings["graph_hits"] == 0 for r in plain)
    assert len(cuda_graph.GRAPHS) == 0
    graphs(True)
    caps, hits = cuda_graph.CAPTURES, cuda_graph.CACHE_HITS
    got = [icm.run(ds, CFG, "cpu") for ds in (a, b, a2)]
    assert [r.timings["graph_hits"] for r in got] == [0, 0, 2]
    assert cuda_graph.CAPTURES - caps == 4
    assert cuda_graph.CACHE_HITS - hits == 2
    assert len(cuda_graph.GRAPHS) == 4
    assert got[2].timings["init_capture_s"] == 0.0
    assert got[2].timings["capture_s"] == 0.0
    assert got[0].timings["init_capture_s"] > 0.0
    assert got[0].timings["capture_s"] > 0.0
    for p, g in zip(plain, got):
        assert _same(p, g)
    assert not _same(got[0], got[2])


def test_run_batched_twice_hits_both_graphs(graphs):
    fleet = [_world(seed=s) for s in (7, 10)]
    graphs(False)
    plain = icm.run_batched(fleet, CFG, "cpu")
    graphs(True)
    first = icm.run_batched(fleet, CFG, "cpu")
    again = icm.run_batched([_other_data(ds) for ds in fleet], CFG, "cpu")
    assert first[0].timings["graph_hits"] == 0
    assert again[0].timings["graph_hits"] == 2
    assert again[0].timings["init_capture_s"] == 0.0
    assert again[0].timings["capture_s"] == 0.0
    assert all(_same(p, g) for p, g in zip(plain, first))
    graphs(False)
    want = icm.run_batched([_other_data(ds) for ds in fleet], CFG, "cpu")
    assert all(_same(p, g) for p, g in zip(want, again))


def test_a_nested_call_captures_its_own(graphs):
    ds = _world()
    graphs(False)
    plain = icm.run(ds, CFG, "cpu")
    graphs(True)
    icm.run(ds, CFG, "cpu")
    inner = []
    caps = cuda_graph.CAPTURES
    outer = icm.run(ds, CFG, "cpu", callback=lambda k, m, x: inner.append(
        icm.run(ds, CFG, "cpu")), callback_stride=1)
    # after the first sweep the outer call holds the sweeps' entry (the
    # init's is back): the inner call captures the sweeps anew; after the
    # last the outer call has given it back
    assert [r.timings["graph_hits"] for r in inner] == [1, 2]
    assert outer.timings["graph_hits"] == 2
    assert cuda_graph.CAPTURES - caps == 1
    assert _same(outer, plain) and all(_same(r, plain) for r in inner)
    assert len(cuda_graph.GRAPHS) == 2


def _storages(*items):
    return {a.untyped_storage().data_ptr()
            for a in cuda_graph._leaves(items) if isinstance(a, torch.Tensor)}


def _cached_storages():
    out = set()
    for key in cuda_graph.GRAPHS.keys():
        e = cuda_graph.GRAPHS.take(key)
        out |= _storages(e.inputs, e.graph.state, e.graph.outs)
        cuda_graph.GRAPHS.give(key, e)
    return out


def _start(ds):
    data = icm.prepare(ds, CFG, "cpu")
    cfg = icm.resolve_config(CFG, data)
    x0 = torch.as_tensor(ds.x0).to(data.dist.dtype)
    return data, icm.seed_map(data, x0, cfg), x0, cfg, weights(cfg, "cpu")


@pytest.mark.parametrize("site", ["init", "refine"])
def test_what_a_call_returns_aliases_no_cached_buffer(graphs, site):
    a, a2 = _world(), _other_data(_world())

    def call(ds):
        data, seed, x0, cfg, w = _start(ds)
        if site == "init":
            return init_sweep_batched(data, seed, x0, cfg, w, {})
        state, x, _ = init_sweep_batched(data, seed, x0, cfg, w)
        data = icm.hoist_compaction(data, cfg)
        *_, (cur, x, wit, chg) = icm.refine_sweeps(data, state, x, cfg, w,
                                                   3, change=True)
        return cur, x, wit, chg

    first = call(a)
    kept = cuda_graph._clone(first)
    assert len(cuda_graph.GRAPHS) == (1 if site == "init" else 2)
    assert not _storages(first) & _cached_storages()
    second = call(a2)                      # a hit: replays over the buffers
    assert not _storages(second) & _cached_storages()
    for u, v in zip(cuda_graph._leaves(first), cuda_graph._leaves(kept)):
        assert torch.equal(u, v)
    assert not all(torch.equal(u, v) for u, v in zip(
        cuda_graph._leaves(first), cuda_graph._leaves(second)))


def test_the_cpu_path_keeps_no_graph():
    caps, n = cuda_graph.CAPTURES, len(cuda_graph.GRAPHS)
    res = icm.run(_world(), CFG, "cpu")
    assert res.timings["graph_hits"] == 0
    assert cuda_graph.CAPTURES == caps and len(cuda_graph.GRAPHS) == n
