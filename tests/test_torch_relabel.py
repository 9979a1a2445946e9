"""The map filter's relabel walk without a host sync (K3's plain version),
and the batched sweep with no host read at all.

(a) ``ops.relabel.relabel_walk_plain`` against the host walk that the
    port ran before it (``_host_walk`` below, NumPy, integer-only) on
    random neighbour chains, and the port's ``filter_map`` against JAX's on
    maps built of chains of close pairs in shuffled row order, whose merge
    depends on the walk's order: W = 1 and 3 with another live count in
    every world (0 among them), K = 8, 128 and 1024, ``live_cap`` on and
    off.  Bitwise: the walk is integer-only, and the merge sums add in
    row order on both sides.
(b) ``_refine_step`` (batched, capped and uncapped, one world and a fleet
    of three) and ``filter_map`` under a dispatch mode that raises on
    every op that reads a tensor back to the host
    (``aten._local_scalar_dense``, ``aten.nonzero``,
    ``aten.masked_select``), with ``Tensor.numpy`` and ``Tensor.tolist``
    patched to raise: what lets the card capture a sweep in a CUDA graph.
(c) ``landmark_map.update`` gives JAX's label on a tie of sqrt(d^2) with
    unequal d^2 (K2's sqrt key), bitwise with its map.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from icm_slam_tpu.mapping import landmark_map as jlm
from icm_slam_tpu_torch.config import ICMConfig
from icm_slam_tpu_torch.data.datasets import synthetic_world
from icm_slam_tpu_torch.mapping import landmark_map as tlm
from icm_slam_tpu_torch.ops.assoc import launch_plan, nearest_landmark_plain
from icm_slam_tpu_torch.ops.relabel import relabel_walk, relabel_walk_plain
from icm_slam_tpu_torch.solver import icm as ticm
from tests.test_torch_sequential import _sqrt_tie
from tests.torch_parity import assert_equal, jf32, tf32
from tests.torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

DIST_THR = 1.0
COTA = 10.0


def _host_walk(nn, close, n, K):
    """The sequential relabel loop as the port ran it on the host before
    K3 (order-dependent, integer-only): for each close row i < n in
    order, every row labelled like its neighbour nn[i] takes row i's
    label."""
    lab = np.arange(K, dtype=np.int32)
    for i in np.flatnonzero(close[:n]):
        lab = np.where(lab == lab[nn[i]], lab[i], lab)
    return lab


def _walk_inputs(W, K, ns, seed):
    """Neighbours that mostly point at a near row (chains), some at a far
    one, a third of the rows close."""
    rng = np.random.default_rng(seed)
    nn = np.clip(np.arange(K)[None] + rng.integers(-3, 4, (W, K)), 0, K - 1)
    far = rng.uniform(size=(W, K)) < 0.2
    nn = np.where(far, rng.integers(0, K, (W, K)), nn).astype(np.int32)
    close = rng.uniform(size=(W, K)) < 0.35
    return nn, close, np.asarray(ns, np.int32)


@pytest.mark.parametrize("W,K,ns", [
    (1, 8, [8]), (1, 8, [0]), (3, 8, [5, 0, 8]), (1, 128, [97]),
    (3, 128, [128, 0, 41]), (1, 1024, [1024]), (3, 1024, [0, 777, 1024])])
def test_relabel_walk_plain_equals_host_walk(W, K, ns):
    nn, close, n = _walk_inputs(W, K, ns, seed=K + W)
    lab = relabel_walk(torch.from_numpy(nn), torch.from_numpy(close),
                       torch.from_numpy(n))
    assert lab.dtype == torch.int32 and lab.shape == (W, K)
    want = np.stack([_host_walk(nn[w], close[w], int(n[w]), K)
                     for w in range(W)])
    assert_equal(lab, want)
    assert_equal(relabel_walk_plain(torch.from_numpy(nn),
                                    torch.from_numpy(close),
                                    torch.from_numpy(n)), want)


@pytest.mark.parametrize("close,n,want", [
    ([True, False, True], 3, [2, 2, 2]), ([True, False, False], 3, [0, 0, 2]),
    ([False, True, False], 3, [1, 1, 2]), ([True, True, True], 1, [0, 0, 2]),
    ([True, True, True], 0, [0, 1, 2])])
def test_relabel_walk_by_hand(close, n, want):
    """Rows 0 and 2 point at row 1, row 1 at row 0: the label a group
    keeps is that of the last close row the walk meets, so it depends on
    the order; rows at or past n are not walked."""
    lab = relabel_walk(torch.tensor([[1, 0, 1]], dtype=torch.int32),
                       torch.tensor([close]),
                       torch.tensor([n], dtype=torch.int32))
    assert lab.tolist() == [want]


def _chain_map(L, n, seed):
    """``n`` live landmarks in chains of close pairs (steps of 0.3-0.95
    dist_thr in random directions, chains far apart, an exact duplicate),
    in shuffled row order; counts around cota, a few pruned."""
    rng = np.random.default_rng(seed)
    pts = []
    while len(pts) < n:
        p = rng.uniform(-2000, 2000, 2)
        for _ in range(rng.integers(1, 9)):
            pts.append(p)
            a = rng.uniform(0, 2 * np.pi)
            p = p + rng.uniform(0.3, 0.95) * DIST_THR * np.array(
                [np.cos(a), np.sin(a)])
    pts = np.asarray(pts[:n]).reshape(n, 2)
    if n > 3:
        pts[n - 1] = pts[1]
    pos = np.zeros((L, 2), np.float32)
    counts = np.zeros((L,), np.float32)
    pos[:n] = pts[rng.permutation(n)]
    counts[:n] = rng.integers(COTA - 3, COTA + 40, n)
    return pos, counts


FILTER_CASES = [(8, 0, [7]), (8, 0, [8, 0, 5]), (128, 0, [128]),
                (128, 0, [0, 90, 128]), (1024, 128, [128]),
                (1024, 128, [100, 128, 0]), (1024, 0, [1024]),
                (1024, 0, [600, 0, 1024])]


@pytest.mark.parametrize("L,live_cap,ns", FILTER_CASES)
def test_filter_map_chains_equal_jax(L, live_cap, ns):
    maps = [_chain_map(L, n, seed=L + n + i) for i, n in enumerate(ns)]
    state = tlm.MapState(tf32(np.stack([m[0] for m in maps])),
                         tf32(np.stack([m[1] for m in maps])),
                         torch.tensor(ns, dtype=torch.int32))
    got = tlm.filter_map(state if len(ns) > 1 else
                         tlm.MapState(*(a[0] for a in state)), COTA,
                         DIST_THR, live_cap=live_cap)
    if len(ns) == 1:
        got = tlm.MapState(*(a[None] for a in got))
    merged = 0
    for w, ((pos, counts), n) in enumerate(zip(maps, ns)):
        want = jlm.filter_map(jlm.MapState(jf32(pos), jf32(counts),
                                           jnp.asarray(n, jnp.int32)),
                              COTA, DIST_THR, live_cap=live_cap)
        assert int(got.nact[w]) == int(want.nact)
        assert_equal(got.counts[w], want.counts)
        assert_equal(got.pos[w], want.pos)
        kept = int((counts[:n] >= COTA).sum())
        merged += kept - int(want.nact)
    assert merged > 0 or not any(ns)


# --- (b) no host read in a batched sweep ----------------------------------

_HOST_READS = {torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero,
               torch.ops.aten.masked_select}


class _NoHostRead(TorchDispatchMode):
    """Raises on every op that copies a tensor's value to the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in _HOST_READS:
            raise AssertionError(f"host read in a sweep: {func}")
        return func(*args, **(kwargs or {}))


@pytest.fixture
def no_host_read(monkeypatch):
    def refuse(self, *a, **k):
        raise AssertionError("Tensor.numpy / Tensor.tolist in a sweep")
    monkeypatch.setattr(torch.Tensor, "numpy", refuse)
    monkeypatch.setattr(torch.Tensor, "tolist", refuse)
    return _NoHostRead


@pytest.fixture(scope="module")
def starts():
    """The state after the init and its map filter, for one world and a
    fleet of three, with the capped (map_run_cap 128) and the uncapped
    config (L=256, cota=20)."""
    worlds = [synthetic_world(T=120, n_landmarks=10, seed=s)
              for s in (7, 10, 11)]
    out = {}
    for branch, cap in (("capped", 256), ("uncapped", 0)):
        cfg = ICMConfig(L=256, cota=20.0, N=1, map_run_cap=cap)
        data, seed, x0, merged, w = ticm.prepare_fleet(worlds, cfg, "cpu")
        assert (0 < merged.map_run_cap < merged.L) == (branch == "capped")
        for W in (1, 3):
            pick = slice(0, W)
            d = type(data)(*(a[pick] for a in data))
            s = type(seed)(*(a[pick] for a in seed))
            if W == 1:
                d, s = (type(t)(*(a[0] for a in t)) for t in (d, s))
            state, x, _ = ticm._init(d, s, x0[pick] if W > 1 else x0[0],
                                     merged, w)
            cur = tlm.filter_map(state, merged.cota, merged.dist_thr,
                                 live_cap=merged.map_run_cap)
            out[branch, W] = (ticm.hoist_compaction(d, merged), cur, x,
                              merged, w)
    return out


@pytest.mark.parametrize("W", [1, 3])
@pytest.mark.parametrize("branch", ["capped", "uncapped"])
def test_batched_sweep_reads_nothing_back(starts, no_host_read, branch, W):
    data, cur, x, cfg, w = starts[branch, W]
    with no_host_read():
        new_map, x2, wit = ticm._refine_step(data, cur, x, cfg, w)
        change = ticm.map_change(new_map, cur, live_cap=cfg.map_run_cap)
        again = tlm.filter_map(new_map, cfg.cota, cfg.dist_thr,
                               live_cap=cfg.map_run_cap)
    assert x2.shape == x.shape and wit.shape == (W, 2)[3 - x.dim():]
    assert change.shape[-1] == 3 and again.nact.shape == new_map.nact.shape
    # the loop that replays the sweep on the card runs the same sweep here
    sweeps = list(ticm.refine_sweeps(data, cur, x, cfg, w, 2, change=True))
    m1, x1, w1, c1 = sweeps[0]
    assert torch.equal(x1, x2) and torch.equal(w1, wit)
    assert torch.equal(m1.pos, new_map.pos) and torch.equal(c1, change)
    assert not ticm.uses_graph(cfg, x.device)


# --- (c) update's association takes JAX's sqrt tie rule -------------------

def test_update_takes_jax_sqrt_tie():
    """On two live columns whose d^2 differ by an ulp but whose sqrt
    rounds equal, JAX's ``update`` (``associate``) takes the first; so
    does the port's, through K2's sqrt key, while K2's d^2 contract takes
    the nearer (tests/test_torch_sequential.py)."""
    ref = _sqrt_tie()
    L = 4
    pos = np.zeros((L, 2), np.float32)
    pos[:2] = ref
    counts = np.array([3, 2, 0, 0], np.float32)
    pts = np.array([[0.0, 0.0], [5.0, 5.0], [0.0, 0.0]], np.float32)
    mask = np.array([True, True, False])
    for quirk in (True, False):
        st_j, lab_j = jlm.update(
            jlm.MapState(jf32(pos), jf32(counts), jnp.asarray(2, jnp.int32)),
            jf32(pos), jnp.asarray(2, jnp.int32), jf32(pts),
            jnp.asarray(mask), 5.0, quirk)
        st_t, lab_t = tlm.update(
            tlm.MapState(tf32(pos), tf32(counts),
                         torch.tensor(2, dtype=torch.int32)),
            tf32(pos), torch.tensor(2, dtype=torch.int32), tf32(pts),
            torch.from_numpy(mask), 5.0, quirk)
        assert int(lab_j[0]) == 0
        assert_equal(lab_t, lab_j)
        assert int(st_t.nact) == int(st_j.nact)
        assert_equal(st_t.counts, st_j.counts)
        assert_equal(st_t.pos, st_j.pos)
    lab_s, d_s = nearest_landmark_plain(tf32(pts[:1])[None], tf32(ref),
                                        torch.tensor(2, dtype=torch.int32),
                                        sqrt_key=True)
    lab_d, d_d = nearest_landmark_plain(tf32(pts[:1])[None], tf32(ref),
                                        torch.tensor(2, dtype=torch.int32))
    assert int(lab_s[0, 0]) == 0 and int(lab_d[0, 0]) == 1
    assert torch.equal(d_s, d_d)


@pytest.mark.parametrize("lanes", [1, 32])
def test_sqrt_key_plain_equals_associate(lanes):
    """Away from ties too: the sqrt key's labels and distances are
    ``associate``'s, for either lane split of the plain version; its
    launch plan is the 32-lane kernel at any point count."""
    rng = np.random.default_rng(3)
    ref = rng.uniform(-8, 8, (256, 2)).astype(np.float32)
    ref[200] = ref[13]
    pts = rng.uniform(-8, 8, (181, 2)).astype(np.float32)
    pts[:5] = ref[13]
    nact = torch.tensor(230, dtype=torch.int32)
    lab_a, d_a = tlm.associate(tf32(ref), torch.arange(256) < nact,
                               tf32(pts), torch.ones(181, dtype=torch.bool),
                               1e9)
    lab_k, d_k = nearest_landmark_plain(tf32(pts)[None], tf32(ref), nact,
                                        lanes=lanes, sqrt_key=True)
    assert_equal(lab_k[0], lab_a)
    assert_equal(d_k[0], d_a)
    assert launch_plan(1833 * 48, 1024, sqrt_key=True).lanes == 32
    assert launch_plan(1833 * 48, 1024).lanes == 1


def test_sweep_config_chooses_graph_on_card_only():
    cfg = ICMConfig()
    cuda = torch.device("cuda")
    assert ticm.uses_graph(cfg, cuda)
    assert not ticm.uses_graph(cfg, torch.device("cpu"))
    for mode in ("sequential", "ba", "windowed_ba"):
        assert not ticm.uses_graph(dataclasses.replace(cfg, sweep_mode=mode),
                                   cuda)
    from icm_slam_tpu_torch.core.energy import EnergyModel
    assert not ticm.uses_graph(dataclasses.replace(cfg, model=EnergyModel()),
                               cuda)
