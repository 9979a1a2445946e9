"""Fleet mode of the port (``solver.icm.run_batched``) against
icm_slam_tpu.solver.icm.run_batched, and the world axis under it: the
kernels' plain versions and ``filter_map`` on W worlds against the same
calls on each world alone.

The JAX fleet runs with ``use_pallas_fused_assoc=True``, so its capped
sweeps go through the fused association kernel (in interpret mode on the
CPU) under ``vmap``: the reference of the port's K1 with a world axis.
Against JAX: a fleet of three worlds of tests/test_torch_slice.py's kind
(T=240, L=256, cota=20, N=3), on the capped branch (merged cap 128: K1)
and with ``map_run_cap=0`` (K2); census exact per world; x_init, x and
the map within 1e-3 (the band JAX itself needs between fusion orders).
Its worlds are seeds 7, 10 and 11: seeds 8 and 9 of the same family
already differ from JAX by 0.03-0.09 in a run of one world (the init's
rounding sensitivity, ROADMAP.md section 3), and a fleet reproduces the
run of each world alone.  On the worlds of tests/test_fleet.py (three
uncapped worlds, and two whose solo caps differ): the merged config equal
to JAX's, and the fleet against the port's ``run(world, merged)`` within
1e-5 and 1e-4 (JAX's own bands there); the world axis against one world
at a time, bitwise.
"""
import jax
import numpy as np
import pytest
import torch

from icm_slam_tpu.config import ICMConfig as JC
from icm_slam_tpu.data.datasets import synthetic_world
from icm_slam_tpu.mapping import landmark_map as jlm
from icm_slam_tpu.solver import icm as jicm
from icm_slam_tpu_torch import convert
from icm_slam_tpu_torch.config import ICMConfig as TC
from icm_slam_tpu_torch.mapping import landmark_map as tlm
from icm_slam_tpu_torch.ops import _build
from icm_slam_tpu_torch.ops import assoc as k2
from icm_slam_tpu_torch.ops import assoc_sums as k1
from icm_slam_tpu_torch.solver import icm as ticm
from tests.torch_parity import assert_close, assert_equal
from tests.torch_parity import one_thread  # noqa: F401

# one CPU thread: these small worlds run 2-3x faster without threads
pytestmark = pytest.mark.usefixtures("one_thread")

SLICE_SEEDS = (7, 10, 11)


@pytest.fixture(scope="module", params=[128, 0], ids=["capped", "uncapped"])
def vs_jax(request):
    worlds = [synthetic_world(T=240, n_landmarks=12, seed=s)
              for s in SLICE_SEEDS]
    jc = JC(N=3, L=256, cota=20.0, dtype="float32",
            use_pallas_fused_assoc=True, map_run_cap=request.param)
    tc = convert.config_to_torch(jc)
    return dict(cap=request.param, worlds=worlds, jc=jc, tc=tc,
                jax=jicm.run_batched(worlds, jc),
                port=ticm.run_batched(worlds, tc, "cpu"))


def test_fleet_takes_the_branch(vs_jax):
    merged = ticm.resolve_fleet_config(
        vs_jax["tc"], [ticm.prepare(w, vs_jax["tc"], "cpu")
                       for w in vs_jax["worlds"]])
    assert (merged.obs_cap, merged.map_run_cap) == (48, vs_jax["cap"])


def test_census_exact_per_world(vs_jax):
    assert len(vs_jax["port"]) == len(vs_jax["jax"]) == 3
    for p, j in zip(vs_jax["port"], vs_jax["jax"]):
        assert p.map_pos.shape == j.map_pos.shape
        np.testing.assert_array_equal(p.map_counts, j.map_counts)
        assert p.changes.shape == j.changes.shape == (0, 3)


@pytest.mark.parametrize("field", ["x_init", "x", "map_pos"])
def test_outputs_within_band_of_jax(vs_jax, field):
    for p, j in zip(vs_jax["port"], vs_jax["jax"]):
        a, b = getattr(p, field), getattr(j, field)
        assert a.shape == b.shape and np.isfinite(a).all()
        assert_close(a, b, 1e-3)


def test_timings_are_shared_and_complete(vs_jax):
    t = vs_jax["port"][0].timings
    for k in ("prepare_s", "pipeline_s", "per_world_s", "init_s",
              "refine_s", "refine_per_iter_s"):
        assert t[k] >= 0.0
    assert t["per_world_s"] == pytest.approx(t["pipeline_s"] / 3)
    assert all(r.timings == t for r in vs_jax["port"])


def _three_worlds():
    return ([synthetic_world(T=300, n_landmarks=25, seed=s)
             for s in (0, 1, 2)],
            JC(N=4, L=256, cota=10.0, dtype="float32"))


def _hetero_worlds():
    return ([synthetic_world(T=256, n_landmarks=10, world_size=25.0,
                             seed=0),
             synthetic_world(T=256, n_landmarks=30, world_size=22.0,
                             seed=2)],
            JC(N=2, L=1024, cota=40.0, dtype="float32"))


FLEETS = {"three": (_three_worlds, 1e-5), "hetero": (_hetero_worlds, 1e-4)}


@pytest.fixture(scope="module", params=sorted(FLEETS))
def fleet(request):
    make, solo_tol = FLEETS[request.param]
    worlds, jc = make()
    tc = convert.config_to_torch(jc)
    return dict(name=request.param, worlds=worlds, jc=jc, tc=tc,
                solo_tol=solo_tol, port=ticm.run_batched(worlds, tc, "cpu"))


def test_resolve_fleet_config_matches_jax(fleet):
    jm = jicm.resolve_fleet_config(
        fleet["jc"], [jicm.prepare(w, fleet["jc"]) for w in fleet["worlds"]])
    tm = ticm.resolve_fleet_config(
        fleet["tc"], [ticm.prepare(w, fleet["tc"], "cpu")
                      for w in fleet["worlds"]])
    for f in ("obs_cap", "map_run_cap", "map_run_cap_checked"):
        assert getattr(tm, f) == getattr(jm, f), f
    # the three worlds merge to the uncapped branch, the others to 256
    assert tm.map_run_cap == {"three": 0, "hetero": 256}[fleet["name"]]
    if fleet["name"] == "hetero":
        solo = [ticm.resolve_config(fleet["tc"], ticm.prepare(
            w, fleet["tc"], "cpu")).map_run_cap for w in fleet["worlds"]]
        assert sorted(solo) == [128, 256]
        # run() keeps the checked merged cap
        assert ticm.resolve_config(tm, ticm.prepare(
            fleet["worlds"][0], fleet["tc"], "cpu")).map_run_cap == 256


def test_fleet_reproduces_run_with_the_merged_config(fleet):
    merged = ticm.resolve_fleet_config(
        fleet["tc"], [ticm.prepare(w, fleet["tc"], "cpu")
                      for w in fleet["worlds"]])
    for ds, rb in zip(fleet["worlds"], fleet["port"]):
        r1 = ticm.run(ds, merged, "cpu")
        assert r1.map_pos.shape == rb.map_pos.shape
        for f in ("x_init", "x", "map_pos"):
            assert_close(getattr(rb, f), getattr(r1, f), fleet["solo_tol"])


def test_three_worlds_against_the_jax_golden():
    """tests/test_fleet.py's three worlds: their runs differ from JAX's by
    up to 0.08 in the poses, alone as in a fleet (the init's rounding
    sensitivity, ROADMAP.md section 3), so they are held to the big
    world's criteria against JAX's fleet (tests/golden/
    torch_fleet_synth.npz, case ``fleet3_``): census exact per world, ATE
    within 10% of JAX's."""
    import os
    g = np.load(os.path.join(os.path.dirname(__file__), "golden",
                             "torch_fleet_synth.npz"))
    worlds, jc = _three_worlds()
    truth = [synthetic_world(T=300, n_landmarks=25, seed=s,
                             return_truth=True)[1] for s in (0, 1, 2)]
    res = ticm.run_batched(worlds, convert.config_to_torch(jc), "cpu")
    for i, (r, xt) in enumerate(zip(res, truth)):
        assert r.map_pos.shape[0] == int(g[f"fleet3_w{i}_census"])
        ate = float(np.sqrt(((r.x[:, :2] - xt[:, :2]) ** 2).sum(1).mean()))
        ate_jax = float(g[f"fleet3_w{i}_ate_rmse"])
        assert abs(ate - ate_jax) <= 0.1 * ate_jax


def test_mixed_shapes_raise_with_jax_message():
    worlds = [synthetic_world(T=300, seed=0), synthetic_world(T=301, seed=1)]
    jc = JC(N=1, L=128, cota=10.0)
    with pytest.raises(ValueError, match="identical dataset shapes") as je:
        jicm.run_batched(worlds, jc)
    with pytest.raises(ValueError, match="identical dataset shapes") as te:
        ticm.run_batched(worlds, convert.config_to_torch(jc), "cpu")
    assert str(te.value) == str(je.value)


def test_empty_fleet():
    assert ticm.run_batched([], convert.config_to_torch(JC(N=1)),
                            "cpu") == []
    from icm_slam_tpu_torch import api
    assert api.run_batched is ticm.run_batched


def test_a_worlds_overflow_is_named_as_jax_names_it():
    worlds = [synthetic_world(T=60, n_landmarks=4, seed=0),
              synthetic_world(T=60, n_landmarks=40, seed=1)]
    jc = JC(N=1, L=24, cota=2.0, dtype="float32")
    with pytest.raises(RuntimeError, match=r"\(world 1\)") as je:
        jicm.run_batched(worlds, jc)
    with pytest.raises(RuntimeError, match=r"\(world 1\)") as te:
        ticm.run_batched(worlds, convert.config_to_torch(jc), "cpu")
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("kw", [dict(mesh="mesh")], ids=["mesh"])
def test_what_fleet_mode_lacks_raises(kw, tmp_path):
    """Fleet mode lacks nothing JAX's takes: ``mesh`` shards the fleet over
    the ranks of a process group (``parallel.mesh.make_fleet_mesh``), and
    on a group of one rank (spawned, tests/torch_dist_workers.py) it
    returns the unsharded fleet, bit for bit; every configuration is
    tests/test_torch_fleet_modes.py's, the multi-rank meshes
    tests/test_torch_parallel.py's."""
    from tests import torch_dist_workers as tw
    assert kw == dict(mesh="mesh")
    got = tw.spawn(tw.one_rank_fleet_worker, 1, tmp_path, 2)[0]
    ref = ticm.run_batched(tw.fleet_worlds(2, T=20, n_landmarks=4),
                           tw.fleet_config(N=1), "cpu")
    assert len(got) == len(ref) == 2
    for r, g in zip(ref, got):
        for a, b in zip((r.x_init, r.x, r.map_pos, r.map_counts), g):
            assert np.array_equal(a, b)


# --- the world axis under the fleet ------------------------------------------

def _maps(L=64, seed=3):
    """Four worlds' tables: empty, close pairs, pruned rows, full."""
    rng = np.random.default_rng(seed)
    out = []
    for nact in (0, 20, 40, L):
        pos = rng.uniform(-10, 10, (L, 2)).astype(np.float32)
        pos[1:nact:5] = pos[0:max(nact - 1, 0):5] + 0.3  # close pairs
        counts = np.where(np.arange(L) < nact,
                          rng.integers(0, 30, L), 0).astype(np.float32)
        out.append((pos, counts, np.int32(nact)))
    return out


@pytest.mark.parametrize("live_cap", [0, 48])
def test_filter_map_world_axis_is_each_world_alone(live_cap):
    maps = _maps()
    fleet = tlm.filter_map(convert.stack_maps(
        [jlm.MapState(*m) for m in maps], "cpu"), 5.0, 1.0, live_cap)
    jfleet = jax.vmap(lambda st: jlm.filter_map(st, 5.0, 1.0, live_cap))(
        jlm.MapState(*(np.stack(f) for f in zip(*maps))))
    n_close = 0
    for w, (m, got) in enumerate(zip(maps, convert.unstack_map(fleet))):
        one = tlm.filter_map(convert.map_to_torch(jlm.MapState(*m), "cpu"),
                             5.0, 1.0, live_cap)
        for a, b in zip(got, convert.map_to_numpy(one)):
            assert_equal(a, b)
        assert int(got[2]) == int(jfleet.nact[w])
        assert_equal(got[1], jfleet.counts[w])
        assert_close(got[0], jfleet.pos[w], 1e-5)
        n_close += int(got[2]) < int((m[1] >= 5.0).sum())
    assert n_close >= 2       # the close pairs were merged in two worlds


def test_compact_data_world_axis_is_jax_per_world():
    """The stable per-frame compaction on a stacked fleet: each world as
    JAX's ``compact_data`` of that world, bitwise."""
    from icm_slam_tpu.solver import sweeps as jsw
    from icm_slam_tpu_torch.solver import sweeps as tsw
    jc = JC(dtype="float32")
    datas = [jicm.prepare(synthetic_world(T=40, n_landmarks=6, seed=s), jc)
             for s in (0, 1, 2)]
    stacked = convert.stack_sweep_data(datas, "cpu")
    assert stacked.dist.shape == (3, 40, 181) and stacked.ang.shape == \
        (3, 181)
    cap = tsw.auto_obs_cap(stacked.mask)     # the widest of the worlds
    got = tsw.compact_data(stacked, cap)
    assert got.ang.shape == (3, 40, cap)
    for w, d in enumerate(datas):
        ref = jsw.compact_data(d, cap)
        for a, b in zip(got, ref):
            assert_equal(a[w], b)


def test_add_rows_sums_in_index_order_on_the_cpu():
    """The scatter every map sum goes through adds rows that share an
    index in turn: the sequential sum, bitwise, at a size where the
    CPU's ``index_put_`` with ``accumulate`` would add across threads."""
    rng = np.random.default_rng(8)
    n = 200000
    idx = rng.integers(0, 17, n)
    vals = rng.normal(0, 1e3, (n, 3)).astype(np.float32)
    ref = np.zeros((17, 3), np.float32)
    np.add.at(ref, idx, vals)             # adds row by row, in index order
    got = tlm.add_rows(torch.zeros((17, 3)), torch.from_numpy(idx),
                       torch.from_numpy(vals))
    assert np.array_equal(got.numpy(), ref)
    one = tlm.add_rows(torch.zeros(17), torch.from_numpy(idx),
                       torch.from_numpy(vals[:, 0]))
    assert torch.equal(one, got[:, 0])


@pytest.mark.parametrize("live_cap", [0, 48])
def test_map_change_world_axis_is_each_world_alone(live_cap):
    """The sweep's map-change metric per world: each row of the fleet's
    (W, 3) the single-world call, bitwise (an empty world gives zeros)."""
    old, new = _maps(seed=3), _maps(seed=4)
    got = ticm.map_change(convert.stack_maps(
        [jlm.MapState(*m) for m in new], "cpu"), convert.stack_maps(
        [jlm.MapState(*m) for m in old], "cpu"), live_cap)
    assert got.shape == (4, 3)
    for w, (n, o) in enumerate(zip(new, old)):
        one = ticm.map_change(convert.map_to_torch(jlm.MapState(*n), "cpu"),
                              convert.map_to_torch(jlm.MapState(*o), "cpu"),
                              live_cap)
        assert torch.equal(got[w], one)
    assert torch.equal(got[0], torch.zeros(3))


def _world_inputs(W=4, T=9, B=48, K=128, seed=5):
    rng = np.random.default_rng(seed)
    mp = rng.uniform(-15, 15, (W, K + 6, 2)).astype(np.float32)
    pick = rng.integers(0, K, (W, T, B))
    pts = (mp[np.arange(W)[:, None, None], pick]
           + rng.normal(0, 0.8, (W, T, B, 2))).astype(np.float32)
    mask = rng.uniform(size=(W, T, B)) < 0.7
    nact = torch.tensor([0, 1, 57, K][:W], dtype=torch.int32)
    return (torch.from_numpy(pts), torch.from_numpy(mp)[:, :K],
            torch.from_numpy(mask), nact)


@pytest.mark.parametrize("lanes", [1, 8, 32])
def test_plain_k1_world_axis_is_each_world_alone(lanes):
    pts, mp, mask, nact = _world_inputs()
    out = k1.associate_and_sums_plain(pts, mp, mask, nact, 1.5, lanes=lanes)
    assert [tuple(a.shape) for a in out] == [(4, 9, 48), (4, 9, 48),
                                             (4, 9, 3, 128)]
    for w in range(4):
        one = k1.associate_and_sums_plain(pts[w], mp[w], mask[w], nact[w],
                                          1.5, lanes=lanes)
        for a, b in zip(out, one):
            assert torch.equal(a[w], b)
    # the wrapper on CPU tensors is the plain version, and counts nothing
    before = _build.launch_shapes("assoc_sums")
    wrapped = k1.associate_and_sums(pts, mp, mask, nact, 1.5)
    assert all(torch.equal(a, b) for a, b in zip(
        wrapped, k1.associate_and_sums_plain(pts, mp, mask, nact, 1.5)))
    assert _build.launch_shapes("assoc_sums") == before


@pytest.mark.parametrize("lanes", [1, 32])
def test_plain_k2_world_axis_is_each_world_alone(lanes):
    pts, mp, _, nact = _world_inputs(T=5, B=37)
    lab, dist = k2.nearest_landmark_plain(pts, mp, nact, lanes=lanes)
    assert lab.shape == dist.shape == (4, 5, 37)
    for w in range(4):
        one = k2.nearest_landmark_plain(pts[w], mp[w], nact[w], lanes=lanes)
        assert torch.equal(lab[w], one[0]) and torch.equal(dist[w], one[1])
    assert torch.isinf(dist[0]).all()          # world 0 has no live column
    wrapped = k2.nearest_landmark(pts, mp, nact)
    assert torch.equal(wrapped[0], lab) and torch.equal(wrapped[1], dist)


def test_world_axis_checks():
    """The checks in the world form: a (W,) count, a table per world with
    contiguous rows whose worlds start on 8-byte boundaries."""
    pts, mp, mask, nact = _world_inputs()
    out = k1._check(pts, mp, mask, nact)
    assert out[1].shape == (4, 128, 2) and not out[1].is_contiguous()
    assert _build.world_stride(mp) == 2 * 134
    k2._check(pts, mp, nact)
    with pytest.raises(ValueError):
        k2._check(pts, mp, nact[:3])                 # one count short
    with pytest.raises(ValueError):
        k1._check(pts, mp, mask, nact[0])            # 0-d count, 4 worlds
    with pytest.raises(ValueError):
        k1._check(pts, mp[:3], mask, nact)           # a table short
    flat = torch.zeros(4 * 257 + 2)
    flat = flat[(flat.data_ptr() % 8) // 4:]
    odd = flat.as_strided((4, 128, 2), (257, 2, 1))  # odd world stride
    with pytest.raises(ValueError, match="8-byte"):
        k2._check(pts, odd, nact)
    with pytest.raises(ValueError, match="contiguous"):
        k2._check(pts, mp.transpose(1, 2).contiguous().transpose(1, 2),
                  nact)
