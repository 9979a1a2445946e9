"""Fleet mode (``solver.icm.run_batched``) in every configuration beyond
the default one, against icm_slam_tpu.solver.icm.run_batched, and the
world axis of the causal engines and of ``models/`` under it.

Against JAX: a fleet of ``synthetic_world(T=120, n_landmarks=10, seed=s)``
for s in 7, 10, 11 (the seeds whose runs keep to JAX within the 1e-3
band; ROADMAP.md section 3) with ``ICMConfig(N=2, L=256, cota=5)`` in six
configurations: the hooks of tests/test_extensions.py on the batched init,
``sweep_mode`` ``ba`` and ``windowed_ba``, ``replicate_new_obs_quirk=
False``, ``init_mode="sequential"`` and ``sweep_mode="sequential"``.  The
golden tests/golden/torch_fleet_modes_synth.npz holds JAX's fleet (made by
tools/make_torch_golden.py; no JAX runs here): census exact per world,
x_init, x and the map within 1e-3, and the error JAX raises when a world
overflows the table, word for word.  Each world of the port's fleet is
bitwise the port's ``run()`` of that world under the merged config.

One cell is rounding-sensitive past the band, in JAX itself: world 1
(seed 10) under ``sweep_mode="ba"``.  Scaling its odometry by 1 + 1e-6
moves JAX's own init by 2.7e-4 (the port's init lies 2.7e-4 from JAX's,
at the last frame), and by 1 + 1e-5 moves JAX's BA poses by 1.7e-3; the
port's BA from JAX's init is 4.8e-7 from JAX's.  Its poses are held as
ROADMAP.md section 3 holds such worlds: census exact, ATE within 10% of
JAX's (they lie 1.0e-3 from JAX's); its x_init and map keep the band.
"""
import os

import numpy as np
import pytest
import torch

from icm_slam_tpu_torch.config import ICMConfig as TC
from icm_slam_tpu_torch.core.energy import EnergyModel
from icm_slam_tpu_torch.data.datasets import synthetic_world, world_checksum
from icm_slam_tpu_torch.mapping import landmark_map as tlm
from icm_slam_tpu_torch.models import bundle_adjustment as tba
from icm_slam_tpu_torch.models import pose_graph as tpg
from icm_slam_tpu_torch.models import windowed_ba as twba
from icm_slam_tpu_torch.ops import assoc as k2
from icm_slam_tpu_torch.solver import icm as ticm
from icm_slam_tpu_torch.solver import sweeps as tsw
from tests.torch_parity import (assert_close, assert_equal,  # noqa: F401
                                 one_thread)

# one CPU thread: these small worlds run 2-3x faster without threads
pytestmark = pytest.mark.usefixtures("one_thread")

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "torch_fleet_modes_synth.npz")
SEEDS = (7, 10, 11)
# (mode, world) whose poses JAX's own rounding moves past the band
SENSITIVE = {("ba", 1)}


def _anchor_to_odom(x, prob):
    return 5.0 * (x[:, :2] - prob.odo_cur[:, :2])


# tools/make_torch_golden.py's FLEET_MODES, the hooks in the port's
# batched convention
MODES = {"hooks": dict(init_mode="batched", model=EnergyModel(
             obs_scale=lambda dist, ang: 1.0 / (1.0 + dist),
             extra_one_sided=_anchor_to_odom,
             extra_two_sided=_anchor_to_odom)),
         "ba": dict(sweep_mode="ba"),
         "wba": dict(sweep_mode="windowed_ba", ba_window=32),
         "nq": dict(replicate_new_obs_quirk=False),
         "iseq": dict(init_mode="sequential"),
         "seq": dict(sweep_mode="sequential")}


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def worlds(golden):
    out = [synthetic_world(T=120, n_landmarks=10, seed=s) for s in SEEDS]
    for i, ds in enumerate(out):
        assert world_checksum(ds) == str(golden[f"hooks_w{i}_world_checksum"])
    return out


@pytest.fixture(scope="module", params=sorted(MODES))
def fleet(request, worlds):
    cfg = TC(N=2, L=256, cota=5.0, **MODES[request.param])
    merged = ticm.resolve_fleet_config(
        cfg, [ticm.prepare(w, cfg, "cpu") for w in worlds])
    return dict(mode=request.param, cfg=cfg, merged=merged,
                port=ticm.run_batched(worlds, cfg, "cpu"))


def test_merged_caps_are_jax_s(fleet, golden):
    m = fleet["mode"]
    assert (fleet["merged"].obs_cap, fleet["merged"].map_run_cap) == (
        int(golden[f"{m}_obs_cap"]), int(golden[f"{m}_map_run_cap"]))


def test_census_exact_per_world(fleet, golden):
    m = fleet["mode"]
    assert [r.map_pos.shape[0] for r in fleet["port"]] == \
        golden[f"{m}_census"].tolist()
    for i, r in enumerate(fleet["port"]):
        assert_equal(r.map_counts, golden[f"{m}_w{i}_map_counts"])


def test_outputs_within_1e3_of_jax(fleet, golden):
    m = fleet["mode"]
    for i, r in enumerate(fleet["port"]):
        for f in ("x_init", "x", "map_pos"):
            a = getattr(r, f)
            assert np.isfinite(a).all()
            if f == "x" and (m, i) in SENSITIVE:
                x_true = synthetic_world(T=120, n_landmarks=10, seed=SEEDS[i],
                                         return_truth=True)[1]
                ate = float(np.sqrt(((a[:, :2] - x_true[:, :2]) ** 2)
                                    .sum(1).mean()))
                ate_jax = float(golden[f"{m}_w{i}_ate_rmse"])
                assert abs(ate - ate_jax) <= 0.1 * ate_jax
                continue
            assert_close(a, golden[f"{m}_w{i}_{f}"], 1e-3)


def test_each_world_is_its_run_alone(fleet, worlds):
    """The world axis couples nothing: every world of the fleet is the
    port's ``run()`` of that world under the merged config, bitwise."""
    for ds, rb in zip(worlds, fleet["port"]):
        r1 = ticm.run(ds, fleet["merged"], "cpu")
        for f in ("x_init", "x", "map_pos", "map_counts"):
            assert_equal(getattr(rb, f), getattr(r1, f))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_a_worlds_overflow_is_named_as_jax_names_it(mode, golden):
    overflow = [synthetic_world(T=60, n_landmarks=4, seed=0),
                synthetic_world(T=60, n_landmarks=40, seed=1)]
    cfg = TC(N=1, L=12, cota=2.0, **MODES[mode])
    with pytest.raises(RuntimeError, match=r"\(world 1\)") as te:
        ticm.run_batched(overflow, cfg, "cpu")
    assert str(te.value) == str(golden[f"{mode}_overflow_message"])


def test_mesh_still_raises_naming_parallel():
    """``mesh`` runs (tests/test_torch_parallel.py); what is not a fleet
    mesh raises before any work, naming the parallel/ maker it wants."""
    worlds = [synthetic_world(T=20, n_landmarks=4, seed=s) for s in (0, 1)]
    with pytest.raises(ValueError, match="parallel.mesh.make_fleet_mesh"):
        ticm.run_batched(worlds, TC(L=256, N=1), "cpu", mesh="mesh")


# --- the world axis of one frame ---------------------------------------------

def _frame_worlds(B=40, L=64, seed=2):
    """Three worlds' frames against their tables: one with far points, one
    all masked, one matched; each world its own live count."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-10, 10, (3, L, 2)).astype(np.float32)
    nact = np.array([20, 33, L], np.int32)
    pick = rng.integers(0, 20, (3, B))
    pts = (pos[np.arange(3)[:, None], pick]
           + rng.normal(0, 0.3, (3, B, 2))).astype(np.float32)
    # two tight far clusters in world 0
    pts[0, :12] = (np.repeat([[50.0, 50.0], [60.0, 60.0]], 6, axis=0)
                   + rng.normal(0, 0.1, (12, 2))).astype(np.float32)
    mask = rng.uniform(size=(3, B)) < 0.8
    mask[0, :12] = True
    mask[1] = False                          # world 1's frame is all masked
    counts = np.where(np.arange(L) < nact[:, None],
                      rng.integers(1, 9, (3, L)), 0).astype(np.float32)
    return (torch.from_numpy(pts), torch.from_numpy(mask),
            tlm.MapState(torch.from_numpy(pos), torch.from_numpy(counts),
                         torch.from_numpy(nact)))


def test_plain_k2_per_frame_world_form_is_each_world_alone():
    """K2's per-frame fleet form (W, 1, B, L) against the one-world form
    (1, B, L) of each world: the same labels and distances, bitwise."""
    pts, _, st = _frame_worlds()
    lab, dist = k2.nearest_landmark(pts[:, None], st.pos, st.nact)
    assert lab.shape == dist.shape == (3, 1, 40)
    for w in range(3):
        one = k2.nearest_landmark(pts[w][None], st.pos[w], st.nact[w])
        assert_equal(lab[w], one[0])
        assert_equal(dist[w], one[1])


@pytest.mark.parametrize("quirk", [True, False], ids=["quirk", "components"])
def test_update_and_new_labels_per_world(quirk):
    """``allocate_new_labels`` and ``update`` on a fleet's frame: each
    world's far points, live count and new-label count its own (an
    all-masked world allocates nothing next to a world with far points),
    each world bitwise the call on that world alone."""
    pts, mask, st = _frame_worlds()
    new, labels = tlm.update(st, st.pos, st.nact, pts, mask, 1.0, quirk)
    n_new = new.nact - st.nact
    assert n_new.tolist()[1] == 0 and n_new.tolist()[0] == (1 if quirk
                                                            else 2)
    for w in range(3):
        one = tsw.world(st, w)
        new1, lab1 = tlm.update(one, one.pos, one.nact, pts[w], mask[w],
                                1.0, quirk)
        assert_equal(labels[w], lab1)
        for a, b in zip(tsw.world(new, w), new1):
            assert_equal(a, b)
    lab0 = torch.where(mask, -1, 64)
    got, n = tlm.allocate_new_labels(lab0, pts, mask, st.nact, 1.0, quirk)
    assert n.shape == (3,) and int(n[1]) == 0
    for w in range(3):
        one = tlm.allocate_new_labels(lab0[w], pts[w], mask[w], st.nact[w],
                                      1.0, quirk)
        assert_equal(got[w], one[0])
        assert int(n[w]) == int(one[1])


# --- the models' sums: add_rows gives the CPU's results of index_add_ --------

def _graph(T=60, seed=4):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(np.cumsum(rng.normal(0, 0.3, (T, 3)), 0)
                         .astype(np.float32))
    pairs = rng.integers(0, T, (12, 2))
    rel = rng.normal(0, 0.5, (12, 3)).astype(np.float32)
    return tpg.from_trajectory(x, loop_pairs=pairs, loop_rel=rel), rng


def test_pose_graph_sums_are_index_add_bitwise():
    g, rng = _graph()
    T = g.x.shape[0]
    jac = tpg._edge_jacobians(g.x, g)
    r = torch.from_numpy(rng.normal(0, 1, (g.edges_i.shape[0], 3))
                         .astype(np.float32))
    Ji, Jj = jac
    ref = torch.zeros((T, 3))
    ref.index_add_(0, g.edges_i, (Ji * r[:, :, None]).sum(dim=1))
    ref.index_add_(0, g.edges_j, (Jj * r[:, :, None]).sum(dim=1))
    assert torch.equal(tpg._jt(jac, g, r, T), ref)
    diag = torch.zeros((T, 3, 3))
    diag.index_add_(0, g.edges_i, (Ji[:, :, :, None] * Ji[:, :, None, :])
                    .sum(dim=1))
    diag.index_add_(0, g.edges_j, (Jj[:, :, :, None] * Jj[:, :, None, :])
                    .sum(dim=1))
    eye = torch.eye(3)
    diag = diag + 1e-6 * eye
    diag[0] = eye
    assert torch.equal(tpg._block_jacobi(g.x, g, jac),
                       torch.linalg.inv_ex(diag).inverse)


def _ba_world(worlds, mode):
    cfg = TC(N=1, L=256, cota=5.0, sweep_mode=mode)
    ds = worlds[1]
    data = ticm.prepare(ds, cfg, "cpu")
    rcfg = ticm.resolve_config(cfg, data)
    res = ticm.run(ds, rcfg, "cpu")
    n = res.map_pos.shape[0]
    pos = torch.zeros((256, 2))
    counts = torch.zeros((256,))
    pos[:n] = torch.from_numpy(res.map_pos)
    counts[:n] = torch.from_numpy(res.map_counts)
    cur = tlm.MapState(pos, counts, torch.tensor(n, dtype=torch.int32))
    x = torch.from_numpy(res.x + np.random.default_rng(0).normal(
        0, 0.02, res.x.shape).astype(np.float32))
    return ticm.hoist_compaction(data, rcfg), cur, x, rcfg


def test_ba_landmark_sums_are_index_add_bitwise(worlds):
    from icm_slam_tpu_torch.core.energy import weights
    data, cur, x, rcfg = _ba_world(worlds, "ba")
    prob, amap = tba.ba_problem(data, cur, x, rcfg)
    w = weights(rcfg, "cpu")
    lin = tba.linearize(prob, x, amap.pos, w)
    r_obs = lin.r[0]
    L = 256
    qw = w[1] * prob.obs_w[..., None]
    ref = torch.zeros((L + 1, 2))
    ref.index_add_(0, torch.clamp(prob.labels, max=L).long().reshape(-1),
                   (-(r_obs * qw)).reshape(-1, 2))
    assert torch.equal(lin.obs_vjp_y(r_obs), ref[:L])


def test_windowed_averages_are_index_add_bitwise(worlds, monkeypatch):
    """``_solve_windows`` with its per-frame sums as ``index_add_`` (what
    it ran before ``add_rows``) against the shipped code: bitwise."""
    from icm_slam_tpu_torch.core.energy import weights
    data, cur, x, rcfg = _ba_world(worlds, "windowed_ba")
    w = weights(rcfg, "cpu")
    data_c = tsw._per_frame_ang(data)
    _, _, matched = tsw.batched_associate(data_c, cur, x, rcfg)
    obs = (data_c.dist, data_c.ang, data_c.mask, matched)
    got = twba._solve_windows(data, obs, x, 8, 16, x.shape[0] - 1, rcfg, w)
    monkeypatch.setattr(twba, "add_rows",
                        lambda out, idx, vals: out.index_add_(0, idx, vals))
    ref = twba._solve_windows(data, obs, x, 8, 16, x.shape[0] - 1, rcfg, w)
    assert torch.equal(got, ref) and not torch.equal(got, x)


def test_ba_frame_first_sums_match_the_cpu_s(worlds, monkeypatch):
    """The card's order of BA's landmark sums (each frame's beams first,
    then the frames), run here: within 1e-4 of the CPU's one pass, for
    one world and per world of a fleet of two."""
    from icm_slam_tpu_torch.core.energy import weights
    data, cur, x, rcfg = _ba_world(worlds, "ba")
    prob, amap = tba.ba_problem(data, cur, x, rcfg)
    w = weights(rcfg, "cpu")
    fleet = [tsw.with_world_axis(a) for a in (data, cur)]
    fleet = [type(a)(*(torch.cat([f, f]) for f in a)) for a in fleet]
    prob2, amap2 = tba.ba_problem(fleet[0], fleet[1],
                                  torch.stack([x, x + 0.01]), rcfg)
    ref = tba.linearize(prob, x, amap.pos, w)
    ref2 = tba.linearize(prob2, torch.stack([x, x + 0.01]), amap2.pos, w)
    monkeypatch.setattr(tba, "_frame_first", lambda xx: True)
    got = tba.linearize(prob, x, amap.pos, w)
    got2 = tba.linearize(prob2, torch.stack([x, x + 0.01]), amap2.pos, w)
    for a, b in ((got, ref), (got2, ref2)):
        assert_close(a.gy, b.gy, 1e-4, 1e-5)
        assert_close(a.obs_vjp_y(a.r[0]), b.obs_vjp_y(b.r[0]), 1e-4, 1e-5)
        assert_close(a.rhs, b.rhs, 1e-4, 1e-5)
    assert_close(got2.gy[0], got.gy, 1e-4, 1e-5)
