"""Port parity of loop closure and the SE(2) pose graph
(``icm_slam_tpu_torch.models.loop_closure`` / ``pose_graph``) against the
JAX package on the CPU, and the CLI's ``--loop-close``.

Unit functions atol 1e-5 (rtol 1e-5 on values that scale with the edge
weights): relative poses, edge residuals, the closed-form per-edge
Jacobians against JAX's ``jacfwd`` blocks, the gauge-fixed H v, the
block-Jacobi blocks, one PCG solve.  The ICP gate schedule bitwise
(JAX's ``geomspace`` as the tests run it, with 64-bit types).  ICP on a
known transform: the transform to 1e-3.  ``detect``'s candidate pairs
bitwise, its ICP verdicts equal, its relatives atol 1e-4.  One
``optimize`` / ``close_loops`` call on the T=500 loop world of
tests/test_loop_closure.py: accepted pairs and report rows equal, poses
atol 1e-3.  The CLI on the default synthetic world: the closure count
and census equal, poses within the band the ICM run before the closure
leaves there (see test_cli_loop_close_matches_jax).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icm_slam_tpu import cli as jcli
from icm_slam_tpu.config import ICMConfig as JC
from icm_slam_tpu.data.datasets import drifted_world, synthetic_world
from icm_slam_tpu.models import loop_closure as jlc
from icm_slam_tpu.models import pose_graph as jpg
from icm_slam_tpu.solver import icm as jicm
from icm_slam_tpu_torch import cli as tcli
from icm_slam_tpu_torch import convert
from icm_slam_tpu_torch.models import loop_closure as tlc
from icm_slam_tpu_torch.models import pose_graph as tpg
from icm_slam_tpu_torch.solver import icm as ticm
from tests.torch_parity import assert_close, assert_equal, jf32, tf32
from tests.torch_parity import one_thread  # noqa: F401

# one CPU thread: these small worlds run 2-3x faster without threads
pytestmark = pytest.mark.usefixtures("one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAND = 1e-3


def _rel_close(a, b, rtol=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * np.abs(b).max())


# --- pose graph --------------------------------------------------------------

@pytest.fixture(scope="module")
def graph():
    """A noisy chain of 40 poses with three loop edges, in both packages."""
    rng = np.random.default_rng(5)
    T = 40
    th = np.cumsum(rng.normal(0, 0.2, T))
    xy = np.cumsum(np.stack([np.cos(th), np.sin(th)], 1), 0)
    x_true = np.concatenate([xy, th[:, None]], 1).astype(np.float32)
    x = (x_true + rng.normal(0, 0.1, x_true.shape)).astype(np.float32)
    pairs = np.array([[0, 30], [5, 36], [12, 39]], np.int32)
    rel = np.asarray(jpg.relative_se2(jf32(x_true[pairs[:, 0]]),
                                      jf32(x_true[pairs[:, 1]])))
    odo = np.asarray(jpg.relative_se2(jf32(x_true[:-1]), jf32(x_true[1:])))
    odo = (odo + rng.normal(0, 0.02, odo.shape)).astype(np.float32)
    g_j = jpg.from_trajectory(jf32(x), odom_rel_noise=jf32(odo),
                              loop_pairs=pairs, loop_rel=jf32(rel),
                              odo_weight=5.0, loop_weight=20.0)
    g_t = tpg.from_trajectory(tf32(x), odom_rel_noise=tf32(odo),
                              loop_pairs=pairs, loop_rel=rel.copy(),
                              odo_weight=5.0, loop_weight=20.0)
    return g_j, g_t, x


def test_relative_se2_matches_jax():
    rng = np.random.default_rng(0)
    xi = rng.normal(0, 3, (50, 3)).astype(np.float32)
    xj = rng.normal(0, 3, (50, 3)).astype(np.float32)
    assert_close(tpg.relative_se2(tf32(xi), tf32(xj)),
                 jpg.relative_se2(jf32(xi), jf32(xj)), 1e-5)


def test_from_trajectory_matches_jax(graph):
    g_j, g_t, _ = graph
    for f in ("edges_i", "edges_j"):
        assert_equal(getattr(g_t, f), getattr(g_j, f))
    for f in ("x", "rel", "weight"):
        assert_close(getattr(g_t, f), getattr(g_j, f), 1e-6)
    # without measurements the chain measures the trajectory itself
    x = graph[2]
    assert_close(tpg.from_trajectory(tf32(x)).rel,
                 jpg.from_trajectory(jf32(x)).rel, 1e-5)


def test_edge_residuals_match_jax(graph):
    g_j, g_t, x = graph
    assert_close(tpg.edge_residuals(tf32(x), g_t),
                 jpg.edge_residuals(jf32(x), g_j), 1e-5)


def test_edge_jacobians_match_jacfwd(graph):
    """The closed-form blocks against jacfwd of the JAX edge residual."""
    g_j, g_t, x = graph
    xj = jf32(x)

    def edge(i, j, rel, wgt, xi, xk):
        ge = jpg.PoseGraph(jnp.stack([xi, xk]), jnp.zeros(1, jnp.int32),
                           jnp.ones(1, jnp.int32), rel[None], wgt[None])
        return jpg.edge_residuals(jnp.stack([xi, xk]), ge)[0]
    Ji = jax.vmap(jax.jacfwd(edge, 4))(g_j.edges_i, g_j.edges_j, g_j.rel,
                                       g_j.weight, xj[g_j.edges_i],
                                       xj[g_j.edges_j])
    Jj = jax.vmap(jax.jacfwd(edge, 5))(g_j.edges_i, g_j.edges_j, g_j.rel,
                                       g_j.weight, xj[g_j.edges_i],
                                       xj[g_j.edges_j])
    Ji_t, Jj_t = tpg._edge_jacobians(tf32(x), g_t)
    _rel_close(Ji_t, Ji)
    _rel_close(Jj_t, Jj)


@pytest.mark.parametrize("seed", [0, 1])
def test_hvp_matches_jax(graph, seed):
    g_j, g_t, x = graph
    v = np.random.default_rng(seed).normal(size=x.shape).astype(np.float32)
    out_t = tpg._hvp(tf32(x), g_t, tf32(v))
    out_j = jpg._hvp(jf32(x), g_j, jf32(v))
    assert float(out_t[0].abs().max()) == 0.0        # node 0 is anchored
    _rel_close(out_t, out_j)


def test_block_jacobi_matches_jax(graph):
    g_j, g_t, x = graph
    _rel_close(tpg._block_jacobi(tf32(x), g_t),
               jpg._block_jacobi(jf32(x), g_j), 1e-4)


@pytest.mark.parametrize("iters", [5, 60])
def test_pcg_one_solve_matches_jax(iters):
    """One PCG solve of the same SPD system with the same block-diagonal
    preconditioner (f32 dot products in another order)."""
    rng = np.random.default_rng(iters)
    n = 30
    M = rng.normal(size=(3 * n, 3 * n))
    A = (M @ M.T / (3 * n) + np.eye(3 * n)).astype(np.float32)
    b = rng.normal(size=(n, 3)).astype(np.float32)
    blocks = A.reshape(n, 3, n, 3)[np.arange(n), :, np.arange(n), :]
    minv = np.linalg.inv(blocks).astype(np.float32)
    x_j = jpg._pcg(lambda v: (jf32(A) @ v.reshape(-1)).reshape(n, 3),
                   jf32(b), jf32(minv), iters)
    x_t = tpg._pcg(lambda v: (tf32(A) @ v.reshape(-1)).reshape(n, 3),
                   tf32(b), lambda r: tpg.apply_blocks(tf32(minv), r), iters)
    _rel_close(x_t, x_j, 1e-4)
    if iters == 60:
        assert_close(x_t, np.linalg.solve(A, b.reshape(-1)).reshape(n, 3),
                     1e-4)


def test_optimize_matches_jax(graph):
    g_j, g_t, x = graph
    x_j, n_j = jpg.optimize(g_j, gn_iters=6, cg_iters=60)
    x_t, n_t = tpg.optimize(g_t, gn_iters=6, cg_iters=60)
    assert_close(x_t, x_j, BAND)
    _rel_close(n_t, n_j, 1e-3)
    assert_equal(x_t[0], x[0])                       # node 0 is anchored
    assert (np.diff(n_t.numpy()) <= 0).all()         # steps only go down


# --- ICP and detection -------------------------------------------------------

@pytest.mark.parametrize("gate,coarse,iters", [
    (1.0, None, 8), (1.0, 4.0, 8), (0.5, 3.0, 12), (2.0, 8.0, 5)])
def test_gate_schedule_bitwise(gate, coarse, iters):
    want = np.asarray(jnp.geomspace(coarse if coarse else gate, gate,
                                    iters).astype(jnp.float32))
    got = tlc.gate_schedule(gate, coarse, iters)
    assert got.dtype == np.float32
    assert_equal(got, want)


def test_icp_register_recovers_known_transform():
    """tests/test_loop_closure.py's case, three pairs in one batch."""
    rng = np.random.default_rng(0)
    B = 64
    pts_i = rng.uniform(-4, 4, (B, 2))
    rels = np.array([[0.4, -0.3, 0.2], [-0.2, 0.5, -0.15],
                     [0.1, 0.1, 0.05]])
    pts_j = []
    for r in rels:
        c, s = np.cos(-r[2]), np.sin(-r[2])
        sh = pts_i - r[:2]
        pts_j.append(np.stack([c * sh[:, 0] - s * sh[:, 1],
                               s * sh[:, 0] + c * sh[:, 1]], 1))
    K = len(rels)
    mask = torch.ones((K, B), dtype=torch.bool)
    est, frac, rms = tlc.icp_register(
        tf32(np.stack([pts_i] * K)), mask, tf32(np.stack(pts_j)), mask,
        tf32(rels + np.array([-0.1, 0.1, -0.1])))
    assert_close(est, rels.astype(np.float32), 1e-3)
    assert bool((frac > 0.95).all()) and bool((rms < 1e-3).all())


def test_icp_register_matches_jax():
    """Partial masks and a coarse-to-fine gate, against JAX's vmap."""
    rng = np.random.default_rng(4)
    K, B = 5, 48
    pts_i = rng.uniform(-5, 5, (K, B, 2)).astype(np.float32)
    rel = rng.normal(0, [0.5, 0.5, 0.2], (K, 3)).astype(np.float32)
    c, s = np.cos(-rel[:, 2:3]), np.sin(-rel[:, 2:3])
    sh = pts_i - rel[:, None, :2]
    pts_j = (np.stack([c * sh[..., 0] - s * sh[..., 1],
                       s * sh[..., 0] + c * sh[..., 1]], -1)
             + rng.normal(0, 0.02, (K, B, 2))).astype(np.float32)
    mask_i = rng.uniform(size=(K, B)) < 0.8
    mask_j = rng.uniform(size=(K, B)) < 0.8
    rel0 = (rel + rng.normal(0, 0.3, rel.shape)).astype(np.float32)
    out_j = jax.vmap(lambda a, b, c_, d, e: jlc.icp_register(
        a, b, c_, d, e, gate=0.5, coarse_gate=2.0))(
        jf32(pts_i), jnp.asarray(mask_i), jf32(pts_j), jnp.asarray(mask_j),
        jf32(rel0))
    out_t = tlc.icp_register(tf32(pts_i), torch.from_numpy(mask_i),
                             tf32(pts_j), torch.from_numpy(mask_j),
                             tf32(rel0), gate=0.5, coarse_gate=2.0)
    assert_close(out_t[0], out_j[0], 1e-4)
    # inlier fractions: the same counts (JAX divides in float64 here)
    assert_close(out_t[1], np.float32(out_j[1]), 0.0)
    assert_close(out_t[2], out_j[2], 1e-5)


def test_nearest_keeps_first_minimum_and_inf():
    """Masked points never match (inf where none is valid); of two equal
    distances the first column wins, as jnp.argmin."""
    pts_i = tf32([[[1.0, 0.0], [-1.0, 0.0], [1.0, 0.0], [0.0, 3.0]]])
    q = tf32([[[0.0, 0.0], [0.0, 2.9]]])
    idx, d = tlc._nearest(q, pts_i, torch.tensor([[True, True, True, False]]))
    assert idx.tolist() == [[0, 0]]
    assert_close(d, [[1.0, float(np.hypot(1.0, 2.9))]], 1e-6)
    idx, d = tlc._nearest(q, pts_i, torch.zeros((1, 4), dtype=torch.bool))
    assert bool(torch.isinf(d).all())


@pytest.fixture(scope="module")
def loop_world():
    ds = synthetic_world(T=500, n_landmarks=25, seed=7, loop=True)
    jc = JC(L=128, cota=10.0, dtype="float32")
    tc = convert.config_to_torch(jc)
    return ds, jc, tc, jicm.prepare(ds, jc), ticm.prepare(ds, tc, "cpu")


def _drifted(ds, scale):
    drift = np.zeros((ds.T, 3))
    drift[:, 0] = np.linspace(0, 0.8 * scale, ds.T)
    drift[:, 1] = np.linspace(0, -0.5 * scale, ds.T)
    return (ds.odom + drift).astype(np.float32)


def test_detect_matches_jax(loop_world):
    ds, _, _, jd, td = loop_world
    x = _drifted(ds, 1.0)
    cl_j = jlc.detect(jd, jf32(x), min_gap=150, radius=3.0)
    cl_t = tlc.detect(td, tf32(x), min_gap=150, radius=3.0)
    assert cl_t.pairs.shape[0] >= 1
    assert_equal(cl_t.pairs, cl_j.pairs)
    assert_close(cl_t.rel, cl_j.rel, 1e-4)
    assert_close(cl_t.inliers, np.float32(cl_j.inliers), 0.0)
    assert_close(cl_t.rms, cl_j.rms, 1e-5)
    d_j = jlc.estimate_correctable_drift(jf32(x), jf32(ds.odom), cl_j)
    d_t = tlc.estimate_correctable_drift(tf32(x), tf32(ds.odom), cl_t)
    np.testing.assert_allclose(d_t, d_j, atol=1e-4)


def test_detect_without_candidates_is_empty(loop_world):
    ds, _, _, _, td = loop_world
    cl = tlc.detect(td, tf32(ds.odom), min_gap=10_000)
    assert cl.pairs.shape == (0, 2) and cl.rel.shape == (0, 3)


@pytest.mark.parametrize("scale", [1.0, 0.0625])
def test_close_loops_matches_jax(loop_world, scale):
    """High drift: the round applies; 5 cm of drift: the regime guard
    no-ops and hands back the estimate itself (bitwise)."""
    ds, jc, tc, jd, td = loop_world
    x = _drifted(ds, scale)
    rep_j, rep_t = {}, {}
    xj, cl_j = jlc.close_loops(jd, jf32(x), jc, min_gap=150, radius=3.0,
                               report=rep_j)
    xt, cl_t = tlc.close_loops(td, tf32(x), tc, min_gap=150, radius=3.0,
                               report=rep_t)
    assert_equal(cl_t.pairs, cl_j.pairs)
    assert len(rep_t["rounds"]) == len(rep_j["rounds"]) == 1
    row_t, row_j = rep_t["rounds"][0], rep_j["rounds"][0]
    for k in ("n_closures", "guarded", "applied"):
        assert row_t[k] == row_j[k]
    for k in ("est_drift_m", "gate_m", "d_x_m", "d_odo_m", "noise_rms_m"):
        assert row_t[k] == pytest.approx(row_j[k], abs=2e-4)
    assert_close(xt, xj, BAND)
    assert row_t["applied"] == (scale == 1.0)
    if not row_t["applied"]:
        assert_equal(xt, x)


def test_close_loops_rounds_on_real_drift():
    """tests/test_loop_closure.py's two-lap drifted world, two rounds:
    every round's row and the final pairs as JAX's."""
    ds, x_true, _ = drifted_world(T=600, n_landmarks=90, world_size=35.0,
                                  seed=5, w_bias=0.004, laps=2)
    jc = JC(L=256, cota=10.0, dtype="float32")
    tc = convert.config_to_torch(jc)
    kw = dict(min_gap=120, radius=5.0, icp_coarse_gate=4.0, gn_iters=15,
              cg_iters=300, rounds=2)
    rep_j, rep_t = {}, {}
    xj, cl_j = jlc.close_loops(jicm.prepare(ds, jc), jf32(ds.odom), jc,
                               report=rep_j, **kw)
    xt, cl_t = tlc.close_loops(ticm.prepare(ds, tc, "cpu"), tf32(ds.odom),
                               tc, report=rep_t, **kw)
    assert [(r["n_closures"], r["applied"]) for r in rep_t["rounds"]] == \
        [(r["n_closures"], r["applied"]) for r in rep_j["rounds"]]
    assert_equal(cl_t.pairs, cl_j.pairs)
    assert_close(xt, xj, BAND)

    def ate(x):
        return float(np.mean(np.linalg.norm(np.asarray(x)[:, :2]
                                            - x_true[:, :2], axis=1)))
    assert ate(xt) < 0.6 * ate(ds.odom)


def test_cli_loop_close_matches_jax(tmp_path, capsys):
    """``run --loop-close`` through both CLIs on 600 frames of the default
    synthetic world (one closure): the printed closure count and the
    census as JAX's, the closed poses within 1e-2.  The ICM run before
    the closure already differs by 8.8e-3 between the packages on this
    world (the main path's rounding sensitivity, ROADMAP section 3); the
    closure itself is held at 1e-3 by test_close_loops_matches_jax."""
    common = ["run", "--dataset", "synthetic", "--frames", "600",
              "--config", os.path.join(REPO, "configs", "reference.yaml"),
              "--iters", "1", "--loop-close"]
    jcli.main(common + ["--cpu", "--pallas-fused",
                        "--out", str(tmp_path / "j.npz")])
    out_j = capsys.readouterr().out
    tcli.main(common + ["--device", "cpu", "--out", str(tmp_path / "t.npz")])
    out_t = capsys.readouterr().out

    def count(out):
        lines = [ln for ln in out.splitlines()
                 if ln.startswith("# loop closures accepted:")]
        assert len(lines) == 1, out
        return int(lines[0].split(":")[1])
    assert count(out_t) == count(out_j) == 1
    assert json.loads(out_t.strip().splitlines()[-1])["frames"] == 600
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert t["map_pos"].shape == j["map_pos"].shape
        assert_close(t["x"], j["x"], 1e-2)
