"""CPU tests of the windowed-BA cell's pieces: the plain reference
``reference/wba.py`` against the program's ``sweep_mode="windowed_ba"``,
its analytic window Jacobian against autograd, the check's
``refine_shift_gap`` against a refinement redone from the answer's own
start (``entries/run_wba.py``), and the readers of the
windowed-BA spans and counters.  At the cell's own size the readings are
taken on the card by ``slambench/control.py``.

    python -m pytest slambench/tests/test_slambench_wba.py -q
"""
import dataclasses
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

from slambench.entries import run_wba  # noqa: E402
from slambench.harness import bench, drive, tracing  # noqa: E402
from slambench.harness.registry import Registry  # noqa: E402
from slambench.harness.worlds import synthetic_world  # noqa: E402
from slambench.reference import compare, icm  # noqa: E402
from slambench.reference import wba  # noqa: E402

CELL = "grove_wba.offline"
SMALL = dict(N=4, L=256, cota=20.0, ba_window=16)
# seeds whose small worlds the port's init and the reference's reach the
# same optimum (no knife-edge association flips between them)
SEEDS = (7, 10, 11)


@pytest.fixture(autouse=True)
def _one_thread(one_thread):
    yield


def _port(world):
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.data.datasets import Dataset
    from icm_slam_tpu_torch.solver.icm import run
    r = run(Dataset(world.scans, world.odom, world.u, world.x0),
            ICMConfig(sweep_mode="windowed_ba", **SMALL), "cpu")
    return (r.x_init, r.x, r.map_pos, r.map_counts)


def _shift_gap(world, ans, p):
    redone = wba.refine_from(world, ans[0], ans[2], ans[3], p, "cpu")
    return run_wba.shift_gap(ans[0], ans[1], redone)


def _answer(r):
    return (r.x_init, r.x, r.map_pos, r.map_counts)


# The tolerances, each with its reason:
# * x_gap_median, init_gap_median 1e-3 m: float32 rounding of the same
#   semantics by two routes (beam compaction against the full beam axis,
#   forward-mode against analytic Jacobians, LU against elimination)
#   leaves a frame's widest pose gap ~1e-4 m at the median (readings
#   2.7e-5 to 9.5e-5);
# * the widest gap of any pose 5e-3: the band the JAX package holds its
#   own windowed BA to, against itself (its dense f32 solves move it by
#   1.2e-3; readings 2.9e-4 to 1.8e-3);
# * refine_shift_gap 0.05: the refinement's median shift agrees to a few
#   parts in 1e4 (readings 8e-5 to 4.9e-4).
TOL = {"x_gap_median": 1e-3, "init_gap_median": 1e-3,
       "refine_shift_gap": 0.05}
WIDEST = 5e-3


def _within(ans, r):
    g = compare.gaps(ans, r)
    g["widest"] = float(max(np.abs(ans[0] - r.x_init).max(),
                            np.abs(ans[1] - r.x).max()))
    ok = all(g[n] <= lim for n, lim in TOL.items()) and g["widest"] <= WIDEST
    return ok, g


@pytest.mark.parametrize("seed", SEEDS)
def test_the_port_agrees_with_the_reference(seed):
    """The port's ``run()`` in ``windowed_ba`` mode against
    ``wba.offline`` on poses, initial poses and refine shift, and the
    same map; the reference in bfloat16, in the port's place, fails the
    tolerances."""
    world = synthetic_world(T=240, n_landmarks=12, seed=seed)
    p = wba.Params(**SMALL)
    r = wba.offline(world, p, "cpu")
    ok, g = _within(_port(world), r)
    assert ok, g
    ans = _port(world)
    assert len(ans[2]) == len(r.map_pos), g
    near = np.sqrt(((ans[2][:, None] - r.map_pos[None]) ** 2).sum(-1))
    assert near.min(1).max() < 2e-3, g
    bf16 = wba.offline(world, p, "cpu", dtype=torch.bfloat16)
    assert np.isfinite(bf16.x).all()
    ok, g = _within(_answer(bf16), r)
    assert not ok, g


def test_the_analytic_window_jacobian_is_autograds():
    """``Windows.jacobian`` against ``torch.autograd.functional.jacobian``
    of ``Windows.residual`` on random windows in float64, with masked
    beams, a frame past the trajectory's end and a window with no frame
    after it."""
    g = torch.Generator().manual_seed(3)
    n, W, B = 2, 5, 7
    dt = torch.float64

    def r(*s):
        return torch.rand(s, generator=g, dtype=dt)
    ok = torch.ones((n, W), dtype=torch.bool)
    ok[1, -1] = False
    win = wba.Windows(
        r(n, W, B) * 8.0, r(n, W, B) * 3.0,
        (r(n, W, B) < 0.7) & ok[..., None],
        r(n, W, B, 2) * 10.0, r(n, W, 2), r(n, W, 3) * 10.0,
        r(n, 3) * 10.0, r(n, 3) * 10.0, r(n, 3) * 10.0, r(n, 2),
        r(n, 3) * 10.0, ok, torch.tensor([True, False]))
    p = wba.Params(Q=(1.0, 2.0), R=(1.0, 3.0, 0.5), cte_odom=2.0)
    w = icm.Weights(p, dt, "cpu")
    x = r(n, W, 3) * 10.0
    J = win.jacobian(x, w)
    for i in range(n):
        def one(flat, i=i):
            xx = x.clone()
            xx[i] = flat.reshape(W, 3)
            return win.residual(xx, w)[i]
        want = torch.autograd.functional.jacobian(one, x[i].reshape(-1))
        assert J[i].shape == want.shape
        torch.testing.assert_close(J[i], want, rtol=1e-12, atol=1e-12)
    # the frame past the end and the edge out of the second window are
    # not free: no row depends on that frame's pose
    assert not J[1, :, 3 * (W - 1):].any()


def test_solve_is_the_dense_solution():
    g = torch.Generator().manual_seed(5)
    M = torch.rand((3, 12, 12), generator=g, dtype=torch.float64)
    A = M @ M.transpose(1, 2) + 0.1 * torch.eye(12, dtype=torch.float64)
    b = torch.rand((3, 12), generator=g, dtype=torch.float64)
    torch.testing.assert_close(wba.solve(A, b), torch.linalg.solve(A, b))


def test_refine_shift_gap_reads_the_refinement_from_its_own_start():
    """``refine_from`` redoes the reference's N sweeps from an answer's
    initial poses, with its final map as the first sweep's map: for the
    reference's own answer that is its own refinement (the final map
    associates every beam as the post-init map did, on these worlds), so
    it reads 0; an answer whose refinement was left out (the control's
    ``no_refine`` fault) reads 1 exactly, one that moved every pose the
    other way 2, and the port's answer (another route in float32) a few
    parts in 1e3 at most."""
    p = wba.Params(**SMALL)
    for seed in SEEDS:
        world = synthetic_world(T=240, n_landmarks=12, seed=seed)
        r = wba.offline(world, p, "cpu")
        assert _shift_gap(world, _answer(r), p) == 0.0
        skip = wba.offline(world, p.replace_n(0), "cpu")
        assert _shift_gap(world, _answer(skip), p) == 1.0
        back = 2 * r.x_init - r.x
        assert _shift_gap(world, (r.x_init, back, r.map_pos, r.map_counts),
                          p) == pytest.approx(2.0)
        assert _shift_gap(world, _port(world), p) < 5e-3
    assert run_wba.shift_gap(r.x_init, r.x * np.nan, r.x) == np.inf
    assert run_wba.shift_gap(r.x_init, r.x[1:], r.x) == np.inf


def test_from_solver_takes_windowed_ba_only():
    cfg = Registry().config("grove_wba_t1833")
    p = wba.Params.from_solver(cfg["solver"])
    assert (p.ba_window, p.ba_gn_iters, p.N) == (64, 4, 30)
    assert p.replace_n(0).ba_window == 64
    with pytest.raises(ValueError, match="sweep_mode='windowed_ba'"):
        wba.Params.from_solver(dict(cfg["solver"], sweep_mode="batched"))
    # the batched reference refuses the configuration
    with pytest.raises(ValueError, match="sweep_mode='batched'"):
        icm.Params.from_solver(cfg["solver"])


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from slambench.reference import wba\n"
            "import torch\n"
            "assert not torch.backends.cuda.matmul.allow_tf32\n"
            "assert not torch.backends.cudnn.allow_tf32\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    mods = json.loads(out.stdout.strip().replace("'", '"'))
    assert not {"icm_slam_tpu_torch", "icm_slam_tpu", "jax", "jaxlib",
                "flax"} & set(mods)


# the cell at a small size: every number its check holds, a sound run
# correct, the bf16 control out of the limits
CELL_SMALL = {"world": {"T": 240, "n_landmarks": 12},
              "solver": {"N": 30, "L": 256, "cota": 20.0, "ba_window": 16}}


def test_the_cell_runs_and_holds_its_numbers():
    res, rows = bench.run_cell(CELL, 85300751, 0.3, False,
                               time.perf_counter(), device="cpu",
                               overrides=CELL_SMALL, log=lambda m: None)
    limits = Registry().limits(CELL)["limits"]
    assert set(res["checks"]) == set(limits) == {
        "x_gap_median", "init_gap_median", "refine_shift_gap"}
    assert res["correct"], res["checks"]


# the bf16 control at a size where the poses run as far from the origin
# as a third of the cell's (bfloat16's rounding of a pose grows with it)
CELL_MID = {"world": {"T": 600, "n_landmarks": 12},
            "solver": {"N": 30, "L": 256, "cota": 20.0, "ba_window": 16}}


def test_the_bf16_control_fails_the_cells_limits():
    reg = Registry()
    config = bench._merge(reg.config("grove_wba_t1833"), CELL_MID)
    gen = reg.generator("offline_wba", config, 85300751, "cpu")
    limits = reg.limits(CELL)["limits"]
    k = 0
    f32 = gen.reference(k, gen.params)
    bf16 = gen.reference(k, gen.params, torch.bfloat16)
    got = gen.numbers(k, _answer(bf16), f32, gen.params)
    assert any(not got[n] <= limits[n] for n in limits), got


def test_a_run_of_the_cell_loads_no_jax():
    """The harness, the program, the windowed-BA reference and entry on
    the cell at a small size load no JAX and no JAX package (a fresh
    process)."""
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(1)\n"
        "from slambench.harness import bench, guard\n"
        "res, _ = bench.run_cell(%r, 4, 0.3, True, time.perf_counter(), "
        "device='cpu', overrides=%r, log=lambda m: None)\n"
        "assert res['correct'], res\n"
        "print(guard.forbidden_modules())\n") % (str(ROOT), CELL, CELL_SMALL)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


# the readers of the windowed-BA spans and counters, on hand-made contexts

def _req(**t):
    return drive.Request([0], [], 0.0, 1.0, 100, t)


PARENT = {"prepare_s": 0.01, "init_s": 0.1, "init_capture_s": 0.0,
          "hoist_s": 0.0, "refine_s": 5.0, "capture_s": 0.0,
          "refine_per_iter_s": 0.17, "graph_hits": 1}
OURS = dict(PARENT, wba_passes=60, wba_windows=1740, wba_steps=6960,
            wba_accepted=5220, wba_pass_s=3.0, wba_rows=6960 * 5510,
            wba_cols=6960 * 192)


def _read(metric, requests, trace=None, cell=CELL):
    ctx = bench.Context(cell, {}, 1.0, requests, trace)
    return Registry().reader(metric)(ctx)


def test_pass_ms_and_accept_share_read_the_counters():
    reqs = [_req(**OURS), _req(**dict(OURS, wba_pass_s=6.0,
                                      wba_accepted=6960))]
    assert _read("wba_pass_ms", reqs) == pytest.approx(
        (3000 / 60 + 6000 / 60) / 2)
    assert _read("wba_accept_share", reqs) == pytest.approx(
        (5220 + 6960) / (2 * 6960))


@pytest.mark.parametrize("metric", ["wba_pass_ms", "wba_accept_share",
                                    "wba_pass_launches",
                                    "wba_normal_roofline"])
def test_readers_give_none_on_a_parents_timings_and_trace(metric):
    """A program without the counters and spans (the parent's), or with no
    trace: nothing to read."""
    empty = tracing.Trace([], [(0, 1)], (0, 10 ** 6), {}, [], [])
    assert _read(metric, [_req(**PARENT)], empty) is None
    assert _read(metric, [_req(**PARENT)], None) is None
    assert _read(metric, [], None) is None


MS = 10 ** 6


def _ev(name, start, end):
    return tracing.Event(name, start, end)


def test_pass_launches_counts_launches_inside_the_passes():
    spans = [_ev("icm.run", 0, 20 * MS),
             _ev("icm.wba.pass", 1 * MS, 3 * MS),
             _ev("icm.wba.normal", 2 * MS, 2 * MS + 10),
             _ev("icm.wba.pass", 5 * MS, 6 * MS)]
    host = [_ev("cudaLaunchKernel", 1 * MS + 5, 1 * MS + 9),          # 1
            _ev("cudaLaunchKernelExC", 2 * MS + 1, 2 * MS + 2),       # 1
            _ev("cuLaunchKernel", 5 * MS, 5 * MS + 3),                # 2
            _ev("cudaLaunchKernel", 4 * MS, 4 * MS + 3),      # between
            _ev("cudaMalloc", 5 * MS + 10, 5 * MS + 13),      # no launch
            _ev("cudaLaunchKernel", 7 * MS, 7 * MS + 3)]      # after
    t = tracing.Trace([], [(0, 1)], (0, 20 * MS), {}, host, spans)
    assert _read("wba_pass_launches", [], t) == pytest.approx(3 / 2)


def test_normal_roofline_counts_by_hand():
    """The operations and bytes of window systems: J (m, k) and r (m,)
    read once, H (k, k) and the step (k,) written once; J^T J 2 m k^2,
    J^T r 2 m k, the LU solve (2/3) k^3 + 2 k^2 flops a system."""
    from slambench.harness.bounds import PEAK_BYTES_PER_S, PEAK_F32_FLOPS
    mod = sys.modules[Registry().reader("wba_normal_roofline").__module__]
    n, m, k = 29, 6534, 192
    flops = 29 * (2 * 6534 * 192 * 192 + 2 * 6534 * 192
                  + 2 * 192 ** 3 / 3 + 2 * 192 * 192)
    assert flops == pytest.approx(14.18e9, rel=1e-3)
    byts = 4 * 29 * (6534 * 192 + 6534 + 192 * 192 + 192)
    want = 1e6 * max(flops / PEAK_F32_FLOPS, byts / PEAK_BYTES_PER_S)
    assert mod.solve_bound_us(n, n * m, k) == pytest.approx(want)
    assert want == pytest.approx(1e6 * flops / PEAK_F32_FLOPS)
    # systems of two heights: each counted at its own
    two = 1e6 * 2 * (2 * 100 * 9 + 2 * 100 * 3 + 2 * 27 / 3 + 18
                     + 2 * 300 * 9 + 2 * 300 * 3 + 2 * 27 / 3 + 18)
    assert mod.solve_bound_us(4, 800, 3) == pytest.approx(
        max(two / PEAK_F32_FLOPS,
            1e6 * 4 * (800 * 3 + 800 + 4 * 12) / PEAK_BYTES_PER_S))
    # a tall thin system is bound by its bytes
    assert mod.solve_bound_us(1, 10 ** 6, 3) == pytest.approx(
        1e6 * 4 * (3e6 + 1e6 + 9 + 3) / PEAK_BYTES_PER_S)


def _kernel(name, start, us):
    return tracing.Event(name, start, start + int(us * 1000))


def test_normal_roofline_reads_bound_over_the_solves_kernels():
    """Two traced requests (two ``icm.run`` spans) of two passes of one LM
    step each: their timings (the window's first two requests) count four
    batched solves; the kernels the card's trace names for them (a GEMM
    and a GEMV, the LU's) are timed, kernels of other work left out."""
    mod = sys.modules[Registry().reader("wba_normal_roofline").__module__]
    one = [("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8", 300),
           ("void gemv2T_kernel_val<int, int, float, float>", 50),
           ("magma_iset_pointer_kernel(int**, int*, int, int, int, int)", 1),
           ("void sgetf2_fused_batched_kernel<16>(int, float**, int)", 300),
           ("slaswp_rowparallel_kernel_batched(int, int, int, float**)", 400),
           ("void batch_trsm_left_kernel<float, 64, 4, 3, false>", 100),
           ("zdisplace_pointers_kernel(float**, float**, int, int, int)", 200)]
    others = [("void at::native::elementwise_kernel<128, 2>", 900),
              ("_anonymous_namespace_::pose_lm_kernel", 30)]
    ks, t0 = [], 0
    for _ in range(4):
        for name, us in one + others:
            ks.append(_kernel(name, t0, us))
            t0 += 10 ** 7
    spans = [_ev("icm.run", 0, t0 // 2), _ev("icm.run", t0 // 2, t0)]
    t = tracing.Trace(ks, [(0, 1)], (0, t0), {}, [], spans)
    # a request: 29 windows a pass, 2 passes, 1 LM step; B = 40 and 80
    reqs = [_req(**dict(PARENT, wba_passes=2, wba_windows=58, wba_steps=58,
                        wba_accepted=30, wba_pass_s=0.1,
                        wba_rows=58 * (2 * 64 * b + 390),
                        wba_cols=58 * 192)) for b in (40, 80, 40)]
    want = 100 * (mod.solve_bound_us(58, 58 * 5510, 192)
                  + mod.solve_bound_us(58, 58 * 10630, 192)) / (4 * 1351)
    assert _read("wba_normal_roofline", reqs, t) == pytest.approx(want)
    assert 0 < want < 100
    # counted solves that are not the LUs found: no reading
    t.spans = spans[:1]
    assert _read("wba_normal_roofline", reqs, t) is None
    t.spans = spans * 2
    assert _read("wba_normal_roofline", reqs, t) is None
