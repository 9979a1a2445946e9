"""Write the JAX package's results on synthetic worlds as golden files for
the PyTorch port's runs on the GPU (``chip_smoke.py``).

Usage:
    python tools/make_torch_golden.py [NAME ...] [--dir DIR]

NAME is a golden file's name below (default: all of them).  Each file
holds cases under key prefixes, each the output of
``icm_slam_tpu.solver.icm.run`` on the CPU (times: one core of a recent
x86 server, JAX without 64-bit types):

``torch_slice_synth_T1833_N30.npz`` (JAX with ``use_pallas_fused_assoc=
True``: the route through the fused association kernel the port's capped
branch replaces, with the same d^2 form of the distance gate; Pallas
interpret mode off the TPU, ~20 s):

* ``main_`` — ``synthetic_world(T=1833, seed=0)`` with ``ICMConfig()``
  defaults (N=30, L=1024, cota=300): the port's main path at full size;
* ``small_`` — ``synthetic_world(T=240, n_landmarks=12, seed=7)`` with
  L=256, cota=20, N=3: the world of tests/test_torch_slice.py, small
  enough that the port stays within the 1e-3 pose band of JAX.

``torch_engines_synth_T1833.npz`` (JAX's default paths, ~25 s):

* ``seq_`` — the T=1833 world with ``sweep_mode="sequential"``, N=2: the
  causal init and the reference-faithful sequential refine;
* ``seq1_`` — the same with N=1 (what ``chip_smoke.py`` phase 8 runs);
* ``nqj_`` — the same world with ``replicate_new_obs_quirk=False`` and
  ``pose_update="jacobi"``, N=3, L=2048: the causal init, then the
  batched refine with connected-component labels and Jacobi passes (at
  L=1024 the first sweep allocates 1,083 labels and overflows the table).

``torch_models_synth.npz`` (JAX with ``use_pallas_fused_assoc=True``,
~120 s, the loop case's ``close_loops`` 16 s of it):

* ``hooks_`` — the T=1833 world, ``ICMConfig(N=3, init_mode="batched")``
  with the hooks of tests/test_extensions.py (``obs_scale = 1/(1+dist)``,
  ``extra_one_sided = extra_two_sided = 5 (x[:2] - odo_cur[:2])``);
* ``causal_`` — the small world, L=256, cota=20, N=3, with the robust
  observation model of tests/test_extensions.py (a model is set, so the
  init is the causal sweep);
* ``ba_`` — the T=1833 world, ``sweep_mode="ba"``, N=3;
* ``wba_`` — the T=1833 world, ``sweep_mode="windowed_ba"``, N=3,
  ``ba_window=64``;
  both also hold one backend call (``one_``) from the run's final map
  with its poses perturbed by ``ONE_CALL_NOISE`` (pose 0 kept, NumPy
  seed 0), so that every step has work: the start and end poses, the
  map after it and the BA energy of the start's association before and
  after (``ba_refine``: the end map's landmarks; ``windowed_ba``: the
  association's);
* ``loop_`` — the default world of benchmarks/loop_closure_eval.py
  (``drifted_world(T=2000, n_landmarks=150, world_size=50, seed=3,
  w_bias=0.001, laps=2)``), ``ICMConfig(N=15, L=1024, cota=10)``, then
  ``close_loops`` on the refined poses with ``LOOP_CLOSE`` (its arguments
  are stored as JSON under ``loop_close_kwargs``): the closed poses, the
  accepted pairs, each round's report row, and the mean position error
  against the truth before and after;
* ``cliloop_`` — the JAX CLI as ``CLI_LOOP`` runs it (600 frames of
  ``synthetic_world()``, 3 iterations, ``--loop-close``; with
  ``--pallas-fused``): the printed closure count, the census and the
  poses (~15 s).

``torch_fleet_synth.npz`` (JAX ``run_batched``, fleet mode, with
``use_pallas_fused_assoc=True``, ~80 s): each case a fleet of worlds,
its fields under ``<prefix>_w<i>_`` per world and the merged caps under
``<prefix>_``:

* ``slice3_`` — ``synthetic_world(T=240, n_landmarks=12, seed=s)`` for s
  in 7, 10, 11 (the worlds of tests/test_torch_fleet.py), L=256, cota=20,
  N=3: merged to the capped branch (cap 128);
* ``fleet3_`` — the three worlds of tests/test_fleet.py
  (``synthetic_world(T=300, n_landmarks=25, seed=s)``, s = 0, 1, 2),
  L=256, cota=10, N=4: merged to the uncapped branch;
* ``big2_`` — ``synthetic_world(T=1833, seed=s)`` for s in 0, 1 with
  ``ICMConfig()`` (N=30, L=1024): worlds 0 and 1 of the port's fleet
  curve at W=2.

``torch_fleet_modes_synth.npz`` (JAX ``run_batched`` with
``use_pallas_fused_assoc=True``, ~3 min): a fleet of
``synthetic_world(T=120, n_landmarks=10, seed=s)`` for s in 7, 10, 11 with
``ICMConfig(N=2, L=256, cota=5)`` in each configuration the fleet takes
beyond the default one, its fields as in ``torch_fleet_synth.npz``:

* ``hooks_`` — the hooks of the ``hooks_`` case above, ``init_mode=
  "batched"``;
* ``ba_`` / ``wba_`` — ``sweep_mode="ba"`` / ``"windowed_ba"`` (window
  32);
* ``nq_`` — ``replicate_new_obs_quirk=False`` (the causal init, then
  batched sweeps with connected-component labels);
* ``iseq_`` — ``init_mode="sequential"`` (the causal init, then batched
  sweeps);
* ``seq_`` — ``sweep_mode="sequential"`` (the causal init and the
  sequential sweep);

each case also holds ``overflow_message``, the error JAX's fleet raises
in that configuration when one of its worlds overflows the table
(``OVERFLOW_WORLDS`` with ``ICMConfig(N=1, L=12, cota=2)``).

``torch_parallel_synth.npz`` (JAX ``run_batched`` on a fleet mesh of
two of the host's virtual CPU devices, ``parallel.mesh.make_fleet_mesh``,
JAX's default paths, ~15 s): ``mesh3_`` — the first three worlds of
``torch_fleet_modes_synth.npz`` (s = 7, 10, 11), ``ICMConfig(N=2, L=256,
cota=5)``, W=3 padded to four lanes; its fields as in
``torch_fleet_synth.npz``.  The far end of tests/test_torch_parallel.py's
fleet-mesh cases.

``torch_oracle_synth.npz`` (``tests/oracle/reference_oracle.run_pipeline``,
the reference's algorithm in NumPy, ~1 min a world): ``o<s>_`` for
``synthetic_world(T=150, n_landmarks=10, seed=s)``, s in 0, 1, 4, with
``OracleParams(N=3, L=256, cota=5)`` and tests/test_fuzz_oracle.py's
ingest (scans + radio, clipped at the laser's range; the first pose the
first odometry row): the oracle's poses ``x``, ``x_init`` and its map
``map`` (2, n).

The files hold outputs only — poses, map, census, map changes, the
resolved caps, the ATE against the world's truth — plus a checksum of
each world, which the reader must reproduce before it compares anything.
Where a file already exists, the cases it holds keep their keys and the
cases not named on the command line (``--only PREFIX ...``) are copied.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

_BIG = dict(T=1833, seed=0)
_SMALL = dict(T=240, n_landmarks=12, seed=7)
_LOOP = dict(drifted=True, T=2000, n_landmarks=150, world_size=50.0, seed=3,
             v_noise=0.03, w_noise=0.004, w_bias=0.001, laps=2)
# close_loops on the loop world, as benchmarks/loop_closure_eval.py runs it
LOOP_CLOSE = dict(min_gap=300, radius=6.0, icp_coarse_gate=4.0, gn_iters=20,
                  cg_iters=400, rounds=3)
# the CLI's --loop-close, as chip_smoke.py runs it on the card
CLI_LOOP = ["run", "--dataset", "synthetic", "--frames", "600", "--iters",
            "3", "--loop-close"]
# pose noise (m, rad) of the start of the BA cases' one backend call
ONE_CALL_NOISE = 0.02
_MODES_WORLDS = [dict(T=120, n_landmarks=10, seed=s) for s in (7, 10, 11)]
_MODES_CFG = dict(N=2, L=256, cota=5.0)
# the configurations of torch_fleet_modes_synth.npz, by case prefix
FLEET_MODES = {"hooks": dict(init_mode="batched", model="hooks"),
               "ba": dict(sweep_mode="ba"),
               "wba": dict(sweep_mode="windowed_ba", ba_window=32),
               "nq": dict(replicate_new_obs_quirk=False),
               "iseq": dict(init_mode="sequential"),
               "seq": dict(sweep_mode="sequential")}
# a fleet whose world 1 overflows a table of 12 in every configuration
OVERFLOW_WORLDS = [dict(T=60, n_landmarks=4, seed=0),
                   dict(T=60, n_landmarks=40, seed=1)]
OVERFLOW_CFG = dict(N=1, L=12, cota=2.0)
ORACLE_SEEDS = (0, 1, 4)
ORACLE_WORLD = dict(T=150, n_landmarks=10)
ORACLE_PARAMS = dict(N=3, L=256, cota=5.0)
# file -> (ICMConfig kwargs of every case, {prefix: (world kwargs, ICMConfig
# kwargs)}); a "model" entry names one of MODELS
GOLDENS = {
    "torch_slice_synth_T1833_N30.npz": (
        dict(use_pallas_fused_assoc=True),
        {"main": (_BIG, dict(N=30)),
         "small": (_SMALL, dict(L=256, cota=20.0, N=3))}),
    "torch_engines_synth_T1833.npz": (
        {},
        {"seq": (_BIG, dict(sweep_mode="sequential", N=2)),
         "seq1": (_BIG, dict(sweep_mode="sequential", N=1)),
         "nqj": (_BIG, dict(replicate_new_obs_quirk=False,
                            pose_update="jacobi", N=3, L=2048))}),
    "torch_fleet_synth.npz": (
        dict(use_pallas_fused_assoc=True),
        {"slice3": ([dict(T=240, n_landmarks=12, seed=s) for s in (7, 10, 11)],
                    dict(L=256, cota=20.0, N=3)),
         "fleet3": ([dict(T=300, n_landmarks=25, seed=s) for s in (0, 1, 2)],
                    dict(L=256, cota=10.0, N=4)),
         "big2": ([dict(T=1833, seed=s) for s in (0, 1)], dict(N=30))}),
    "torch_models_synth.npz": (
        dict(use_pallas_fused_assoc=True),
        {"hooks": (_BIG, dict(N=3, init_mode="batched", model="hooks")),
         "causal": (_SMALL, dict(L=256, cota=20.0, N=3, model="robust_obs")),
         "ba": (_BIG, dict(sweep_mode="ba", N=3)),
         "wba": (_BIG, dict(sweep_mode="windowed_ba", N=3, ba_window=64)),
         "loop": (_LOOP, dict(N=15, L=1024, cota=10.0)),
         "cliloop": (None, CLI_LOOP)}),
    "torch_fleet_modes_synth.npz": (
        dict(use_pallas_fused_assoc=True),
        {k: (_MODES_WORLDS, dict(_MODES_CFG, **kw))
         for k, kw in FLEET_MODES.items()}),
    "torch_parallel_synth.npz": (
        {}, {"mesh3": (_MODES_WORLDS, dict(_MODES_CFG, mesh=2))}),
    "torch_oracle_synth.npz": (
        "oracle", {f"o{s}": (dict(ORACLE_WORLD, seed=s), ORACLE_PARAMS)
                   for s in ORACLE_SEEDS}),
}


def _hooks_model():
    """tests/test_extensions.py::test_custom_energy_model_changes_solution."""
    from icm_slam_tpu.core.energy import EnergyModel

    def anchor_to_odom(x, prob):
        return 5.0 * (x[:2] - prob.odo_cur[:2])

    return EnergyModel(obs_scale=lambda dist, ang: 1.0 / (1.0 + dist),
                       extra_one_sided=anchor_to_odom,
                       extra_two_sided=anchor_to_odom)


def _robust_obs_model():
    """tests/test_extensions.py::test_full_potential_replacement_hooks."""
    import jax.numpy as jnp
    from icm_slam_tpu.core.energy import EnergyModel

    def robust_obs(x, p, sqrt_q):
        a = p.ang + x[2] - jnp.pi / 2.0
        pts = x[:2][None, :] + p.dist[:, None] * jnp.stack(
            [jnp.cos(a), jnp.sin(a)], axis=-1)
        r = (pts - p.matched) * sqrt_q[None, :]
        n2 = jnp.sum(r * r, axis=-1, keepdims=True)
        r = r / jnp.sqrt(1.0 + n2)
        return jnp.where(p.mask[:, None], r, 0.0)

    return EnergyModel(obs_model=robust_obs)


MODELS = {"hooks": _hooks_model, "robust_obs": _robust_obs_model}


def _world(world_kw):
    from icm_slam_tpu.data.datasets import drifted_world, synthetic_world
    kw = dict(world_kw)
    if kw.pop("drifted", False):
        return drifted_world(**kw)
    return synthetic_world(**kw, return_truth=True)


def _loop_fields(ds, x_true, cfg, res):
    """close_loops on the refined poses, as the loop-closure benchmark."""
    import jax.numpy as jnp
    from icm_slam_tpu.models.loop_closure import close_loops
    from icm_slam_tpu.solver.icm import prepare, resolve_config
    data = prepare(ds, cfg)
    report = {}
    t0 = time.time()
    x_fix, cl = close_loops(data, jnp.asarray(res.x),
                            resolve_config(cfg, data), report=report,
                            **LOOP_CLOSE)
    x_fix = np.asarray(x_fix)

    def mean_err(x):
        return float(np.mean(np.linalg.norm(x[:, :2] - x_true[:, :2],
                                            axis=1)))
    rows = report["rounds"]
    return dict(loop_close_kwargs=json.dumps(LOOP_CLOSE),
                x_closed=x_fix, pairs=np.asarray(cl.pairs, np.int32),
                closure_rel=np.asarray(cl.rel),
                report_rows=json.dumps(rows),
                rounds_applied=np.array([r["applied"] for r in rows]),
                rounds_n_closures=np.array([r["n_closures"] for r in rows]),
                ate_mean_icm=mean_err(res.x), ate_mean_closed=mean_err(x_fix),
                ate_rmse_closed=float(np.sqrt(
                    ((x_fix[:, :2] - x_true[:, :2]) ** 2).sum(1).mean())),
                close_seconds=time.time() - t0)


def _one_call_fields(ds, cfg, res):
    """One BA backend call from the run's final map, poses perturbed."""
    import jax
    import jax.numpy as jnp
    from icm_slam_tpu.core.energy import weights
    from icm_slam_tpu.mapping.landmark_map import MapState
    from icm_slam_tpu.models import bundle_adjustment as ba
    from icm_slam_tpu.models.windowed_ba import windowed_ba_refine
    from icm_slam_tpu.solver import icm
    from icm_slam_tpu.solver.sweeps import batched_associate
    raw = icm.prepare(ds, cfg)
    rcfg = icm.resolve_config(cfg, raw)
    data = icm.hoist_compaction(raw, rcfg)
    w = weights(rcfg)
    n, L = res.map_pos.shape[0], rcfg.L
    cur = MapState(jnp.zeros((L, 2), jnp.float32).at[:n].set(res.map_pos),
                   jnp.zeros((L,), jnp.float32).at[:n].set(res.map_counts),
                   jnp.int32(n))
    noise = np.random.default_rng(0).normal(
        0.0, ONE_CALL_NOISE, res.x.shape).astype(np.float32)
    noise[0] = 0.0
    x0 = res.x.astype(np.float32) + noise
    # the BA problem of the start, as ba_refine builds it
    labels, amap, _ = jax.jit(batched_associate, static_argnames="config")(
        data, cur, jnp.asarray(x0), config=rcfg)
    valid = (labels < L) & data.mask
    cap = rcfg.obs_cap if rcfg.obs_cap else data.dist.shape[1]
    order = jnp.argsort(~valid, axis=1, stable=True)[:, :cap]

    def take(a):
        return jnp.take_along_axis(a, order, axis=1)
    prob = ba.BAProblem(data, take(data.dist), take(data.ang), take(labels),
                        take(valid).astype(jnp.float32), amap.counts,
                        amap.counts > 0)
    t0 = time.time()
    if rcfg.sweep_mode == "ba":
        m, x1 = ba.ba_refine(data, cur, jnp.asarray(x0), rcfg, w,
                             gn_iters=rcfg.ba_gn_iters,
                             cg_iters=rcfg.ba_cg_iters)
        y1 = m.pos
    else:
        m, x1 = windowed_ba_refine(data, cur, jnp.asarray(x0), rcfg, w,
                                   window=rcfg.ba_window)
        y1 = amap.pos
    x1 = np.asarray(x1)
    return dict(one_noise=ONE_CALL_NOISE, one_x_start=x0, one_x=x1,
                one_map_pos=np.asarray(m.pos), one_nact=int(m.nact),
                one_energies=np.array([
                    float(ba.energy(jnp.asarray(x0), amap.pos, prob, w)),
                    float(ba.energy(jnp.asarray(x1), y1, prob, w))]),
                one_seconds=time.time() - t0)


def make_cli_case(argv):
    """The JAX CLI's run with ``argv`` (on the CPU, fused association)."""
    import contextlib
    import io
    from icm_slam_tpu import cli
    work = os.path.join(REPO, "build", "golden")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "cli.npz")
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        cli.main(list(argv) + ["--cpu", "--pallas-fused", "--out", path])
    dt = time.time() - t0
    counts = [int(line.split(":")[1]) for line in buf.getvalue().splitlines()
              if line.startswith("# loop closures accepted:")]
    assert len(counts) == 1, buf.getvalue()
    with np.load(path) as z:
        return dict(args=json.dumps(list(argv)), closures=counts[0],
                    census=z["map_pos"].shape[0], x=z["x"], wall_seconds=dt)


def make_case(world_kw, cfg_kw, common):
    from icm_slam_tpu.config import ICMConfig
    from icm_slam_tpu.solver.icm import prepare, resolve_config, run
    from icm_slam_tpu_torch.data.datasets import world_checksum
    ds, x_true, _ = _world(world_kw)
    cfg_kw = dict(cfg_kw)
    model = cfg_kw.pop("model", None)
    cfg = ICMConfig(**cfg_kw, **common,
                    model=None if model is None else MODELS[model]())
    resolved = resolve_config(cfg, prepare(ds, cfg))
    t0 = time.time()
    res = run(ds, cfg)
    dt = time.time() - t0
    ate = float(np.sqrt(((res.x[:, :2] - x_true[:, :2]) ** 2)
                        .sum(1).mean()))
    fields = dict(
        world_checksum=world_checksum(ds), obs_cap=resolved.obs_cap,
        map_run_cap=resolved.map_run_cap, x_init=res.x_init, x=res.x,
        map_pos=res.map_pos, map_counts=res.map_counts,
        changes=res.changes, census=res.map_pos.shape[0],
        ate_rmse=ate, wall_seconds=dt)
    if model is not None:
        fields["model"] = model
    if world_kw.get("drifted"):
        fields.update(_loop_fields(ds, x_true, cfg, res))
    if cfg.sweep_mode in ("ba", "windowed_ba"):
        fields.update(_one_call_fields(ds, cfg, res))
    return fields


def make_fleet_case(worlds_kw, cfg_kw, common):
    """JAX ``run_batched`` on the worlds of ``worlds_kw``: per world the
    fields of ``make_case`` (no map changes: a fleet keeps none) under
    ``w<i>_``, and the merged caps."""
    from icm_slam_tpu.config import ICMConfig
    from icm_slam_tpu.solver.icm import (prepare, resolve_fleet_config,
                                         run_batched)
    from icm_slam_tpu_torch.data.datasets import world_checksum
    worlds = [_world(kw) for kw in worlds_kw]
    datasets = [ds for ds, _, _ in worlds]
    cfg_kw = dict(cfg_kw)
    model = cfg_kw.pop("model", None)
    n_mesh = cfg_kw.pop("mesh", None)
    cfg = ICMConfig(**cfg_kw, **common,
                    model=None if model is None else MODELS[model]())
    merged = resolve_fleet_config(cfg, [prepare(ds, cfg) for ds in datasets])
    mesh = None
    if n_mesh:
        import jax
        from icm_slam_tpu.parallel.mesh import make_fleet_mesh
        mesh = make_fleet_mesh(jax.devices(), n_mesh)
    t0 = time.time()
    results = run_batched(datasets, cfg, mesh=mesh)
    dt = time.time() - t0
    fields = dict(obs_cap=merged.obs_cap, map_run_cap=merged.map_run_cap,
                  worlds=json.dumps(worlds_kw), wall_seconds=dt,
                  config=json.dumps(cfg_kw), mesh_devices=n_mesh or 0,
                  census=np.array([r.map_pos.shape[0] for r in results]))
    if model is not None:
        fields["model"] = model
    for i, ((ds, x_true, _), res) in enumerate(zip(worlds, results)):
        ate = float(np.sqrt(((res.x[:, :2] - x_true[:, :2]) ** 2)
                            .sum(1).mean()))
        fields.update({f"w{i}_{k}": v for k, v in dict(
            world_checksum=world_checksum(ds), x_init=res.x_init, x=res.x,
            map_pos=res.map_pos, map_counts=res.map_counts,
            census=res.map_pos.shape[0], ate_rmse=ate).items()})
    return fields


def overflow_message(mode_kw, common):
    """The RuntimeError JAX's ``run_batched`` raises on OVERFLOW_WORLDS in
    the configuration ``mode_kw``."""
    from icm_slam_tpu.config import ICMConfig
    from icm_slam_tpu.solver.icm import run_batched
    mode_kw = dict(mode_kw)
    model = mode_kw.pop("model", None)
    cfg = ICMConfig(**OVERFLOW_CFG, **mode_kw, **common,
                    model=None if model is None else MODELS[model]())
    try:
        run_batched([_world(kw)[0] for kw in OVERFLOW_WORLDS], cfg)
    except RuntimeError as e:
        return str(e)
    raise AssertionError(f"no overflow in {mode_kw}")


def make_oracle_case(world_kw, params_kw):
    """The reference oracle on one world, with tests/test_fuzz_oracle.py's
    ingest: the scans + radio clipped at the laser's range, transposed to
    the reference's (B, T) layout."""
    sys.path.insert(0, os.path.join(REPO, "tests", "oracle"))
    from reference_oracle import OracleParams, run_pipeline
    from icm_slam_tpu_torch.data.datasets import (synthetic_world,
                                                  world_checksum)
    ds = synthetic_world(**world_kw)
    p = OracleParams(**params_kw)
    scans = np.minimum(np.asarray(ds.scans) + p.radio, p.rango_laser_max)
    t0 = time.time()
    out = run_pipeline(scans.T.copy(), np.asarray(ds.odom).T.copy(),
                       np.asarray(ds.u).T.copy(), p, verbose=False)
    return dict(world_checksum=world_checksum(ds), x=out["x"].T,
                x_init=out["x_init"].T, map=out["map"],
                census=out["map"].shape[1], params=json.dumps(params_kw),
                wall_seconds=time.time() - t0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*", choices=list(GOLDENS),
                    help="golden files to write (default: all)")
    ap.add_argument("--only", nargs="*", default=None, metavar="PREFIX",
                    help="make only these cases; the file's other cases "
                         "are copied from the existing file")
    ap.add_argument("--dir", default=os.path.join(REPO, "tests", "golden"))
    args = ap.parse_args()

    # virtual CPU devices for the fleet mesh (as tests/conftest.py)
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")
    import jax
    jax.config.update("jax_platforms", "cpu")

    for name in args.names or GOLDENS:
        common, cases = GOLDENS[name]
        path = os.path.join(args.dir, name)
        out = {"jax_path": repr(common) if common else "default"}
        if common == "oracle":
            out = {"reference": "tests/oracle/reference_oracle.py"}
        if args.only is not None and os.path.exists(path):
            with np.load(path) as old:
                out.update({k: old[k] for k in old.files
                            if k.split("_", 1)[0] not in args.only})
        for prefix, (world_kw, cfg_kw) in cases.items():
            if args.only is not None and prefix not in args.only:
                continue
            if common == "oracle":
                fields = make_oracle_case(world_kw, cfg_kw)
            elif world_kw is None:
                fields = make_cli_case(cfg_kw)
            elif isinstance(world_kw, list):
                fields = make_fleet_case(world_kw, cfg_kw, common)
                if name == "torch_fleet_modes_synth.npz":
                    fields["overflow_message"] = overflow_message(
                        FLEET_MODES[prefix], common)
            else:
                fields = make_case(world_kw, cfg_kw, common)
            out.update({f"{prefix}_{k}": v for k, v in fields.items()})
            print(f"{name} {prefix}: {fields['wall_seconds']:.1f}s, "
                  + ", ".join(f"{k}={fields[k]}" for k in (
                      "census", "obs_cap", "map_run_cap", "ate_rmse",
                      "closures", "one_energies") if k in fields),
                  flush=True)
        os.makedirs(args.dir, exist_ok=True)
        np.savez_compressed(path, **out)
        print(f"saved {path}")


if __name__ == "__main__":
    main()
