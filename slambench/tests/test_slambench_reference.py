"""CPU tests of the benchmark's plain reference (``slambench/reference``)
and of the check that decides ``correct``: the reference agrees with the
program on small worlds, imports nothing of the program, and its control
(the reference in bfloat16) fails every cell's limits.  At the cells' own
size the readings are taken on the card by ``slambench/control.py``."""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from slambench.harness.registry import Registry  # noqa: E402
from slambench.harness.worlds import synthetic_world  # noqa: E402
from slambench.reference import compare  # noqa: E402
from slambench.reference import icm as ref  # noqa: E402

SMALL = dict(N=3, L=256, cota=20.0)
CELLS = [c["name"] for c in Registry().bench["workloads"]] + ["grove.stream"]


@pytest.fixture(autouse=True)
def _one_thread(one_thread):
    yield


def _port(world, entry):
    from icm_slam_tpu_torch.config import ICMConfig
    from icm_slam_tpu_torch.data.datasets import Dataset
    from icm_slam_tpu_torch.runtime.online import OnlineSLAM
    from icm_slam_tpu_torch.solver.icm import run
    cfg = ICMConfig(**SMALL)
    if entry == "run":
        r = run(Dataset(world.scans, world.odom, world.u, world.x0), cfg,
                "cpu")
    else:
        s = OnlineSLAM(cfg, "cpu", chunk_size=64)
        for t in range(world.T):
            s.push(world.scans[t], world.odom[t], world.u[t])
        r = s.finish(refine=True)
    return (r.x_init, r.x, r.map_pos, r.map_counts)


def _numbers(ans, world, whole, p, stream):
    got = compare.gaps(ans, whole)
    got.update(compare.selfs(ans, ref.remap(world, ans[1], ans[2], ans[3],
                                            p, "cpu")))
    if stream:
        got.update(compare.steps(ans, ref.replay_stream(world, ans[0], p,
                                                        "cpu")))
    return got


@pytest.mark.parametrize("entry", ["run", "online"])
@pytest.mark.parametrize("seed", [7, 10, 11])
def test_reference_agrees_with_the_program(entry, seed):
    world = synthetic_world(T=240, n_landmarks=12, seed=seed)
    p = ref.Params(**SMALL)
    stream = entry == "online"
    r = ref.streamed(world, p, "cpu") if stream else ref.offline(world, p,
                                                                 "cpu")
    ans = _port(world, entry)
    g = _numbers(ans, world, r, p, stream)
    assert len(ans[2]) == len(r.map_pos), g
    near = np.sqrt(((ans[2][:, None] - r.map_pos[None]) ** 2).sum(-1))
    assert near.min(1).max() < 2e-3, g
    assert g["map_self_gap"] < 2e-2, g
    assert g["x_gap_median"] < 1e-3 and g["init_gap_median"] < 1e-3, g
    assert g["refine_shift_gap"] < 0.05, g
    if stream:
        assert g["step_gap"] < 1e-3, g


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from slambench.reference import icm, compare\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    mods = json.loads(out.stdout.strip().replace("'", '"'))
    assert not {"icm_slam_tpu_torch", "icm_slam_tpu", "jax", "jaxlib",
                "flax"} & set(mods)


def test_reference_refuses_what_it_does_not_implement():
    with pytest.raises(ValueError):
        ref.Params.from_solver({"sweep_mode": "sequential"})
    with pytest.raises(ValueError):
        ref.Params.from_solver({"replicate_new_obs_quirk": False})
    assert ref.Params.from_solver({"N": 4, "Q": [1.0, 2.0]}).Q == (1.0, 2.0)
    # a reference of another path says what it implements
    seq = dict(ref.Params.SUPPORTED, sweep_mode="sequential")
    assert ref.Params.from_solver({"sweep_mode": "sequential", "N": 2},
                                  seq).N == 2


@dataclasses.dataclass(frozen=True)
class _WindowedParams(ref.Params):
    """A reference of windowed BA's parameters: its own fields and what it
    implements."""
    ba_window: int = 64
    ba_gn_iters: int = 4

    SUPPORTED = dict(ref.Params.SUPPORTED, sweep_mode="windowed_ba")


def test_a_params_subclass_keeps_its_own_fields():
    """``from_solver`` builds the subclass over its own fields and holds
    the solver to its own ``SUPPORTED``; ``replace_n`` keeps the extra
    fields."""
    solver = {"sweep_mode": "windowed_ba", "ba_window": 32, "N": 5,
              "ba_gn_iters": 2, "Q": [1.0, 2.0], "map_run_cap": 256}
    p = _WindowedParams.from_solver(solver)
    assert type(p) is _WindowedParams
    assert (p.ba_window, p.ba_gn_iters, p.N, p.Q) == (32, 2, 5, (1.0, 2.0))
    q = p.replace_n(0)
    assert type(q) is _WindowedParams
    assert (q.ba_window, q.ba_gn_iters, q.N) == (32, 2, 0)
    with pytest.raises(ValueError, match="sweep_mode='windowed_ba'"):
        _WindowedParams.from_solver({"sweep_mode": "batched"})
    # the batched reference still refuses it, and reads no such field
    with pytest.raises(ValueError, match="sweep_mode='batched'"):
        ref.Params.from_solver(solver)
    assert not hasattr(ref.Params.from_solver({"ba_window": 32}),
                       "ba_window")


def test_numbers_are_zero_for_equal_answers_and_see_wrong_ones():
    world = synthetic_world(T=120, n_landmarks=10, seed=7)
    p = ref.Params(N=2, L=256, cota=5.0)
    r = ref.streamed(world, p, "cpu")
    ans = (r.x_init, r.x, r.map_pos, r.map_counts)
    assert all(v == 0 for v in compare.gaps(ans, r).values())
    assert compare.steps(ans, r.x_init) == {"step_gap": 0.0}
    assert compare.steps(ans, ref.replay_stream(world, r.x_init, p, "cpu"))[
        "step_gap"] == 0.0
    g = compare.gaps((r.x_init, r.x_init, r.map_pos, r.map_counts), r)
    assert g["refine_shift_gap"] == pytest.approx(1.0)
    # the map against the one its own poses and map give
    mine = ref.remap(world, r.x, r.map_pos, r.map_counts, p, "cpu")
    g = compare.selfs(ans, mine)
    assert g["map_self_gap"] < 2e-2, g
    assert compare.selfs(ans, (r.map_pos, r.map_counts)) == {
        "map_self_gap": 0.0}
    g = compare.selfs((r.x_init, r.x, r.map_pos + 3.0, r.map_counts),
                      (r.map_pos, r.map_counts))
    assert g["map_self_gap"] == pytest.approx(np.sqrt(18.0))
    # landmarks that are not the world's, more than the world's own
    far = np.concatenate([r.map_pos, r.map_pos + 50.0, r.map_pos - 50.0])
    g = compare.selfs((r.x_init, r.x, far, np.tile(r.map_counts, 3)),
                      (r.map_pos, r.map_counts))
    assert g["map_self_gap"] > 40
    g = compare.gaps((r.x_init, r.x * np.nan, r.map_pos, r.map_counts), r)
    assert g["x_gap_median"] == np.inf and g["refine_shift_gap"] == np.inf


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_bfloat16_fails_the_cells_limits(cell, with_stream):
    """The control: the reference in bfloat16, the precision below the
    configuration's float32, in the program's place, fails the limits
    (at a small size here; at the cell's size on the card)."""
    world = synthetic_world(T=240, n_landmarks=12, seed=7)
    p = ref.Params(**SMALL)
    reg = with_stream
    entry = reg.traffic(reg.cell(cell)["traffic"])["entry"]
    stream = entry == "online"
    run = ref.streamed if stream else ref.offline
    f32 = run(world, p, "cpu")
    bf16 = run(world, p, "cpu", dtype=torch.bfloat16)
    g = _numbers((bf16.x_init, bf16.x, bf16.map_pos, bf16.map_counts),
                 world, f32, p, stream)
    limits = reg.limits(cell)["limits"]
    assert any(not g[n] <= limits[n] for n in limits), g
    assert np.isfinite(bf16.x).all()
