"""The port's ``parallel/`` on gloo CPU ranks: the process-group bring-up
and the fleet mesh (``solver.icm.run_batched(mesh=...)``).

Each group of n ranks (1, 2 and 4) is spawned once for the module
(``tests/torch_dist_workers.py``, which imports no JAX); the cases read
what its ranks returned.  Held: every rank returns every world, each
bitwise the unsharded port fleet (the same engine on fewer worlds, so the
same bits), with W padded by repeating the last world where the ranks do
not divide it; a world's table overflow raises on every rank with JAX's
message and the global world index (the witnesses are checked after the
gather, so no rank waits on one that raised).  JAX's fleet mesh is held
against the port's by tests/golden/torch_parallel_synth.npz.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from icm_slam_tpu.config import ICMConfig as JC
from icm_slam_tpu.data.datasets import synthetic_world as jworld
from icm_slam_tpu.solver import icm as jicm
from icm_slam_tpu_torch.parallel import distributed as pd
from icm_slam_tpu_torch.parallel import mesh as pm
from icm_slam_tpu_torch.solver import icm as ticm
from tests import torch_dist_workers as tw
from tests.torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

RANKS = (1, 2, 4)
FIELDS = ("x_init", "x", "map_pos", "map_counts")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "torch_parallel_synth.npz")


@pytest.fixture(scope="module", params=RANKS, ids=lambda n: f"{n}ranks")
def group(request, tmp_path_factory):
    n = request.param
    return n, tw.spawn(tw.fleet_worker, n,
                       tmp_path_factory.mktemp(f"fleet{n}"))


@pytest.fixture(scope="module")
def unsharded(one_thread):
    return {name: ticm.run_batched(worlds(), cfg(), "cpu")
            for name, (worlds, cfg, _) in tw.FLEET_CASES.items()}


def test_initialize_by_arguments_and_by_environment(tmp_path):
    """Even ranks pass the coordinator, odd ranks read ICM_*; one group of
    four forms, and one gather over its global mesh sees every rank."""
    out = tw.spawn(tw.initialize_worker, 4, tmp_path, pm._free_port())
    for r, o in enumerate(out):
        assert (o["rank"], o["world"], o["backend"]) == (r, 4, "gloo")
        assert o["primary"] == (r == 0)
        assert o["mesh"] == (("t",), 4, r)
        assert o["gathered"] == [0, 10, 20, 30]


def test_initialize_without_configuration_is_a_no_op(monkeypatch):
    for k in ("ICM_COORDINATOR", "ICM_NUM_PROCESSES", "ICM_PROCESS_ID",
              "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    pd.initialize(device="cpu")
    assert not dist.is_initialized()
    assert pd.is_primary()


def test_cuda_without_cuda_raises():
    """The defaults run on the card: without CUDA they raise, before any
    group forms (no gloo in NCCL's place)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-fallback case needs none")
    with pytest.raises(RuntimeError, match="cuda"):
        pd.initialize("localhost:1", 1, 0)
    for make in (pm.make_mesh, pm.make_fleet_mesh, pd.global_mesh):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    assert not dist.is_initialized()


def test_fleet_mesh_and_blocks(group):
    n, out = group
    rows = np.arange(24).reshape(8, 3)
    for r, o in enumerate(out):
        assert o["mesh"] == (("w",), n, r)
        assert np.array_equal(o["fleet_block"],
                              rows[r * 8 // n:(r + 1) * 8 // n])
        assert "process group has" in o["wrong_size"]
        assert "axis 'w'" in o["wrong_axis"]
    assert pm.fleet_sharding(None)[0].dim == 0
    assert pm.replicated(None)[0].is_replicate()


CASES = [(n, c) for c, (_, _, ranks) in tw.FLEET_CASES.items()
         for n in ranks]


@pytest.mark.parametrize("group,case", CASES, indirect=["group"],
                         ids=[f"{c}-{n}ranks" for n, c in CASES])
def test_every_rank_returns_the_unsharded_fleet_bitwise(group, case,
                                                        unsharded):
    """W=4 over 1, 2 and 4 ranks, W=3 over 2 (one world repeated into the
    pad, then dropped), the sequential engine over 2."""
    n, out = group
    ref = unsharded[case]
    for o in out:
        got = o[f"fleet_{case}"]
        assert len(got) == len(ref)
        for a, b in zip(ref, got):
            for f in FIELDS:
                assert np.array_equal(getattr(a, f), b[f]), f


@pytest.mark.parametrize("group", RANKS, indirect=True,
                         ids=lambda n: f"{n}ranks")
def test_timings_as_jax_names_them(group):
    n, out = group
    for o in out:
        res = o["fleet_w4"]
        t = res[0]["timings"]
        for k in ("prepare_s", "pipeline_s", "per_world_s", "init_s",
                  "refine_s"):
            assert t[k] >= 0.0
        assert t["per_world_s"] == pytest.approx(t["pipeline_s"] / 4)
        assert all(r["timings"] == t for r in res)


def test_overflow_raises_on_every_rank_as_jax_says_it(group):
    """World 1 overflows; with two ranks it runs on rank 1, with four its
    copies fill ranks 1-3: every rank raises, naming world 1."""
    n, out = group
    jc = JC(N=1, L=24, cota=2.0, dtype="float32")
    with pytest.raises(RuntimeError, match=r"\(world 1\)") as je:
        jicm.run_batched([jworld(T=60, n_landmarks=4, seed=0),
                          jworld(T=60, n_landmarks=40, seed=1)], jc)
    for o in out:
        assert o["overflow"] == str(je.value)


@pytest.mark.parametrize("group", [2], indirect=True,
                         ids=lambda n: f"{n}ranks")
def test_jax_fleet_mesh_golden_against_the_port_mesh(group):
    """JAX's run_batched on a fleet mesh of two of its virtual devices, W=3
    (tools/make_torch_golden.py): census exact per world, poses and the
    map within 1e-3 (tests/test_fleet_sharded.py's band), on every rank
    of the port's two."""
    n, out = group
    g = np.load(GOLDEN)
    for o in out:
        for i, r in enumerate(o["fleet_w3"]):
            assert r["map_pos"].shape[0] == int(g[f"mesh3_w{i}_census"])
            np.testing.assert_array_equal(r["map_counts"],
                                          g[f"mesh3_w{i}_map_counts"])
            for f in ("x_init", "x", "map_pos"):
                np.testing.assert_allclose(r[f], g[f"mesh3_w{i}_{f}"],
                                           atol=1e-3)
