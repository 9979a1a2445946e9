"""The time-axis mesh of the port's ``parallel/``, on gloo CPU ranks:
``refine_sweep_batched(..., mesh=...)`` on each rank's block of frames
against the unsharded port sweep and JAX's ``refine_sweep_batched``.

Each group of n ranks (1, 2 and 4) is spawned once for the module
(``tests/torch_dist_workers.py``, no JAX in the ranks); the cases read
what its ranks returned.  Five configurations (the capped quirk path (K1),
the uncapped one (K2), the non-quirk labels, Jacobi passes, and a hook
that extends the two-sided cost, so that the rank holding the last frame
solves it on its own) on three worlds: tests/test_sharding.py's world and
config (T=67, padded to 68; it spawns no landmark), a world whose frames
spawn landmarks on every rank (T=120, L=256) and one of nine frames
padded to 16, whose last frame opens a block (the rank that holds it
reads its predecessor from the halo) and whose last rank holds only
padding at four ranks.

Held as tests/test_sharding.py holds JAX's mesh: the census exact, the
poses and the map within 5e-4 (the rank-order sums of the prefixes
reorder the f32 running means), and every rank's results the same bits;
at one rank, bitwise the unsharded sweep (the prefixes add nothing).
Each world is probed first: scaling JAX's odometry by 1 +- 1e-6 moves
JAX's own poses by less than the band (at most 1.6e-4 here), so the band
can tell a fault from rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from icm_slam_tpu.config import ICMConfig as JC
from icm_slam_tpu.core.energy import EnergyModel as JModel
from icm_slam_tpu.core.energy import weights as jweights
from icm_slam_tpu.mapping.landmark_map import MapState as JMap
from icm_slam_tpu.solver import sweeps as jsw
from icm_slam_tpu_torch import convert
from icm_slam_tpu_torch.core.energy import weights
from icm_slam_tpu_torch.mapping.landmark_map import filter_map
from icm_slam_tpu_torch.solver.sweeps import refine_sweep_batched
from tests import torch_dist_workers as tw
from tests.torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

RANKS = (1, 2, 4)
BAND = 5e-4
PROBE = 1e-6
SWEEPS = [(wld, case) for wld in tw.SWEEP_WORLDS for case in tw.SWEEP_CASES]


@pytest.fixture(scope="module", params=RANKS, ids=lambda n: f"{n}ranks")
def group(request, tmp_path_factory):
    n = request.param
    return n, tw.spawn(tw.time_worker, n, tmp_path_factory.mktemp(f"t{n}"))


def _jax_config(tc, case):
    kw = convert.config_dict(tc)
    kw.pop("model")
    model = None
    if case == "hook":
        model = JModel(extra_two_sided=lambda x, p: 5.0 * (
            x[:2] - p.odo_cur[:2]))
    return JC(**kw, model=model)


@pytest.fixture(scope="module")
def references(one_thread):
    """Per (world, case): the unsharded port sweep and its filtered map,
    JAX's sweep on the same inputs, and how far JAX's own poses move when
    its odometry is scaled by 1 +- PROBE."""
    out = {}
    for wld in tw.SWEEP_WORLDS:
        data, seed, x = tw.sweep_inputs(wld)
        dn = convert.sweep_data_to_numpy(data)
        for case in tw.SWEEP_CASES:
            tc = tw.sweep_config(case, wld)
            st, xt = refine_sweep_batched(data, seed, x, tc,
                                          weights(tc, "cpu"))
            fm = filter_map(st, tc.cota, tc.dist_thr)
            jc = _jax_config(tc, case)
            jw = jweights(jc)
            step = jax.jit(lambda d, m, xx: jsw.refine_sweep_batched(
                d, m, xx, jc, jw))

            def jax_sweep(scale):
                d = jsw.SweepData(*(jnp.asarray(a) for a in dn))
                return step(d._replace(odom=d.odom * scale),
                            JMap(*(jnp.asarray(a.numpy()) for a in seed)),
                            jnp.asarray(x.numpy()) * scale)

            jst, jx = jax_sweep(1.0)
            probe = max(float(np.abs(np.asarray(jax_sweep(s)[1])
                                     - np.asarray(jx)).max())
                        for s in (1 + PROBE, 1 - PROBE))
            out[wld, case] = dict(
                x=xt.numpy(), state=tuple(a.numpy() for a in st),
                filtered=tuple(a.numpy() for a in fm), jx=np.asarray(jx),
                jstate=(np.asarray(jst.pos), np.asarray(jst.counts),
                        int(jst.nact)), probe=probe)
    return out


@pytest.mark.parametrize("wld,case", SWEEPS)
def test_world_is_not_rounding_sensitive_for_the_band(references, wld,
                                                      case):
    assert references[wld, case]["probe"] < BAND / 2


def test_worlds_spawn_landmarks_across_ranks(references):
    """t120's sweep allocates labels on every rank's frames (20 live from
    a seed of 1), so the label prefixes and the gathered new columns
    carry real work; t67 allocates none (tests/test_sharding.py's)."""
    assert int(references["t120", "k1"]["state"][2]) == 20
    assert int(references["t67", "k2"]["state"][2]) == 2


@pytest.mark.parametrize("wld,case", SWEEPS)
def test_sharded_sweep_against_unsharded_and_jax(group, references, wld,
                                                 case):
    n, out = group
    ref = references[wld, case]
    first = out[0][f"sweep_{wld}_{case}"]
    for o in out:
        got = o[f"sweep_{wld}_{case}"]
        # every rank holds the same bits
        assert np.array_equal(got["x"], first["x"])
        for a, b in zip(got["state"] + got["filtered"],
                        first["state"] + first["filtered"]):
            assert np.array_equal(a, b)
    nact = int(ref["state"][2])
    assert int(first["state"][2]) == nact == ref["jstate"][2]
    assert int(first["filtered"][2]) == int(ref["filtered"][2])
    np.testing.assert_array_equal(first["state"][1][:nact],
                                  ref["state"][1][:nact])
    np.testing.assert_array_equal(first["state"][1][:nact],
                                  ref["jstate"][1][:nact])
    if n == 1:
        assert np.array_equal(first["x"], ref["x"])
        for a, b in zip(first["state"] + first["filtered"],
                        ref["state"] + ref["filtered"]):
            assert np.array_equal(a, b)
    for x_ref in (ref["x"], ref["jx"]):
        np.testing.assert_allclose(first["x"], x_ref, atol=BAND)
    for pos in (ref["state"][0], ref["jstate"][0]):
        np.testing.assert_allclose(first["state"][0][:nact], pos[:nact],
                                   atol=BAND)


def test_blocks_split_the_padded_axis(group):
    n, out = group
    blocks = {wld: -(-kw["T"] // max(pad or 1, n)) * max(pad or 1, n) // n
              for wld, (kw, _, pad) in tw.SWEEP_WORLDS.items()}
    for o in out:
        for wld, b in blocks.items():
            assert o[f"sweep_{wld}_k2"]["block"] == b


def test_padding_round_trip(group):
    """T=61 padded to 64 (pad_to=8, as tests/test_sharding.py's 8
    devices): the padded frames all-masked, the true T returned, the real
    frames and poses back in place, the 1-D angles shared."""
    n, out = group
    data, _, x = tw.sweep_inputs(T=61)
    for o in out:
        p = o["pad61"]
        assert p["T"] == 61 and p["mask"].shape[0] == 64
        assert p["block"] == 64 // n
        assert not p["mask"][61:].any()
        assert np.array_equal(p["mask"][:61], data.mask.numpy())
        assert np.array_equal(p["dist"][:61], data.dist.numpy())
        assert np.array_equal(p["x"], x.numpy())
        assert np.array_equal(p["ang"], data.ang.numpy())
