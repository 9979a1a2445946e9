"""The port's engines against the reference oracle
(tests/oracle/reference_oracle.py, the reference's algorithm in NumPy),
with tests/test_fuzz_oracle.py's gates for the JAX package.

The oracle's poses and map for ``synthetic_world(T=150, n_landmarks=10,
seed=s)``, s in 0, 1, 4, with ``OracleParams(N=3, L=256, cota=5)`` are
stored in tests/golden/torch_oracle_synth.npz (made by
tools/make_torch_golden.py; no Nelder-Mead runs here).  The port runs
``run()`` on the CPU with the same ingest (the first pose is the first
odometry row): the batched engine within a mean position error of 0.1 on
every seed, its census exact on seeds 0 and 4 and within one on seed 1
(one borderline duplicate merge, as JAX's); the sequential engine on seed
1 with its census exact and the error below 0.05.
"""
import os

import numpy as np
import pytest

from icm_slam_tpu_torch.config import ICMConfig as TC
from icm_slam_tpu_torch.data.datasets import (Dataset, synthetic_world,
                                              world_checksum)
from icm_slam_tpu_torch.solver.icm import run
from tests.torch_parity import one_thread  # noqa: F401

# one CPU thread: these small worlds run 2-3x faster without threads
pytestmark = pytest.mark.usefixtures("one_thread")

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "torch_oracle_synth.npz")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _run_vs_oracle(golden, seed, **kw):
    """The port's run on the oracle's world and ingest: (census, oracle's
    census, mean position error against the oracle)."""
    ds = synthetic_world(T=150, n_landmarks=10, seed=seed)
    assert world_checksum(ds) == str(golden[f"o{seed}_world_checksum"])
    ds = Dataset(ds.scans, ds.odom, ds.u, np.asarray(ds.odom)[0].copy(),
                 name="fuzz")
    res = run(ds, TC(N=3, L=256, cota=5.0, **kw), "cpu")
    x_o = golden[f"o{seed}_x"]
    assert res.x.shape == x_o.shape and np.isfinite(res.x).all()
    err = float(np.mean(np.linalg.norm(res.x[:, :2] - x_o[:, :2], axis=1)))
    return res.map_pos.shape[0], golden[f"o{seed}_map"].shape[1], err


@pytest.mark.parametrize("seed,census_exact", [(0, True), (1, False),
                                               (4, True)])
def test_batched_engine_matches_oracle(golden, seed, census_exact):
    census, census_o, err = _run_vs_oracle(golden, seed)
    assert err < 0.1, err
    if census_exact:
        assert census == census_o
    else:
        assert abs(census - census_o) <= 1, (census, census_o)


def test_sequential_engine_census_exact_where_batched_differs(golden):
    census, census_o, err = _run_vs_oracle(golden, 1,
                                           sweep_mode="sequential")
    assert census == census_o
    assert err < 0.05, err
