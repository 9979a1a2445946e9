"""Port parity: datasets (bitwise) and the scan filter (mask bitwise, dist
exact)."""
import numpy as np
import pytest

from icm_slam_tpu.data import datasets as jd
from icm_slam_tpu.frontend import scan_filter as jsf
from icm_slam_tpu_torch.data import datasets as td
from icm_slam_tpu_torch.frontend import scan_filter as tsf
from tests.torch_parity import assert_equal, jf32, tf32


@pytest.mark.parametrize("kw", [dict(T=120, seed=3),
                                dict(T=90, n_landmarks=7, seed=11,
                                     loop=False, laps=2)])
def test_synthetic_world_bitwise(kw):
    a = jd.synthetic_world(**kw, return_truth=True)
    b = td.synthetic_world(**kw, return_truth=True)
    for f in ("scans", "odom", "u", "x0"):
        assert_equal(getattr(b[0], f), getattr(a[0], f))
    assert b[0].name == a[0].name
    assert_equal(b[1], a[1])
    assert_equal(b[2], a[2])
    assert td.world_checksum(b[0]) == td.world_checksum(a[0])


def test_drifted_world_bitwise():
    a = jd.drifted_world(T=150, n_landmarks=20, seed=5)
    b = td.drifted_world(T=150, n_landmarks=20, seed=5)
    for f in ("scans", "odom", "u", "x0"):
        assert_equal(getattr(b[0], f), getattr(a[0], f))
    assert_equal(b[1], a[1])
    assert_equal(b[2], a[2])


def test_palomar_noise_cap_bitwise():
    rng = np.random.default_rng(2)
    scans = np.where(rng.uniform(size=(60, 181)) < 0.1,
                     rng.uniform(0.5, 9.0, (60, 181)), 10.0)
    scans[[7, 30]] = rng.uniform(0.5, 9.0, (2, 181))    # noise bursts
    assert_equal(td._palomar_noise_cap(scans, 10.0),
                 jd._palomar_noise_cap(scans, 10.0))


def _raw_scans():
    ds = jd.synthetic_world(T=160, n_landmarks=25, seed=4)
    scans = ds.scans.copy()
    scans[10] = 10.0                           # blackout frame
    scans[11, :] = 10.0
    scans[11, 40] = 3.0                        # a single valid beam
    scans[12, 5:9] = np.nan                    # NaN returns
    scans[13, 50:53] = 4.0                     # exact duplicate points
    return scans


def test_preprocess_and_median_exact():
    raw = _raw_scans()
    rj = jsf.preprocess_ranges(jf32(raw), 10.0, 0.137)
    rt = tsf.preprocess_ranges(tf32(raw), 10.0, 0.137)
    assert_equal(rt, rj)
    assert_equal(tsf.median3(rt), jsf.median3(rj))


@pytest.mark.parametrize("dist_thr", [1.0, 0.3])
def test_filter_scans_mask_bitwise(dist_thr):
    raw = _raw_scans()
    rj = jsf.preprocess_ranges(jf32(raw), 10.0, 0.137)
    rt = tsf.preprocess_ranges(tf32(raw), 10.0, 0.137)
    dj, mj = jsf.filter_scans(rj, 10.0, dist_thr, 181)
    dt, mt = tsf.filter_scans(rt, 10.0, dist_thr, 181)
    assert_equal(mt, mj)
    assert_equal(dt, dj)
    assert not mt[10].any() and not mt[11].any()
    assert mt.any()
