"""Dataset replay feeder (NumPy only): yields (ranges, odom, u) frames,
optionally rate-limited (the reference replays at 10 Hz, createbag.py:144).

A copy of ``stream_dataset`` from ``icm_slam_tpu.runtime.replay``.
"""
from __future__ import annotations

import time
from typing import Iterator, Tuple

import numpy as np

from icm_slam_tpu_torch.data.datasets import Dataset


def stream_dataset(ds: Dataset, hz: float = 0.0
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield per-frame tuples; hz > 0 paces wall-clock like a live sensor."""
    period = 1.0 / hz if hz > 0 else 0.0
    next_t = time.monotonic()
    for t in range(ds.T):
        if period:
            now = time.monotonic()
            if now < next_t:
                time.sleep(next_t - now)
            next_t += period
        yield ds.scans[t], ds.odom[t], ds.u[t]
