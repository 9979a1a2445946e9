"""Checkpoint / resume files for the ICM outer loop (NumPy only).

A copy of ``icm_slam_tpu.utils.checkpoint``; the port's tests hold it
bitwise against the original.

The reference holds all state in RAM and writes nothing (SURVEY.md §5).
Here each outer iteration's state — poses, landmark table, counts, live
count, iteration index — is tiny (~50 KB), so checkpointing is a cheap .npz
write enabling deterministic restart from the last completed iteration
(multi-host failure recovery = rerun from the last checkpoint).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


def save(path: str, iteration: int, x: np.ndarray, map_pos: np.ndarray,
         map_counts: np.ndarray, nact: int, x_init: Optional[np.ndarray] = None,
         extra: Optional[dict] = None):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = dict(iteration=iteration, x=np.asarray(x),
                   map_pos=np.asarray(map_pos),
                   map_counts=np.asarray(map_counts), nact=int(nact))
    if x_init is not None:
        payload["x_init"] = np.asarray(x_init)
    if extra:
        payload.update(extra)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **payload)
    os.replace(tmp, path)


def load(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def latest(directory: str, prefix: str = "icm_ckpt_") -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    cands = [f for f in os.listdir(directory)
             if f.startswith(prefix) and f.endswith(".npz")]
    if not cands:
        return None
    cands.sort(key=lambda f: int(f[len(prefix):-4]))
    return os.path.join(directory, cands[-1])
