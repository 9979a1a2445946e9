"""Nearest live landmark of every beam point (K2): wrapper and plain version.

Port of ``icm_slam_tpu.ops.assoc_pallas.nearest_landmark``.  On a CUDA
tensor ``nearest_landmark`` launches the hand-written kernel in
``csrc/nearest_landmark.cu`` (or raises); on a CPU tensor it runs
``nearest_landmark_plain``, the same contract in plain PyTorch.  The
argmin is taken over squared distances with the first minimum winning, as
in the JAX kernel; with no live column the label is 0 and the distance
+inf (JAX: ~1e9 from its dead-column sentinel).
"""
from __future__ import annotations

import torch

from icm_slam_tpu_torch.ops import _build

# kernel launches by nearest_landmark (the plain version does not count)
LAUNCHES = 0


def nearest_landmark_plain(pts, map_pos, nact):
    """pts (T, B, 2) f32; map_pos (L, 2) f32; nact: live count (int or
    0-d tensor).  Returns (labels (T, B) int32, min_dist (T, B) f32)."""
    L = map_pos.shape[0]
    live = torch.arange(L, device=pts.device) < nact
    dx = pts[..., 0:1] - map_pos[:, 0]                        # (T, B, L)
    dy = pts[..., 1:2] - map_pos[:, 1]
    d2 = torch.where(live, dx * dx + dy * dy, float("inf"))
    best, lab = d2.min(dim=-1)
    return lab.to(torch.int32), torch.sqrt(torch.clamp(best, min=0.0))


def _check(pts, map_pos, nact):
    dev = pts.device
    if pts.dim() != 3 or pts.shape[2] != 2 or pts.dtype != torch.float32:
        raise ValueError(f"pts must be (T, B, 2) float32, got "
                         f"{tuple(pts.shape)} {pts.dtype}")
    if map_pos.dim() != 2 or map_pos.shape[1] != 2 \
            or map_pos.dtype != torch.float32:
        raise ValueError(f"map_pos must be (L, 2) float32, got "
                         f"{tuple(map_pos.shape)} {map_pos.dtype}")
    if nact.shape != () or nact.dtype != torch.int32:
        raise ValueError("nact must be a 0-d int32 tensor")
    for name, a in (("pts", pts), ("map_pos", map_pos), ("nact", nact)):
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, pts on {dev}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if pts.shape[0] * pts.shape[1] >= 2 ** 31:
        raise ValueError("too many points for one launch")


def nearest_landmark(pts, map_pos, nact):
    """K2 on CUDA tensors, the plain version on CPU tensors (same contract
    as ``nearest_landmark_plain``)."""
    global LAUNCHES
    if pts.device.type == "cpu":
        return nearest_landmark_plain(pts, map_pos, nact)
    if pts.device.type != "cuda":
        raise ValueError(f"nearest_landmark: unsupported device "
                         f"{pts.device}")
    nact = torch.as_tensor(nact, dtype=torch.int32, device=pts.device)
    _check(pts, map_pos, nact)
    T, B, _ = pts.shape
    lab = torch.empty((T, B), dtype=torch.int32, device=pts.device)
    dist = torch.empty((T, B), dtype=torch.float32, device=pts.device)
    lib = _build.library()
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.icm_nearest_landmark(
            pts.data_ptr(), map_pos.data_ptr(), nact.data_ptr(), T * B,
            map_pos.shape[0], lab.data_ptr(), dist.data_ptr(), stream)
    _build.check(err, "icm_nearest_landmark")
    LAUNCHES += 1
    return lab, dist
