"""Fused association + per-frame landmark sums (K1): wrapper and plain version.

Port of ``icm_slam_tpu.ops.assoc_sums_pallas.associate_and_sums``.  On a
CUDA tensor ``associate_and_sums`` launches the hand-written kernel in
``csrc/assoc_sums.cu`` (or raises); on a CPU tensor it runs
``associate_and_sums_plain``, the same contract in plain PyTorch.  Dead
columns (>= nact) are skipped instead of being moved to the JAX kernel's
far sentinel, so a beam with no live column reports d2min = +inf (JAX:
~1e18) with label 0 in both; the gate rejects both alike.
"""
from __future__ import annotations

import torch

from icm_slam_tpu_torch.ops import _build

# kernel launches by associate_and_sums (the plain version does not count)
LAUNCHES = 0

_MAX_SHMEM = 48 * 1024


def associate_and_sums_plain(pts, map_pos, mask, nact, dist_thr):
    """pts (T, B, 2) f32; map_pos (K, 2) f32; mask (T, B) bool; nact: live
    column count (int or 0-d tensor); dist_thr float.

    Returns (lab (T, B) int32 — argmin over the live columns,
             d2min (T, B) f32 — its squared distance,
             sums (T, 3, K) f32 — per frame [sum px*w, sum py*w, sum w],
             w = mask & (d2min <= dist_thr^2)).
    """
    K = map_pos.shape[0]
    live = torch.arange(K, device=pts.device) < nact
    dx = pts[..., 0:1] - map_pos[:, 0]                        # (T, B, K)
    dy = pts[..., 1:2] - map_pos[:, 1]
    d2 = torch.where(live, dx * dx + dy * dy, float("inf"))
    d2min, lab = d2.min(dim=-1)
    w = mask & (d2min <= dist_thr * dist_thr)
    wh = ((lab[..., None] == torch.arange(K, device=pts.device))
          & w[..., None]).to(pts.dtype)                       # (T, B, K)
    sums = torch.stack([(wh * pts[..., 0:1]).sum(dim=1),
                        (wh * pts[..., 1:2]).sum(dim=1),
                        wh.sum(dim=1)], dim=1)
    return lab.to(torch.int32), d2min, sums


def _check(pts, map_pos, mask, nact):
    dev = pts.device
    if pts.dim() != 3 or pts.shape[2] != 2 or pts.dtype != torch.float32:
        raise ValueError(f"pts must be (T, B, 2) float32, got "
                         f"{tuple(pts.shape)} {pts.dtype}")
    T, B, _ = pts.shape
    if map_pos.dim() != 2 or map_pos.shape[1] != 2 \
            or map_pos.dtype != torch.float32:
        raise ValueError(f"map_pos must be (K, 2) float32, got "
                         f"{tuple(map_pos.shape)} {map_pos.dtype}")
    if tuple(mask.shape) != (T, B) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be ({T}, {B}) bool, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    if nact.shape != () or nact.dtype != torch.int32:
        raise ValueError("nact must be a 0-d int32 tensor")
    for name, a in (("pts", pts), ("map_pos", map_pos), ("mask", mask),
                    ("nact", nact)):
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, pts on {dev}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    K = map_pos.shape[0]
    if (2 * K + 3 * B) * 4 + 4 * B > _MAX_SHMEM:
        raise ValueError(f"K={K}, B={B} exceed the kernel's shared memory")


def associate_and_sums(pts, map_pos, mask, nact, dist_thr):
    """K1 on CUDA tensors, the plain version on CPU tensors (same contract
    as ``associate_and_sums_plain``)."""
    global LAUNCHES
    if pts.device.type == "cpu":
        return associate_and_sums_plain(pts, map_pos, mask, nact, dist_thr)
    if pts.device.type != "cuda":
        raise ValueError(f"associate_and_sums: unsupported device "
                         f"{pts.device}")
    nact = torch.as_tensor(nact, dtype=torch.int32, device=pts.device)
    _check(pts, map_pos, mask, nact)
    T, B, _ = pts.shape
    K = map_pos.shape[0]
    lab = torch.empty((T, B), dtype=torch.int32, device=pts.device)
    d2min = torch.empty((T, B), dtype=torch.float32, device=pts.device)
    sums = torch.empty((T, 3, K), dtype=torch.float32, device=pts.device)
    lib = _build.library()
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.icm_assoc_sums(
            pts.data_ptr(), map_pos.data_ptr(), mask.data_ptr(),
            nact.data_ptr(), T, B, K, float(dist_thr) * float(dist_thr),
            lab.data_ptr(), d2min.data_ptr(), sums.data_ptr(), stream)
    _build.check(err, "icm_assoc_sums")
    LAUNCHES += 1
    return lab, d2min, sums
