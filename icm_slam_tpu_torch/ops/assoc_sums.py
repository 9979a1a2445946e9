"""Fused association + per-frame landmark sums (K1): wrapper and plain version.

Port of ``icm_slam_tpu.ops.assoc_sums_pallas.associate_and_sums``.  On a
CUDA tensor ``associate_and_sums`` launches the hand-written kernel in
``csrc/assoc_sums.cu`` (or raises); on a CPU tensor it runs
``associate_and_sums_plain``, the same contract in plain PyTorch.  Dead
columns (>= nact) are skipped instead of being moved to the JAX kernel's
far sentinel, so a beam with no live column reports d2min = +inf (JAX:
~1e18) with label 0 in both; the gate rejects both alike.

The kernel's layout on the card (one block a frame, 8 lanes a beam, the
bytes of shared memory) is ``launch_plan``'s, so the CPU tests reach it.

Worlds: every form also takes a leading world axis W (``pts`` (W, T, B,
2), ``map_pos`` (W, K, 2), ``mask`` (W, T, B), ``nact`` (W,)), each world
against its own columns and live count, in one launch of W * T blocks; the
(T, B, 2) form is W = 1.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from icm_slam_tpu_torch.ops import _build
from icm_slam_tpu_torch.ops.assoc import lane_min, live_d2

# the launches are counted in ``_build.LAUNCHES`` as "assoc_sums", by the
# call's shape: (T, B, K) for one world, (W, T, B, K) for a fleet of W > 1

_MAX_SHMEM = 48 * 1024
LANES = 8           # lanes of a warp that share a beam in the argmin pass
_THREADS = 128


class LaunchPlan(NamedTuple):
    """How one call of K1 is laid out on the card."""
    lanes: int
    blocks: int     # one per frame
    threads: int    # per block
    shmem: int      # bytes of dynamic shared memory per block


@functools.lru_cache(maxsize=64)
def launch_plan(T: int, B: int, K: int) -> LaunchPlan:
    """One block per frame (of each world); its shared memory holds the
    frame's 3 * K sums (rounded up to 16 bytes), the K columns as (x, y)
    pairs, and x, y and the gated label of each of the B beams."""
    shmem = -(-12 * K // 16) * 16 + 8 * K + 12 * B
    return LaunchPlan(LANES, T, _THREADS, shmem)


def associate_and_sums_plain(pts, map_pos, mask, nact, dist_thr,
                             lanes: int = 1):
    """pts (T, B, 2) f32; map_pos (K, 2) f32; mask (T, B) bool; nact: live
    column count (int or 0-d tensor) — or all of them with a leading world
    axis W (nact (W,)); dist_thr float; lanes: split the columns as the
    kernel's argmin pass does (the result is the same for every value).

    Returns (lab (..., T, B) int32 — argmin over the live columns,
             d2min (..., T, B) f32 — its squared distance,
             sums (..., T, 3, K) f32 — per frame [sum px*w, sum py*w,
             sum w], w = mask & (d2min <= dist_thr^2)).
    """
    K = map_pos.shape[-2]
    d2min, lab = lane_min(live_d2(pts, map_pos, nact), lanes)
    w = mask & (d2min <= dist_thr * dist_thr)
    wh = ((lab[..., None] == torch.arange(K, device=pts.device))
          & w[..., None]).to(pts.dtype)                       # (..., T, B, K)
    sums = torch.stack([(wh * pts[..., 0:1]).sum(dim=-2),
                        (wh * pts[..., 1:2]).sum(dim=-2),
                        wh.sum(dim=-2)], dim=-2)
    return lab.to(torch.int32), d2min, sums


def _check(pts, map_pos, mask, nact):
    """Check a call in either form; returns it in the world form: pts
    (W, T, B, 2), mask (W, T, B) and nact (W,) contiguous, map_pos
    (W, K, 2) with contiguous rows (a column slice of a wider table is
    taken where it lies)."""
    if pts.dim() == 3:
        if nact.dim() != 0 or map_pos.dim() != 2 or mask.dim() != 2:
            raise ValueError("one world: map_pos must be (K, 2), mask "
                             "(T, B) and nact a 0-d int32 tensor")
        pts, map_pos, mask, nact = (pts[None], map_pos[None], mask[None],
                                    nact.reshape(1))
    dev = pts.device
    if pts.dim() != 4 or pts.shape[3] != 2 or pts.dtype != torch.float32:
        raise ValueError(f"pts must be (T, B, 2) or (W, T, B, 2) float32, "
                         f"got {tuple(pts.shape)} {pts.dtype}")
    W, T, B, _ = pts.shape
    if map_pos.dim() != 3 or map_pos.shape[0] != W or map_pos.shape[2] != 2 \
            or map_pos.dtype != torch.float32:
        raise ValueError(f"map_pos must be (K, 2) or ({W}, K, 2) float32, "
                         f"got {tuple(map_pos.shape)} {map_pos.dtype}")
    if tuple(mask.shape) != (W, T, B) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be ({T}, {B}) bool (with the points' "
                         f"world axis), got {tuple(mask.shape)} {mask.dtype}")
    if tuple(nact.shape) != (W,) or nact.dtype != torch.int32:
        raise ValueError("nact must be a 0-d int32 tensor, or (W,) with a "
                         "world axis")
    for name, a in (("pts", pts), ("map_pos", map_pos), ("mask", mask),
                    ("nact", nact)):
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, pts on {dev}")
        if name != "map_pos" and not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _build.world_stride(map_pos)
    _build.check_pairs_aligned(pts=pts, map_pos=map_pos)
    K = map_pos.shape[1]
    if launch_plan(T, B, K).shmem > _MAX_SHMEM:
        raise ValueError(f"K={K}, B={B} exceed the kernel's shared memory")
    if W > 65535:
        raise ValueError("too many worlds for one launch")
    return pts, map_pos, mask, nact


def associate_and_sums(pts, map_pos, mask, nact, dist_thr):
    """K1 on CUDA tensors, the plain version on CPU tensors (same contract
    as ``associate_and_sums_plain``).  A fleet of W worlds is one launch."""
    if pts.is_cpu:
        return associate_and_sums_plain(pts, map_pos, mask, nact, dist_thr)
    if not pts.is_cuda:
        raise ValueError(f"associate_and_sums: unsupported device "
                         f"{pts.device}")
    one = pts.dim() == 3
    pts, map_pos, mask, nact = _check(pts, map_pos, mask,
                                      _build.as_count(nact, pts.device))
    W, T, B, _ = pts.shape
    K = map_pos.shape[1]
    lab = torch.empty((W, T, B), dtype=torch.int32, device=pts.device)
    d2min = torch.empty((W, T, B), dtype=torch.float32, device=pts.device)
    sums = torch.empty((W, T, 3, K), dtype=torch.float32, device=pts.device)
    if W * T > 0:
        plan = launch_plan(T, B, K)
        fn = _build.library().icm_assoc_sums
        with _build.on_device(pts.device):
            err = fn(pts.data_ptr(), map_pos.data_ptr(), mask.data_ptr(),
                     nact.data_ptr(), W, T, B, K,
                     _build.world_stride(map_pos),
                     float(dist_thr) * float(dist_thr), plan.threads,
                     plan.shmem, lab.data_ptr(), d2min.data_ptr(),
                     sums.data_ptr(), _build.current_stream(pts.device))
        _build.check(err, "icm_assoc_sums")
        _build.count_launch("assoc_sums",
                            (T, B, K) if W == 1 else (W, T, B, K))
    return (lab[0], d2min[0], sums[0]) if one else (lab, d2min, sums)
