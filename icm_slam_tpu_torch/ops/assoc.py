"""Nearest live landmark of every beam point (K2): wrapper and plain version.

Port of ``icm_slam_tpu.ops.assoc_pallas.nearest_landmark``.  On a CUDA
tensor ``nearest_landmark`` launches the hand-written kernel in
``csrc/nearest_landmark.cu`` (or raises); on a CPU tensor it runs
``nearest_landmark_plain``, the same contract in plain PyTorch.  The
argmin is taken over squared distances with the first minimum winning, as
in the JAX kernel; with no live column the label is 0 and the distance
+inf (JAX: ~1e9 from its dead-column sentinel).  With ``sqrt_key`` the
argmin is taken over the distances sqrt(d^2) instead (IEEE-rounded, the
first minimum winning), the rule of JAX's ``landmark_map.associate``: on
two columns whose d^2 differ but whose square roots round equal, it picks
the first where the d^2 rule picks the nearer.  ``landmark_map.update``
takes that key; the batched sweeps keep the d^2 rule of the Pallas kernel.

Which of the kernel's variants a call takes is decided here, by
``launch_plan``, from the number of points and the table's width alone, so
the CPU tests reach the choice; ``lane_min`` is the kernels' rule for
combining the lanes that share a point, in plain PyTorch.

Worlds: every form also takes a leading world axis W (``pts`` (W, T, B,
2), ``map_pos`` (W, L, 2), ``nact`` (W,)), each world against its own
table and live count, in one launch; the (T, B, 2) form is W = 1.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from icm_slam_tpu_torch.ops import _build

# the launches are counted in ``_build.LAUNCHES`` as "nearest_landmark", by
# the call's shape: (T, B, L) for one world, (W, T, B, L) for a fleet of
# W > 1

# columns a block keeps in shared memory at once (8 bytes each); a wider
# table is scanned chunk by chunk
RESIDENT_COLUMNS = 4096
_GROUP_BYTES = 256          # shared memory comes in groups of 32 columns
# up to this many points a point gets the 32 lanes of a warp, beyond it a
# thread of its own
_LANES32_MAX_POINTS = 4096


class LaunchPlan(NamedTuple):
    """How one call of K2 is laid out on the card."""
    lanes: int      # lanes of a warp that share a point: 32 or 1
    blocks: int
    threads: int    # per block
    shmem: int      # bytes of dynamic shared memory per block


def plan_for(n_pts: int, L: int, lanes: int, threads: int = 128,
             columns: int = RESIDENT_COLUMNS) -> LaunchPlan:
    """The plan of one variant: enough blocks for every point, and shared
    memory for ``min(L, columns)`` columns in whole groups of 32."""
    cols = max(min(L, columns), 1)
    shmem = -(-cols * 8 // _GROUP_BYTES) * _GROUP_BYTES
    blocks = -(-n_pts * lanes // threads)
    return LaunchPlan(lanes, blocks, threads, shmem)


@functools.lru_cache(maxsize=64)
def launch_plan(n_pts: int, L: int, sqrt_key: bool = False) -> LaunchPlan:
    """The variant of the kernel for ``n_pts`` points against ``L`` columns.

    One frame (181 points) gets 32 lanes a point, so that it fills dozens
    of blocks and each lane scans a 32nd of the columns; a whole run (88k
    points) gets the grouped kernel, a thread a point.  No caller gives a
    point count between those two; ``chip_smoke.py`` times both variants at
    every shape the callers give (its ``k2_variants_timed`` line).  The
    sqrt key has the 32-lane kernel only (its callers give one frame).
    Nothing here asks the card anything; with no point, no block is
    launched.
    """
    if n_pts <= _LANES32_MAX_POINTS or sqrt_key:
        return plan_for(n_pts, L, lanes=32, threads=256)
    return plan_for(n_pts, L, lanes=1)


def lane_min(d2, lanes: int):
    """The first minimum of ``d2`` (..., L) along its last axis, taken the
    way the kernels take it with ``lanes`` lanes a point: lane s holds the
    first minimum of columns s, s + lanes, ... (label 0 while it has seen
    nothing below +inf), then a butterfly over the lanes keeps the smaller
    d2 and, on equal d2, the smaller index.  Returns (min, index); for any
    power of two it equals ``d2.min(dim=-1)``."""
    if lanes == 1:
        return d2.min(dim=-1)
    if lanes & (lanes - 1):
        raise ValueError(f"lanes must be a power of two, got {lanes}")
    L = d2.shape[-1]
    pad = -L % lanes
    if pad:
        d2 = torch.cat([d2, d2.new_full((*d2.shape[:-1], pad),
                                        float("inf"))], dim=-1)
    per_lane = d2.reshape(*d2.shape[:-1], -1, lanes)     # [..., i, s]
    if per_lane.shape[-2] == 0:
        best = d2.new_full((*d2.shape[:-1], lanes), float("inf"))
        arg = torch.zeros(best.shape, dtype=torch.int64, device=d2.device)
    else:
        best, row = per_lane.min(dim=-2)                 # (..., lanes)
        s = torch.arange(lanes, device=d2.device)
        arg = torch.where(torch.isinf(best) & (best > 0), 0,
                          row * lanes + s)
    off = lanes // 2
    idx = torch.arange(lanes, device=d2.device)
    while off:
        ob, oa = best[..., idx ^ off], arg[..., idx ^ off]
        take = (ob < best) | ((ob == best) & (oa < arg))
        best, arg = torch.where(take, ob, best), torch.where(take, oa, arg)
        off //= 2
    return best[..., 0], arg[..., 0]


def live_d2(pts, map_pos, nact):
    """Squared distances (..., T, B, L) of every point to every column,
    +inf on the columns at or beyond ``nact``; the products and the sum
    are rounded one by one, as the kernels round them.  pts (T, B, 2),
    map_pos (L, 2), nact 0-d; or with a leading world axis W on all three
    (nact (W,)), each world against its own table."""
    L = map_pos.shape[-2]
    nact = torch.as_tensor(nact, device=pts.device)
    live = torch.arange(L, device=pts.device) \
        < nact.reshape(nact.shape + (1, 1, 1))
    mx = map_pos[..., None, None, :, 0]                       # (..., 1, 1, L)
    my = map_pos[..., None, None, :, 1]
    dx = pts[..., 0:1] - mx                                   # (..., T, B, L)
    dy = pts[..., 1:2] - my
    return torch.where(live, dx * dx + dy * dy, float("inf"))


def nearest_landmark_plain(pts, map_pos, nact, lanes: int = 1,
                           sqrt_key: bool = False):
    """pts (T, B, 2) f32; map_pos (L, 2) f32; nact: live count (int or
    0-d tensor) — or the same with a leading world axis W (nact (W,));
    lanes: split the columns as the kernel's variant of that many lanes
    does (the result is the same for every value); sqrt_key: the argmin
    of sqrt(d^2), not of d^2.  Returns (labels (..., T, B) int32,
    min_dist (..., T, B) f32)."""
    d2 = live_d2(pts, map_pos, nact)
    if sqrt_key:
        best, lab = lane_min(torch.sqrt(d2), lanes)
        return lab.to(torch.int32), best
    best, lab = lane_min(d2, lanes)
    return lab.to(torch.int32), torch.sqrt(torch.clamp(best, min=0.0))


def _check(pts, map_pos, nact):
    """Check a call in either form; returns it in the world form: pts
    (W, T, B, 2) and nact (W,) contiguous, map_pos (W, L, 2) with
    contiguous rows (a column slice of a wider table is taken where it
    lies)."""
    if pts.dim() == 3:
        if nact.dim() != 0 or map_pos.dim() != 2:
            raise ValueError("one world: map_pos must be (L, 2) and nact a "
                             "0-d int32 tensor")
        pts, map_pos, nact = pts[None], map_pos[None], nact.reshape(1)
    dev = pts.device
    if pts.dim() != 4 or pts.shape[3] != 2 or pts.dtype != torch.float32:
        raise ValueError(f"pts must be (T, B, 2) or (W, T, B, 2) float32, "
                         f"got {tuple(pts.shape)} {pts.dtype}")
    W = pts.shape[0]
    if map_pos.dim() != 3 or map_pos.shape[0] != W or map_pos.shape[2] != 2 \
            or map_pos.dtype != torch.float32:
        raise ValueError(f"map_pos must be (L, 2) or ({W}, L, 2) float32, "
                         f"got {tuple(map_pos.shape)} {map_pos.dtype}")
    if tuple(nact.shape) != (W,) or nact.dtype != torch.int32:
        raise ValueError("nact must be a 0-d int32 tensor, or (W,) with a "
                         "world axis")
    for name, a in (("pts", pts), ("map_pos", map_pos), ("nact", nact)):
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, pts on {dev}")
        if name != "map_pos" and not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _build.world_stride(map_pos)
    _build.check_pairs_aligned(pts=pts, map_pos=map_pos)
    if pts.shape[1] * pts.shape[2] >= 2 ** 31 or W > 65535:
        raise ValueError("too many points for one launch")
    return pts, map_pos, nact


def launch(pts, map_pos, nact, plan: LaunchPlan, sqrt_key: bool = False):
    """Launch K2 on CUDA tensors with ``plan`` (blocks per world); raises
    when the card refuses it (the sqrt key with a plan of one lane a
    point among others).  ``nearest_landmark`` is the caller; the checks
    on the card call this with every variant at one shape."""
    one = pts.dim() == 3
    pts, map_pos, nact = _check(pts, map_pos, nact)
    W, T, B, _ = pts.shape
    L = map_pos.shape[1]
    lab = torch.empty((W, T, B), dtype=torch.int32, device=pts.device)
    dist = torch.empty((W, T, B), dtype=torch.float32, device=pts.device)
    if W * T * B > 0:
        fn = _build.library().icm_nearest_landmark
        with _build.on_device(pts.device):
            err = fn(pts.data_ptr(), map_pos.data_ptr(), nact.data_ptr(), W,
                     T * B, L, _build.world_stride(map_pos), plan.lanes,
                     plan.blocks, plan.threads, plan.shmem, int(sqrt_key),
                     lab.data_ptr(), dist.data_ptr(),
                     _build.current_stream(pts.device))
        _build.check(err, "icm_nearest_landmark")
        _build.count_launch("nearest_landmark",
                            (T, B, L) if W == 1 else (W, T, B, L))
    return (lab[0], dist[0]) if one else (lab, dist)


def nearest_landmark(pts, map_pos, nact, sqrt_key: bool = False):
    """K2 on CUDA tensors, the plain version on CPU tensors (same contract
    as ``nearest_landmark_plain``).  A fleet of W worlds is one launch."""
    if pts.is_cpu:
        return nearest_landmark_plain(pts, map_pos, nact, sqrt_key=sqrt_key)
    if not pts.is_cuda:
        raise ValueError(f"nearest_landmark: unsupported device "
                         f"{pts.device}")
    nact = _build.as_count(nact, pts.device)
    return launch(pts, map_pos, nact,
                  launch_plan(pts.shape[-3] * pts.shape[-2],
                              map_pos.shape[-2], sqrt_key), sqrt_key)
