"""Nearest live landmark of every beam point (K2): wrapper and plain version.

Port of ``icm_slam_tpu.ops.assoc_pallas.nearest_landmark``.  On a CUDA
tensor ``nearest_landmark`` launches the hand-written kernel in
``csrc/nearest_landmark.cu`` (or raises); on a CPU tensor it runs
``nearest_landmark_plain``, the same contract in plain PyTorch.  The
argmin is taken over squared distances with the first minimum winning, as
in the JAX kernel; with no live column the label is 0 and the distance
+inf (JAX: ~1e9 from its dead-column sentinel).

Which of the kernel's variants a call takes is decided here, by
``launch_plan``, from the number of points and the table's width alone, so
the CPU tests reach the choice; ``lane_min`` is the kernels' rule for
combining the lanes that share a point, in plain PyTorch.
"""
from __future__ import annotations

import collections
import functools
from typing import NamedTuple

import torch

from icm_slam_tpu_torch.ops import _build

# kernel launches by nearest_landmark (the plain version does not count),
# in all and by the call's shape (T, B, L)
LAUNCHES = 0
LAUNCH_SHAPES = collections.Counter()

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
def launch_plan(n_pts: int, L: int) -> LaunchPlan:
    """The variant of the kernel for ``n_pts`` points against ``L`` columns.

    One frame (181 points) gets 32 lanes a point, so that it fills dozens
    of blocks and each lane scans a 32nd of the columns; a whole run (88k
    points) gets the grouped kernel, a thread a point.  No caller gives a
    point count between those two; ``chip_smoke.py`` times both variants at
    every shape the callers give (its ``k2_variants_timed`` line).  Nothing
    here asks the card anything; with no point, no block is launched.
    """
    if n_pts <= _LANES32_MAX_POINTS:
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
    """Squared distances (T, B, L) of every point to every column, +inf
    on the columns at or beyond ``nact``; the products and the sum are
    rounded one by one, as the kernels round them."""
    L = map_pos.shape[0]
    live = torch.arange(L, device=pts.device) < nact
    dx = pts[..., 0:1] - map_pos[:, 0]                        # (T, B, L)
    dy = pts[..., 1:2] - map_pos[:, 1]
    return torch.where(live, dx * dx + dy * dy, float("inf"))


def nearest_landmark_plain(pts, map_pos, nact, lanes: int = 1):
    """pts (T, B, 2) f32; map_pos (L, 2) f32; nact: live count (int or
    0-d tensor); lanes: split the columns as the kernel's variant of that
    many lanes does (the result is the same for every value).  Returns
    (labels (T, B) int32, min_dist (T, B) f32)."""
    best, lab = lane_min(live_d2(pts, map_pos, nact), lanes)
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
    _build.check_pairs_aligned(pts=pts, map_pos=map_pos)
    if pts.shape[0] * pts.shape[1] >= 2 ** 31:
        raise ValueError("too many points for one launch")


def launch(pts, map_pos, nact, plan: LaunchPlan):
    """Launch K2 on checked CUDA tensors with ``plan``; raises when the
    card refuses it.  ``nearest_landmark`` is the caller; the checks on
    the card call this with every variant at one shape."""
    global LAUNCHES
    T, B, _ = pts.shape
    lab = torch.empty((T, B), dtype=torch.int32, device=pts.device)
    dist = torch.empty((T, B), dtype=torch.float32, device=pts.device)
    if T * B == 0:
        return lab, dist
    fn = _build.library().icm_nearest_landmark
    with _build.on_device(pts.device):
        err = fn(pts.data_ptr(), map_pos.data_ptr(), nact.data_ptr(), T * B,
                 map_pos.shape[0], plan.lanes, plan.blocks, plan.threads,
                 plan.shmem, lab.data_ptr(), dist.data_ptr(),
                 _build.current_stream(pts.device))
    _build.check(err, "icm_nearest_landmark")
    LAUNCHES += 1
    LAUNCH_SHAPES[(T, B, map_pos.shape[0])] += 1
    return lab, dist


def nearest_landmark(pts, map_pos, nact):
    """K2 on CUDA tensors, the plain version on CPU tensors (same contract
    as ``nearest_landmark_plain``)."""
    if pts.is_cpu:
        return nearest_landmark_plain(pts, map_pos, nact)
    if not pts.is_cuda:
        raise ValueError(f"nearest_landmark: unsupported device "
                         f"{pts.device}")
    nact = _build.as_count(nact, pts.device)
    _check(pts, map_pos, nact)
    return launch(pts, map_pos, nact,
                  launch_plan(pts.shape[0] * pts.shape[1], map_pos.shape[0]))
