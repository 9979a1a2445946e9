"""Bounded landmark table: association, prune/merge, seeding.

Port of ``icm_slam_tpu.mapping.landmark_map``: a fixed (L, 2) table, (L,)
observation counts and a live-count scalar that stays on the device.
JAX's drop-mode scatters (``.at[].set(mode="drop")``) become scatters into
a table with one extra padding row that is sliced off afterwards, since
torch raises on out-of-range indices.  JAX's ``segment_sum`` becomes
``add_rows``, which adds in a fixed order on the card too.  A fleet's
maps are one MapState with a leading world axis W ((W, L, 2), (W, L),
(W,)); ``filter_map`` takes both forms.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from icm_slam_tpu_torch.ops.assoc import nearest_landmark
from icm_slam_tpu_torch.ops.relabel import relabel_walk


class MapState(NamedTuple):
    pos: torch.Tensor     # (L, 2) landmark positions (dead slots: zeros)
    counts: torch.Tensor  # (L,) observation counts
    nact: torch.Tensor    # () int32 live-landmark count
    # a fleet's maps: the same with a leading world axis W


def add_rows(out, idx, vals):
    """``out[idx[i]] += vals[i]`` for every i, in place; returns ``out``.

    Rows that share an index are summed in the order of i on every device,
    so a run repeats bitwise and a fleet's world is bitwise the same world
    alone.  On the card that is ``index_put_`` with ``accumulate``, which
    sorts the indices (stably) and adds each row's values in turn;
    ``index_add_`` there adds by float atomics in no fixed order.  On the
    CPU it is ``index_add_``, which adds in turn; ``index_put_`` there
    adds large float inputs by atomics across threads.
    """
    if out.is_cuda:
        return out.index_put_((idx,), vals, accumulate=True)
    return out.index_add_(0, idx, vals)


def empty_map(L, dtype=torch.float32, device=None) -> MapState:
    return MapState(torch.zeros((L, 2), dtype=dtype, device=device),
                    torch.zeros((L,), dtype=dtype, device=device),
                    torch.zeros((), dtype=torch.int32, device=device))


def compact_labels(lab, valid, B):
    """Renumber labels to 0..k-1 preserving order by value.

    lab: (..., n) int labels in [0, B]; valid: same shape. Invalid -> B.
    """
    idx = torch.where(valid, lab, B).long()
    used = torch.zeros(lab.shape[:-1] + (B + 1,), dtype=torch.int32,
                       device=lab.device)
    used.scatter_(-1, idx, 1)
    used[..., B].fill_(0)      # fill_, not `= 0`: no host-to-device copy
    newidx = torch.cumsum(used, dim=-1, dtype=torch.int32) - 1
    return torch.where(valid, torch.gather(newidx, -1, lab.long()),
                       torch.full_like(lab, B)).to(torch.int32)


def associate(ref_pos, ref_live, pts, mask, dist_thr):
    """Nearest-landmark association (ICM_SLAM.py:168-172).

    ref_pos: (L, 2); ref_live: (L,) bool; pts: (..., B, 2); mask: (..., B).
    Returns (labels in [0, L), -1 for far or L for masked-out; min_dist).
    JAX's contract, which the tests hold ``update``'s association to.
    """
    diff = pts[..., :, None, :] - ref_pos
    d = torch.sqrt((diff * diff).sum(dim=-1))                 # (..., B, L)
    d = torch.where(ref_live, d, torch.full_like(d, float("inf")))
    min_dist, labels = d.min(dim=-1)
    labels = labels.to(torch.int32)
    L = ref_pos.shape[0]
    labels = torch.where(min_dist > dist_thr, -1, labels)
    labels = torch.where(mask, labels, L)
    return labels, min_dist


def connected_component_labels(pts, mask, dist_thr):
    """Threshold-graph connected components over masked points.

    pts: (..., B, 2); mask: (..., B).  Each component is labelled by its
    smallest member index, masked-out points by B.  A fixed
    ceil(log2 B) + 1 rounds of min-label propagation, as the JAX package
    runs (not iterated to convergence: long chains keep the labels JAX
    gives them).
    """
    B = pts.shape[-2]
    diff = pts[..., :, None, :] - pts[..., None, :, :]
    d = torch.sqrt((diff * diff).sum(dim=-1))                 # (..., B, B)
    adj = (d <= dist_thr) & mask[..., :, None] & mask[..., None, :]
    eye = torch.eye(B, dtype=torch.bool, device=pts.device)
    adj = adj | (eye & mask[..., :, None])
    idx = torch.arange(B, dtype=torch.int32, device=pts.device)
    lab = torch.where(mask, idx, B)
    n_rounds = max(1, math.ceil(math.log2(B)) + 1) if B > 1 else 1
    for _ in range(n_rounds):
        neigh = torch.where(adj, lab[..., None, :], B)
        lab = torch.minimum(lab, neigh.min(dim=-1).values)
    return lab


def allocate_new_labels(labels, pts, mask, nact, dist_thr, quirk=True):
    """Assign labels >= nact to the far observations (labels == -1) of one
    frame.  quirk: all of them share one new label (ICM_SLAM.py:176);
    otherwise connected components at dist_thr, labelled nact, nact+1, ...
    Returns (labels, n_new); labels may reach past the table (>= L).

    labels (..., B), pts (..., B, 2), mask (..., B), nact (...): a fleet's
    frame has a leading world axis W, and each world takes its own far
    points, live count and ``n_new`` (W,)."""
    far = labels == -1
    has_far = far.any(dim=-1)
    if quirk:
        return (torch.where(far, nact[..., None], labels),
                has_far.to(torch.int32))
    B = pts.shape[-2]
    comp = connected_component_labels(pts, far & mask, dist_thr)
    comp = compact_labels(comp, far & mask, B)
    labels = torch.where(far, nact[..., None] + comp, labels)
    n_new = torch.where(has_far, torch.where(far, comp, -1).amax(dim=-1) + 1,
                        0)
    return labels, n_new.to(torch.int32)


def scatter_update(state: MapState, pts, labels, n_new) -> MapState:
    """Fold one frame's observations into the table by incremental
    weighted mean (ICM_SLAM.py:184-194).  Labels >= L go to a discard row
    that is sliced off.  A fleet (a leading world axis W on every input)
    sums into one flat table, each world's rows L + 1 apart."""
    L = state.pos.shape[-2]
    lead = state.pos.shape[:-2]
    dtype, dev = state.pos.dtype, state.pos.device
    n = state.counts[..., 0].numel()
    idx = torch.clamp(labels, max=L).long()
    if lead:
        idx = idx + torch.arange(0, n * (L + 1), L + 1, device=dev)[:, None]
    w = (labels < L).to(dtype)
    sums = add_rows(torch.zeros((n * (L + 1), 2), dtype=dtype, device=dev),
                    idx.reshape(-1), (pts * w[..., None]).reshape(-1, 2))
    cnt = add_rows(torch.zeros((n * (L + 1),), dtype=dtype, device=dev),
                   idx.reshape(-1), w.reshape(-1))
    sums = sums.view(lead + (L + 1, 2))[..., :L, :]
    cnt = cnt.view(lead + (L + 1,))[..., :L]
    tot = state.counts + cnt
    new_pos = torch.where((cnt > 0)[..., None],
                          (sums + state.pos * state.counts[..., None])
                          / torch.clamp(tot, min=1.0)[..., None],
                          state.pos)
    return MapState(new_pos, tot, state.nact + n_new)


def update(state: MapState, ref_pos, ref_nact, pts, mask, dist_thr,
           quirk=True):
    """Associate one frame against the frozen (ref_pos, ref_nact) and fold
    it into ``state`` (Mapa.actualizar, ICM_SLAM.py:128-201).

    pts: (B, 2); mask: (B,).  Returns (new_state, labels).  The
    association is the nearest-landmark kernel (K2; its plain version on
    the CPU) over the live prefix ``arange(L) < ref_nact`` with the sqrt
    key, the argmin of sqrt(d^2) that ``associate`` takes (on a tie of
    sqrt(d^2) the first column wins), gated on the distance it returns.
    A fleet's frame (pts (W, B, 2), mask (W, B), the state, ref_pos (W, L,
    2) and ref_nact (W,) with the world axis) is one launch of K2 at (W,
    1, B, L), each world against its own table.
    """
    L = ref_pos.shape[-2]
    lab, dist = nearest_landmark(pts[..., None, :, :], ref_pos, ref_nact,
                                 sqrt_key=True)
    labels = torch.where(dist[..., 0, :] > dist_thr, -1, lab[..., 0, :])
    labels = torch.where(mask, labels, L)
    labels, n_new = allocate_new_labels(labels, pts, mask, state.nact,
                                        dist_thr, quirk)
    return scatter_update(state, pts, labels, n_new), labels


def filter_map(state: MapState, cota, dist_thr, live_cap: int = 0
               ) -> MapState:
    """Prune landmarks seen < cota times, merge near-duplicates.

    Fixed-shape reproduction of Mapa.filtrar (ICM_SLAM.py:204-265), as
    ``icm_slam_tpu.mapping.landmark_map.filter_map``: stable compaction of
    the kept rows, nearest-neighbour distances with the d == 0 -> max
    sentinel, the sequential relabel loop, label compaction and
    count-weighted merge means.  ``live_cap`` > 0 runs the merge on the
    first K = live_cap compacted rows (exact when the kept count fits).

    ``state`` is one map or a fleet's W maps (a leading world axis); each
    world is filtered on its own, and its slice of a fleet's result is
    bitwise the result of filtering it alone.  The order-dependent
    relabel walk is ``ops.relabel.relabel_walk`` (K3 on the card, its
    plain version on the CPU), one launch for all worlds: nothing is read
    back to the host, so the filter makes no host sync.
    """
    if state.pos.dim() == 2:
        out = filter_map(MapState(*(a[None] for a in state)), cota,
                         dist_thr, live_cap)
        return MapState(*(a[0] for a in out))
    W, L = state.counts.shape
    K = live_cap if 0 < live_cap < L else L
    dev, dtype = state.pos.device, state.pos.dtype
    idx = torch.arange(L, device=dev)
    keep = (idx < state.nact[:, None]) & (state.counts >= cota)   # (W, L)
    rank = torch.cumsum(keep, dim=1) - 1
    # each world's rows K + 1 apart in one flat table: one index a row
    wid = torch.arange(W, device=dev)[:, None] * (K + 1)
    tgt = (torch.where(keep, torch.clamp(rank, max=K), K) + wid).reshape(-1)
    pos = torch.zeros((W * (K + 1), 2), dtype=dtype, device=dev)
    pos[tgt] = state.pos.reshape(-1, 2)
    counts = torch.zeros((W * (K + 1),), dtype=dtype, device=dev)
    counts[tgt] = state.counts.reshape(-1)
    pos = pos.view(W, K + 1, 2)[:, :K]
    counts = counts.view(W, K + 1)[:, :K]
    n = keep.sum(dim=1).to(torch.int32)                       # (W,)
    idx_k = torch.arange(K, device=dev)
    live_k = idx_k < n[:, None]                               # (W, K)

    diff = pos[:, :, None, :] - pos[:, None, :, :]
    d = torch.sqrt((diff * diff).sum(dim=-1))                 # (W, K, K)
    pair = live_k[:, :, None] & live_k[:, None, :]
    dmax = torch.where(pair, d, float("-inf")).amax(dim=(1, 2))
    dmax = dmax[:, None, None]
    d = torch.where(d < 1e-9, dmax, d)
    eye = torch.eye(K, dtype=torch.bool, device=dev)
    d = torch.where(eye, dmax, d)
    d = torch.where(pair, d, float("inf"))
    nnd, nn = d.min(dim=2)
    close = live_k & (nnd < dist_thr)

    lab = compact_labels(relabel_walk(nn.to(torch.int32), close, n),
                         live_k, K)
    n_final = torch.where(n > 0, torch.where(live_k, lab, -1).amax(dim=1)
                          + 1, 0).to(torch.int32)

    w = torch.where(live_k, counts, 0.0)
    flat = (lab.long() + wid).reshape(-1)
    sums = add_rows(torch.zeros((W * (K + 1), 2), dtype=dtype, device=dev),
                    flat, (pos * w[..., None]).reshape(-1, 2)).view(
                        W, K + 1, 2)
    cnts = add_rows(torch.zeros((W * (K + 1),), dtype=dtype, device=dev),
                    flat, w.reshape(-1)).view(W, K + 1)
    sums, cnts = sums[:, :K], cnts[:, :K]
    merged = torch.where((cnts > 0)[..., None],
                         sums / torch.clamp(cnts, min=1.0)[..., None], 0.0)
    if K < L:
        merged = torch.cat([merged, torch.zeros((W, L - K, 2), dtype=dtype,
                                                device=dev)], dim=1)
        cnts = torch.cat([cnts, torch.zeros((W, L - K), dtype=dtype,
                                            device=dev)], dim=1)
    return MapState(merged, cnts, n_final)


def seed_from_clusters(L, pts, labels, dtype=torch.float32, device=None
                       ) -> MapState:
    """Build the initial map from first-frame cluster labels (host-side
    hierarchical clustering, ICM_SLAM.py:160-165)."""
    labels = torch.as_tensor(np.asarray(labels), dtype=torch.int64,
                             device=device)
    pts = torch.as_tensor(np.asarray(pts), dtype=dtype, device=device)
    sums = add_rows(torch.zeros((L, 2), dtype=dtype, device=device), labels,
                    pts)
    cnt = add_rows(torch.zeros((L,), dtype=dtype, device=device), labels,
                   torch.ones((pts.shape[0],), dtype=dtype, device=device))
    pos = torch.where((cnt > 0)[:, None],
                      sums / torch.clamp(cnt, min=1.0)[:, None], 0.0)
    return MapState(pos, cnt, (labels.max() + 1).to(torch.int32))
