"""Bounded landmark table: association, prune/merge, seeding.

Port of ``icm_slam_tpu.mapping.landmark_map``: a fixed (L, 2) table, (L,)
observation counts and a live-count scalar that stays on the device.
JAX's drop-mode scatters (``.at[].set(mode="drop")``) become scatters into
a table with one extra padding row that is sliced off afterwards, since
torch raises on out-of-range indices.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class MapState(NamedTuple):
    pos: torch.Tensor     # (L, 2) landmark positions (dead slots: zeros)
    counts: torch.Tensor  # (L,) observation counts
    nact: torch.Tensor    # () int32 live-landmark count


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


def _relabel_walk(nn, close, n, K):
    """The reference's sequential relabel loop (order-dependent), on the host.

    For each live row i in order with a close neighbour, every row labelled
    like its neighbour nn[i] takes row i's label.  Integer-only, so the
    host walk is bitwise the JAX ``while_loop``.
    """
    lab = np.arange(K, dtype=np.int32)
    for i in np.flatnonzero(close[:n]):
        lab = np.where(lab == lab[nn[i]], lab[i], lab)
    return lab


def filter_map(state: MapState, cota, dist_thr, live_cap: int = 0
               ) -> MapState:
    """Prune landmarks seen < cota times, merge near-duplicates.

    Fixed-shape reproduction of Mapa.filtrar (ICM_SLAM.py:204-265), as
    ``icm_slam_tpu.mapping.landmark_map.filter_map``: stable compaction of
    the kept rows, nearest-neighbour distances with the d == 0 -> max
    sentinel, the sequential relabel loop, label compaction and
    count-weighted merge means.  ``live_cap`` > 0 runs the merge on the
    first K = live_cap compacted rows (exact when the kept count fits).

    The data-dependent relabel loop runs on the host: one device-to-host
    copy of (n, close, nn) per call — the one host sync of a refine sweep.
    """
    L = state.pos.shape[0]
    K = live_cap if 0 < live_cap < L else L
    dev, dtype = state.pos.device, state.pos.dtype
    idx = torch.arange(L, device=dev)
    keep = (idx < state.nact) & (state.counts >= cota)
    rank = torch.cumsum(keep, dim=0) - 1
    tgt = torch.where(keep, torch.clamp(rank, max=K), K)
    pos = torch.zeros((K + 1, 2), dtype=dtype, device=dev)
    pos[tgt] = state.pos
    counts = torch.zeros((K + 1,), dtype=dtype, device=dev)
    counts[tgt] = state.counts
    pos, counts = pos[:K], counts[:K]
    n = keep.sum().to(torch.int32)
    idx_k = torch.arange(K, device=dev)
    live_k = idx_k < n

    diff = pos[:, None, :] - pos[None, :, :]
    d = torch.sqrt((diff * diff).sum(dim=-1))
    pair = live_k[:, None] & live_k[None, :]
    dmax = torch.where(pair, d, float("-inf")).max()
    d = torch.where(d < 1e-9, dmax, d)
    eye = torch.eye(K, dtype=torch.bool, device=dev)
    d = torch.where(eye, dmax, d)
    d = torch.where(pair, d, float("inf"))
    nnd, nn = d.min(dim=1)
    close = live_k & (nnd < dist_thr)

    host = torch.cat([n[None].to(torch.int64), close.to(torch.int64),
                      nn.to(torch.int64)]).cpu().numpy()
    n_h, close_h, nn_h = int(host[0]), host[1:K + 1], host[K + 1:]
    if close_h.any():
        lab = torch.from_numpy(_relabel_walk(nn_h, close_h, n_h, K)).to(dev)
    else:
        lab = idx_k.to(torch.int32)
    lab = compact_labels(lab, live_k, K)
    n_final = torch.where(n > 0, torch.where(live_k, lab, -1).max() + 1,
                          0).to(torch.int32)

    w = torch.where(live_k, counts, 0.0)
    labl = lab.long()
    sums = torch.zeros((K + 1, 2), dtype=dtype, device=dev).index_add_(
        0, labl, pos * w[:, None])[:K]
    cnts = torch.zeros((K + 1,), dtype=dtype, device=dev).index_add_(
        0, labl, w)[:K]
    merged = torch.where((cnts > 0)[:, None],
                         sums / torch.clamp(cnts, min=1.0)[:, None], 0.0)
    if K < L:
        merged = torch.cat([merged, torch.zeros((L - K, 2), dtype=dtype,
                                                device=dev)])
        cnts = torch.cat([cnts, torch.zeros((L - K,), dtype=dtype,
                                            device=dev)])
    return MapState(merged, cnts, n_final)


def seed_from_clusters(L, pts, labels, dtype=torch.float32, device=None
                       ) -> MapState:
    """Build the initial map from first-frame cluster labels (host-side
    hierarchical clustering, ICM_SLAM.py:160-165)."""
    labels = torch.as_tensor(np.asarray(labels), dtype=torch.int64,
                             device=device)
    pts = torch.as_tensor(np.asarray(pts), dtype=dtype, device=device)
    sums = torch.zeros((L, 2), dtype=dtype, device=device).index_add_(
        0, labels, pts)
    cnt = torch.zeros((L,), dtype=dtype, device=device).index_add_(
        0, labels, torch.ones((pts.shape[0],), dtype=dtype, device=device))
    pos = torch.where((cnt > 0)[:, None],
                      sums / torch.clamp(cnt, min=1.0)[:, None], 0.0)
    return MapState(pos, cnt, (labels.max() + 1).to(torch.int32))
