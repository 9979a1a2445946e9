"""Lidar scan filtering — masked, fixed-shape, batched over frames.

Port of ``icm_slam_tpu.frontend.scan_filter`` (the reference's filtrar_z):
window-3 median with zero-padded edges, range gate, isolation prune by the
nearest valid neighbour within dist_thr (exact-zero distances and the
diagonal get the 100.0 sentinel), and an all-false mask for frames with
<= 1 valid beam.
"""
from __future__ import annotations

import torch

from icm_slam_tpu_torch.core.geometry import beam_angles

# frames per (T, B, B) distance block: bounds the filter's scratch memory
_FRAME_CHUNK = 256


def median3(r):
    """Window-3 median with zero-padded edges (scipy.signal.medfilt)."""
    z = torch.zeros_like(r[..., :1])
    prev = torch.cat([z, r[..., :-1]], dim=-1)
    nxt = torch.cat([r[..., 1:], z], dim=-1)
    lo = torch.minimum(prev, nxt)
    hi = torch.maximum(prev, nxt)
    return torch.minimum(torch.maximum(r, lo), hi)


def filter_scan(r, ang, max_range, dist_thr):
    """Filter a batch of scans. r: (T, B) ranges, ang: (B,) beam angles.

    Returns (dist (T, B), mask (T, B)); dist is the median-filtered range.
    """
    rm = median3(r)
    valid = rm < max_range
    n_valid = valid.sum(dim=1, keepdim=True)
    pts = rm[..., None] * torch.stack([torch.cos(ang), torch.sin(ang)],
                                      dim=-1)
    diff = pts[:, :, None, :] - pts[:, None, :, :]
    d = torch.sqrt((diff * diff).sum(dim=-1))                # (T, B, B)
    pair_ok = valid[:, :, None] & valid[:, None, :]
    B = r.shape[1]
    eye = torch.eye(B, dtype=torch.bool, device=r.device)
    sentinel = torch.full_like(d, 100.0)
    d = torch.where(d < 1e-9, sentinel, d)
    d = torch.where(eye, sentinel, d)
    d = torch.where(pair_ok, d, torch.full_like(d, float("inf")))
    nearest = d.min(dim=2).values
    mask = valid & (nearest <= dist_thr) & (n_valid > 1)
    return rm, mask


def filter_scans(scans, max_range, dist_thr, n_beams, step_deg=1.0,
                 start_deg=0.0):
    """Batched scan filter over a whole dataset.

    scans: (T, B) preprocessed ranges. Returns (dist (T, B), mask (T, B)).
    """
    ang = beam_angles(n_beams, step_deg, start_deg, dtype=scans.dtype,
                      device=scans.device)
    outs = [filter_scan(scans[i:i + _FRAME_CHUNK], ang, max_range, dist_thr)
            for i in range(0, scans.shape[0], _FRAME_CHUNK)]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


def preprocess_ranges(raw, max_range, radio):
    """NaN -> max range, add tree radius, clip."""
    z = torch.nan_to_num(raw, nan=max_range)
    return torch.clamp(z + radio, max=max_range)
