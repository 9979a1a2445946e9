"""The map filter's sequential relabel walk (K3): wrapper and plain version.

Port of the relabel ``lax.while_loop`` in
``icm_slam_tpu.mapping.landmark_map.filter_map`` (``relabel_body``).  On a
CUDA tensor ``relabel_walk`` launches the hand-written kernel in
``csrc/relabel_walk.cu`` (or raises); on a CPU tensor it runs
``relabel_walk_plain``, the same contract in plain PyTorch.  Neither reads
anything back to the host, so ``filter_map`` makes no host sync and a
sweep can be captured in a CUDA graph.

Contract, for each world w of nn (W, K) int32, close (W, K) bool and n (W,)
int32: lab starts as 0..K-1; for i = 0 .. n[w]-1 in order, where
close[w, i], every row whose label equals lab[nn[w, i]] takes lab[i], both
read before the update.  Returns lab (W, K) int32.  ``nn`` is clamped to
[0, K) and ``n`` to [0, K], in both versions.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from icm_slam_tpu_torch.ops import _build

# the launches are counted in ``_build.LAUNCHES`` as "relabel_walk", by
# the call's shape (W, K)

_MAX_SHMEM = 227 * 1024     # what one block of the H100 may opt in to


class LaunchPlan(NamedTuple):
    """How one call of K3 is laid out on the card: one block a world."""
    threads: int    # per block
    shmem: int      # bytes of dynamic shared memory per block


@functools.lru_cache(maxsize=64)
def launch_plan(K: int) -> LaunchPlan:
    """A thread a row up to 1024 rows; shared memory for the K labels, the
    K neighbours and a bit a row of the close mask."""
    threads = min(1024, max(32, -(-K // 32) * 32))
    return LaunchPlan(threads, (2 * K + -(-K // 32)) * 4)


def relabel_walk_plain(nn, close, n):
    """The walk as a fixed-bound masked loop over i < K, every world at
    once; a step changes nothing where row i is not close or i >= n."""
    W, K = nn.shape
    dev = nn.device
    nn = torch.clamp(nn, 0, K - 1).long()
    act = close & (torch.arange(K, device=dev) < n.reshape(W, 1))
    lab = torch.arange(K, dtype=torch.int32, device=dev).repeat(W, 1)
    for i in range(K):
        tgt = torch.gather(lab, 1, nn[:, i:i + 1])
        lab = torch.where((lab == tgt) & act[:, i:i + 1], lab[:, i:i + 1],
                          lab)
    return lab


def _check(nn, close, n):
    if nn.dim() != 2 or nn.dtype != torch.int32:
        raise ValueError(f"nn must be (W, K) int32, got {tuple(nn.shape)} "
                         f"{nn.dtype}")
    W, K = nn.shape
    if tuple(close.shape) != (W, K) or close.dtype != torch.bool:
        raise ValueError(f"close must be ({W}, {K}) bool, got "
                         f"{tuple(close.shape)} {close.dtype}")
    if tuple(n.shape) != (W,) or n.dtype != torch.int32:
        raise ValueError(f"n must be ({W},) int32, got {tuple(n.shape)} "
                         f"{n.dtype}")
    for name, a in (("nn", nn), ("close", close), ("n", n)):
        if a.device != nn.device:
            raise ValueError(f"{name} is on {a.device}, nn on {nn.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if launch_plan(K).shmem > _MAX_SHMEM:
        raise ValueError(f"K={K} exceeds the kernel's shared memory")


def relabel_walk(nn, close, n):
    """K3 on CUDA tensors, the plain version on CPU tensors (same
    contract as ``relabel_walk_plain``).  One launch for all W worlds."""
    if nn.is_cpu:
        return relabel_walk_plain(nn, close, n)
    if not nn.is_cuda:
        raise ValueError(f"relabel_walk: unsupported device {nn.device}")
    _check(nn, close, n)
    W, K = nn.shape
    lab = torch.empty((W, K), dtype=torch.int32, device=nn.device)
    if W * K > 0:
        plan = launch_plan(K)
        fn = _build.library().icm_relabel_walk
        with _build.on_device(nn.device):
            err = fn(nn.data_ptr(), close.data_ptr(), n.data_ptr(), W, K,
                     plan.threads, plan.shmem, lab.data_ptr(),
                     _build.current_stream(nn.device))
        _build.check(err, "icm_relabel_walk")
        _build.count_launch("relabel_walk", (W, K))
    return lab
