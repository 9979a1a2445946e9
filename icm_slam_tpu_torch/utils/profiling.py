"""Profiling helpers: torch.profiler traces and phase timers that wait for
the device.

Port of ``icm_slam_tpu.utils.profiling``: ``device_trace`` records what
``jax.profiler.start_trace`` / ``stop_trace`` record there, the host's
operators and the device's kernels, into a directory that TensorBoard and
Perfetto read; ``PhaseTimer`` blocks on the tensors a phase made before it
reads the clock, as ``jax.block_until_ready`` does.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch
from torch.utils._pytree import tree_leaves

from icm_slam_tpu_torch.solver.icm import resolve_device


@contextlib.contextmanager
def device_trace(logdir: str, device="cuda"):
    """Record a torch.profiler trace of the block into ``logdir`` (one
    ``*.pt.trace.json`` Chrome trace, written when the block ends): host
    operators, and the kernels of ``device`` when it is a CUDA device.  A
    CUDA device without CUDA raises; the trace never falls back to the
    host alone."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def _synchronize(tree) -> None:
    """Wait for every CUDA tensor in ``tree`` (a tensor or any nesting of
    tuples, lists, dicts and NamedTuples holding tensors): one
    ``torch.cuda.synchronize`` per distinct device.  CPU tensors are done
    when they are returned."""
    devices = {t.device for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


class PhaseTimer:
    """Accumulating wall-clock phase timers (blocks on device results)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        """Time the block; with ``block_on``, wait for the device to finish
        the tensors it holds first.  Its leaves are read when the block
        ends, so a list or dict that the block fills works."""
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            _synchronize(block_on)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, dict]:
        return {k: {"total_s": round(v, 4),
                    "mean_ms": round(v / max(self.counts[k], 1) * 1e3, 3),
                    "count": self.counts[k]}
                for k, v in sorted(self.totals.items())}
