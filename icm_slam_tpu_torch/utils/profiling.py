"""Profiling helpers: named spans, torch.profiler traces and phase timers
that wait for the device.

``span`` is the one timing primitive of the port: the solver's phases
(``solver.icm``, ``solver.sweeps``, ``solver.cuda_graph``) and
``PhaseTimer`` open it.  Under a running torch profiler it is a
``record_function`` range, on the clock of the device's kernels, copies
and sets in the same trace, and its nesting on the host thread is the
phases' call tree; otherwise it costs one check of the profiler's flag.
Given a ``timings`` dict it also stores its host seconds there.

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
from torch.autograd import _profiler_enabled
from torch.profiler import record_function
from torch.utils._pytree import tree_leaves


class span:
    """``with span(name, timings, key):`` names the block ``name`` in a
    running torch profiler's trace (a ``record_function`` range; nothing
    of the profiler is touched when none runs) and, with ``timings``,
    stores the block's host seconds in ``timings[key]``.  The block's
    device work is not waited for: a phase that is to be timed to its
    end synchronises inside the block."""

    __slots__ = ("name", "timings", "key", "_rf", "_t0")

    def __init__(self, name: str, timings: dict = None, key: str = None):
        self.name, self.timings, self.key = name, timings, key

    def __enter__(self):
        self._rf = None
        if _profiler_enabled():
            self._rf = record_function(self.name)
            self._rf.__enter__()
        if self.timings is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.timings is not None:
            self.timings[self.key] = time.perf_counter() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


@contextlib.contextmanager
def device_trace(logdir: str, device="cuda"):
    """Record a torch.profiler trace of the block into ``logdir`` (one
    ``*.pt.trace.json`` Chrome trace, written when the block ends): host
    operators, and the kernels of ``device`` when it is a CUDA device.  A
    CUDA device without CUDA raises; the trace never falls back to the
    host alone."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    from icm_slam_tpu_torch.solver.icm import resolve_device
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
        """Time the block, a ``span`` of ``name``; with ``block_on``, wait
        for the device to finish the tensors it holds first.  Its leaves
        are read when the block ends, so a list or dict that the block
        fills works."""
        t = {}
        with span(name, t, name):
            yield
            if block_on is not None:
                _synchronize(block_on)
        self.totals[name] = self.totals.get(name, 0.0) + t[name]
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, dict]:
        return {k: {"total_s": round(v, 4),
                    "mean_ms": round(v / max(self.counts[k], 1) * 1e3, 3),
                    "count": self.counts[k]}
                for k, v in sorted(self.totals.items())}
