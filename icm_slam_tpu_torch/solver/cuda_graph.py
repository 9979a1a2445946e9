"""A refine sweep captured once in a CUDA graph and replayed.

The port's counterpart of the JAX package's fused refine loop
(``icm_slam_tpu.solver.icm._refine_loop_jit``, which scans N sweeps as one
device program): in torch eager a batched sweep issues ~8,800 small
kernels from the host, one by one.  ``CapturedSweep`` records one sweep's
kernels into a ``torch.cuda.CUDAGraph`` over static buffers (the map and
the poses, which the graph writes its result back into), and every replay
issues them all at once.  That needs a sweep with no host sync and fixed
shapes: ``filter_map``'s relabel walk runs on the device (K3), and the
batched engine's shapes and launch plans follow from the data's shapes and
the config alone.

The kernels' wrappers count their launches on the host as they issue them
(``ops._build.LAUNCHES``), which a replay does not do: the counts the
capture made are taken back, and each replay adds them again, so a
replayed sweep counts as an eager one does.
"""
from __future__ import annotations

import collections

import torch

from icm_slam_tpu_torch.ops import _build

# graph replays, in all (a replayed sweep is one)
REPLAYS = 0


class CapturedSweep:
    """``sweep(cur_map, x) -> (new_map, new_x, *outs)`` captured on copies
    of ``cur_map`` (a MapState) and ``x``: ``map`` and ``x`` hold the
    state, and each ``replay()`` advances it by one sweep and leaves the
    sweep's other outputs in ``outs`` (the graph's own tensors: copy what
    must outlive the next replay).  The caller runs ``sweep`` once eagerly
    first, so that everything it sets up lazily exists before the capture
    (the kernels' library, the launch plans), and keeps every tensor the
    sweep reads alive and in place for the graph's lifetime.  The capture
    and each replay run with ``x``'s card as the current device, whichever
    is current outside.  A capture the card refuses raises.
    """

    def __init__(self, sweep, cur_map, x):
        self.map = type(cur_map)(*(a.clone() for a in cur_map))
        self.x = x.clone()
        before = collections.Counter(_build.LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        # a capture stream of x's card (torch.cuda.graph's default is made
        # once, on whichever card was current at the process's first
        # capture, and a capture there records nothing of this card's);
        # thread_local: another thread of the process (NCCL's watchdog
        # under a process group) may query the card during the capture
        with torch.cuda.device(x.device), torch.cuda.graph(
                self.graph, stream=torch.cuda.Stream(x.device),
                capture_error_mode="thread_local"):
            new_map, new_x, *self.outs = sweep(self.map, self.x)
            for dst, src in zip(self.map, new_map):
                dst.copy_(src)
            self.x.copy_(new_x)
        self._added = _build.LAUNCHES - before
        _build.LAUNCHES.clear()
        _build.LAUNCHES.update(before)

    def replay(self) -> None:
        global REPLAYS
        with torch.cuda.device(self.x.device):
            self.graph.replay()
        _build.LAUNCHES.update(self._added)
        REPLAYS += 1
