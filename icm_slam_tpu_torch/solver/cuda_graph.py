"""A step of the main path captured once in a CUDA graph and replayed.

The port's counterpart of the JAX package's compiled loops: the fused
refine loop (``icm_slam_tpu.solver.icm._refine_loop_jit``, which scans N
sweeps as one device program) and the compiled init (``_init_jit``, whose
batched init scans its chunks).  In torch eager a batched sweep or an init
chunk issues hundreds to thousands of small kernels from the host, one by
one.  ``CapturedStep`` records one step's kernels into a
``torch.cuda.CUDAGraph`` over static buffers (the state the step carries,
which the graph writes its result back into), and every replay issues them
all at once.  That needs a step with no host sync and fixed shapes:
``filter_map``'s relabel walk runs on the device (K3), the pose solves are
K4, and the engines' shapes and launch plans follow from the data's shapes
and the config alone.

The kernels' wrappers count their launches on the host as they issue them
(``ops._build.LAUNCHES``), which a replay does not do: the counts the
capture made are taken back, and each replay adds them again, so a
replayed step counts as an eager one does.

The recording inside a capture is the span ``icm.graph.record``
(``utils.profiling.span``) and each replay a span ``icm.graph.replay``,
the first one's upload of the graph included; the solver opens
``icm.graph.capture`` around the whole capture (torch's synchronise,
collection and ``empty_cache`` before the recording, the graph's
instantiation after it).
"""
from __future__ import annotations

import collections

import torch

from icm_slam_tpu_torch.ops import _build
from icm_slam_tpu_torch.utils.profiling import span

# graph replays, in all (a replayed sweep or init chunk is one)
REPLAYS = 0


def _clone(s):
    """A copy of a state item: a tensor, or a NamedTuple of tensors."""
    if isinstance(s, tuple):
        return type(s)(*(a.clone() for a in s))
    return s.clone()


def _copy(dst, src) -> None:
    if isinstance(dst, tuple):
        for d, v in zip(dst, src):
            d.copy_(v)
    else:
        dst.copy_(src)


def _device(s) -> torch.device:
    return (s[0] if isinstance(s, tuple) else s).device


class CapturedStep:
    """``step(*state) -> (*new_state, *outs)`` captured on copies of
    ``state`` (each item a tensor or a NamedTuple of tensors, such as a
    MapState): ``self.state`` holds the state, and each ``replay()``
    advances it by one step and leaves the step's other outputs in
    ``outs`` (the graph's own tensors: copy what must outlive the next
    replay).  The caller runs ``step`` once eagerly first, so that
    everything it sets up lazily exists before the capture (the kernels'
    library, the launch plans), and keeps every tensor the step reads or
    writes outside its state alive and in place for the graph's lifetime.
    The capture and each replay run with the state's card as the current
    device, whichever is current outside.  A capture the card refuses
    raises.
    """

    def __init__(self, step, *state):
        self.state = tuple(_clone(s) for s in state)
        self.device = _device(self.state[0])
        before = collections.Counter(_build.LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        # a capture stream of the state's card (torch.cuda.graph's default
        # is made once, on whichever card was current at the process's
        # first capture, and a capture there records nothing of this
        # card's); thread_local: another thread of the process (NCCL's
        # watchdog under a process group) may query the card during the
        # capture
        with torch.cuda.device(self.device), torch.cuda.graph(
                self.graph, stream=torch.cuda.Stream(self.device),
                capture_error_mode="thread_local"), span("icm.graph.record"):
            out = step(*self.state)
            n = len(self.state)
            for dst, src in zip(self.state, out[:n]):
                _copy(dst, src)
            self.outs = tuple(out[n:])
        self._added = _build.LAUNCHES - before
        _build.LAUNCHES.clear()
        _build.LAUNCHES.update(before)

    def replay(self) -> None:
        global REPLAYS
        with span("icm.graph.replay"), torch.cuda.device(self.device):
            self.graph.replay()
        _build.LAUNCHES.update(self._added)
        REPLAYS += 1
