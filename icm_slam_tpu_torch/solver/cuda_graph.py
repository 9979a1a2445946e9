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

So a graph is kept across calls: ``GRAPHS`` holds each captured step as a
``CachedStep`` under its ``graph_key`` (the call site and its flags, the
resolved config, and the shape, dtype and device of everything the step
reads; never a value of the data).  The entry owns the inputs its step
reads besides its state.  The call that misses copies its inputs into
them, runs the first step eagerly over them and captures the next; a
later call with the same key copies its inputs and initial state into the
entry's buffers (the span ``icm.graph.load``) and replays every step: no
capture (torch's synchronise, ``gc.collect`` and ``empty_cache``), no
eager first step.  Eager and replayed steps are bitwise equal, so a call
that hits returns what a call that misses returns.  A call takes its
entry out of the cache while it uses it (``GraphCache.take``), so a
nested or concurrent call with the same key misses and captures its own,
and gives it back (``give``) only once nothing it returns aliases the
entry's buffers.  A call that stops early never gives its entry back:
the next call with that key captures anew.

The bound: the cache keeps at most ``MAX_ENTRIES`` = 16 entries, both
graphs (the init's and the sweeps') of eight keys, so that a process that
maps the runs of a few robots, lidars or run lengths in turn captures each
graph once; and on each card at most a ``MEMORY_SHARE`` = 8th of the
card's memory (``total_memory``), each entry weighed by its buffers and
its graph's private pool (``torch.cuda.memory_reserved`` before and after
the recording), so that kept graphs cannot starve a larger request.  Past
either, the least recently used entry goes, its graph and pool with it
(the entry just given back always stays).

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
import threading

import torch

from icm_slam_tpu_torch.ops import _build
from icm_slam_tpu_torch.utils.profiling import span

# graph replays, in all (a replayed sweep or init chunk is one)
REPLAYS = 0
# graphs captured, in all
CAPTURES = 0
# steps taken from GRAPHS in place of a capture, in all
CACHE_HITS = 0

MAX_ENTRIES = 16
MEMORY_SHARE = 8


def captures(device) -> bool:
    """Whether the solver captures and replays its steps on ``device``:
    on a CUDA card."""
    return torch.device(device).type == "cuda"


def _leaves(s):
    """The items of a state or of inputs: tensors and Python numbers,
    nested in tuples and NamedTuples (a MapState, the weights)."""
    if isinstance(s, tuple):
        for a in s:
            yield from _leaves(a)
    else:
        yield s


def _clone(s):
    """A copy of ``s``'s tensors in its structure (numbers stay)."""
    if isinstance(s, torch.Tensor):
        return s.clone()
    if isinstance(s, tuple):
        items = [_clone(a) for a in s]
        return type(s)(*items) if hasattr(s, "_fields") else tuple(items)
    return s


def _copy(dst, src) -> None:
    for d, v in zip(_leaves(dst), _leaves(src)):
        if isinstance(d, torch.Tensor):
            d.copy_(v)


def _nbytes(s) -> int:
    return sum(a.numel() * a.element_size() for a in _leaves(s)
               if isinstance(a, torch.Tensor))


def _device(s) -> torch.device:
    return next(a for a in _leaves(s) if isinstance(a, torch.Tensor)).device


def graph_key(site: str, config, *inputs, **flags) -> tuple:
    """What the graph of a step is a function of: the call site
    (``site``) and its ``flags``, the resolved ``config`` (a frozen
    dataclass; graphs run only without a model), and of everything the
    step reads (``inputs``: its inputs and its state) each tensor's shape,
    dtype and device and each Python number, which the graph bakes in.
    Never a tensor's values."""
    return (site, config, tuple(sorted(flags.items())),
            tuple((tuple(a.shape), a.dtype, a.device)
                  if isinstance(a, torch.Tensor) else a
                  for a in _leaves(inputs)))


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
    raises.  ``pool_bytes``: what the card reserved while the step was
    recorded (the graph's private pool).
    """

    def __init__(self, step, *state):
        global CAPTURES
        self.state = tuple(_clone(s) for s in state)
        self.device = _device(self.state)
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
            reserved = torch.cuda.memory_reserved(self.device)
            out = step(*self.state)
            n = len(self.state)
            for dst, src in zip(self.state, out[:n]):
                _copy(dst, src)
            self.outs = tuple(out[n:])
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self._added = _build.LAUNCHES - before
        _build.LAUNCHES.clear()
        _build.LAUNCHES.update(before)
        CAPTURES += 1

    def replay(self) -> None:
        global REPLAYS
        with span("icm.graph.replay"), torch.cuda.device(self.device):
            self.graph.replay()
        _build.LAUNCHES.update(self._added)
        REPLAYS += 1


class CachedStep:
    """An entry of ``GRAPHS``: ``inputs``, the entry's own copies of what
    a step reads besides its state (a tensor, or tuples of tensors and
    numbers), and ``graph``, the step captured over them (a
    ``CapturedStep``; None until ``capture``)."""

    def __init__(self, inputs):
        self.inputs = _clone(inputs)
        self.graph = None

    def capture(self, step, *state) -> None:
        """``step`` (which reads ``self.inputs``) captured from ``state``."""
        self.graph = CapturedStep(step, *state)

    def load(self, inputs, *state) -> None:
        """A later call's ``inputs`` and initial ``state`` into the
        entry's buffers, which the graph replays from."""
        with span("icm.graph.load"):
            _copy(self.inputs, inputs)
            _copy(self.graph.state, state)

    def nbytes(self) -> int:
        """The card's memory the entry keeps: its buffers and the
        graph's pool."""
        return (_nbytes(self.inputs) + _nbytes(self.graph.state)
                + self.graph.pool_bytes)


def _budget(device: torch.device) -> float:
    """The bytes the cache's entries may keep on ``device``."""
    if device.type != "cuda":
        return float("inf")
    return torch.cuda.get_device_properties(device).total_memory / MEMORY_SHARE


class GraphCache:
    """Captured steps (``CachedStep``) by ``graph_key``, the least
    recently used evicted past the bound of the module's docstring."""

    def __init__(self):
        self._entries = collections.OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self) -> list:
        """The keys held, the least recently used first."""
        with self._lock:
            return list(self._entries)

    def take(self, key, timings=None):
        """The entry of ``key``, out of the cache until it is given back;
        None on a miss.  A hit counts in ``CACHE_HITS`` and in
        ``timings["graph_hits"]`` when given."""
        global CACHE_HITS
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is not None:
                CACHE_HITS += 1
        if entry is not None and timings is not None:
            timings["graph_hits"] = timings.get("graph_hits", 0) + 1
        return entry

    def give(self, key, entry: CachedStep) -> None:
        """``entry`` (captured) back under ``key`` as the most recently
        used, in place of any entry a nested call gave back meanwhile;
        then the bound."""
        with self._lock:
            self._entries.pop(key, None)
            self._entries[key] = entry
            while (victim := self._victim()) is not None:
                del self._entries[victim]

    def _victim(self):
        keys = list(self._entries)
        if len(keys) > MAX_ENTRIES:
            return keys[0]
        held = collections.Counter()
        for e in self._entries.values():
            held[e.graph.device] += e.nbytes()
        for k in keys[:-1]:
            d = self._entries[k].graph.device
            if held[d] > _budget(d):
                return k
        return None

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


GRAPHS = GraphCache()
