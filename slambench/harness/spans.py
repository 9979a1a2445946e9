"""What the readers of the program's own spans share.  The program names
its phases with ``torch.profiler.record_function`` ranges on the host
thread (``icm_slam_tpu_torch.utils.profiling.span``): ``icm.run`` or
``icm.run_batched`` around each call, and inside it, among others, a CUDA
graph's capture (``icm.graph.capture``, the recording itself
``icm.graph.record``) and each replay (``icm.graph.replay``).  A trace of
a program without them has no request to read: each reader then gives
None."""
from __future__ import annotations

TOP = ("icm.run", "icm.run_batched")
RECORD = "icm.graph.record"
REPLAY = "icm.graph.replay"
LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel")     # and their Ex forms
ALLOC = ("cudaMalloc", "cudaFree")


def requests(trace) -> list:
    """The program's calls in the traced sub-window (its top spans)."""
    if trace is None:
        return []
    return [s for s in trace.spans if s.name in TOP]


def _inside(t: int, spans) -> bool:
    return any(s.start <= t <= s.end for s in spans)


def host_calls_per_request(trace, names, prefix: bool = False,
                           run_only: bool = False):
    """The host's calls named ``names`` (with ``prefix``, whose names
    start with one of them) that start inside one of the program's calls,
    per call; None without calls.  With ``run_only``, calls that start
    while a CUDA graph records are left out: a kernel launched then is
    recorded into the graph, not run (an allocation then is real: the
    caching allocator fills the graph's private pool)."""
    tops = requests(trace)
    if not tops:
        return None
    recording = [s for s in trace.spans if s.name == RECORD] \
        if run_only else []
    n = sum(1 for e in trace.host
            if (e.name.startswith(names) if prefix else e.name in names)
            and _inside(e.start, tops) and not _inside(e.start, recording))
    return n / len(tops)


def span_ms_per_request(trace, name: str):
    """The host time of the spans ``name`` inside the program's calls, in
    ms, per call; None without calls."""
    tops = requests(trace)
    if not tops:
        return None
    ns = sum(s.end - s.start for s in trace.spans
             if s.name == name and _inside(s.start, tops))
    return 1e-6 * ns / len(tops)
