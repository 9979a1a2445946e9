"""graph_capture_s: the mean over the window's requests of the program's
timings["init_capture_s"] + timings["capture_s"], the host seconds of its
two CUDA-graph captures a call (the spans icm.graph.capture: torch's
synchronise, collection and empty_cache, the recording, the
instantiation); None where the trace holds none of the program's spans."""
from slambench.harness.spans import requests
from slambench.harness.stats import mean


def read(ctx):
    if not requests(ctx.trace):
        return None
    return mean(r.timings["init_capture_s"] + r.timings["capture_s"]
                for r in ctx.requests
                if "init_capture_s" in r.timings and "capture_s" in r.timings)
