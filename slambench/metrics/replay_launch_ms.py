"""replay_launch_ms: the host time inside the program's icm.graph.replay
spans in the traced sub-window, per call (icm.run or icm.run_batched
span), in ms: the graphs' launches, the first one's upload included."""
from slambench.harness.spans import REPLAY, span_ms_per_request


def read(ctx):
    return span_ms_per_request(ctx.trace, REPLAY)
