"""graph_hit_share: the mean over the window's requests of the program's
timings["graph_hits"] / 2, the share of a call's two CUDA graphs (the
batched init's chunk and the refine sweep) that it replayed from the
program's cache of captured steps in place of capturing them; None where
no request reports it (a program without that cache)."""
from slambench.harness.readers import mean_timing


def read(ctx):
    return mean_timing(ctx, "graph_hits", 0.5)
