"""alloc_calls: the host's cudaMalloc and cudaFree calls inside the
program's calls in the traced sub-window, per call: the CUDA caching
allocator asking CUDA for memory or handing it back (a capture's
empty_cache frees what the allocator held, and the blocks are then
allocated again), those made while a CUDA graph records its private
pool's included."""
from slambench.harness.spans import ALLOC, host_calls_per_request


def read(ctx):
    return host_calls_per_request(ctx.trace, ALLOC)
