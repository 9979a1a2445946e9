"""eager_launches: the host's kernel launch calls (cudaLaunchKernel,
cuLaunchKernel and their Ex forms) inside the program's calls in the
traced sub-window, per call: the kernels issued one by one outside the
graphs' replays (a launch while a graph records is not counted)."""
from slambench.harness.spans import LAUNCH, host_calls_per_request


def read(ctx):
    return host_calls_per_request(ctx.trace, LAUNCH, prefix=True,
                                  run_only=True)
