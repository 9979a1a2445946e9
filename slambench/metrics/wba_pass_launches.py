"""wba_pass_launches: the host's kernel launch calls (cudaLaunchKernel,
cuLaunchKernel and their Ex forms) that start inside the program's
icm.wba.pass spans in the traced sub-window, over the number of those
spans: the kernels one eager windowed-BA pass issues one by one; None
where the trace holds no such span."""
import bisect

from slambench.harness.spans import LAUNCH

PASS = "icm.wba.pass"


def read(ctx):
    if ctx.trace is None:
        return None
    passes = sorted((s.start, s.end) for s in ctx.trace.spans
                    if s.name == PASS)
    if not passes:
        return None
    starts = [a for a, _ in passes]
    n = 0
    for e in ctx.trace.host:
        if e.name.startswith(LAUNCH):
            i = bisect.bisect_right(starts, e.start) - 1
            n += i >= 0 and e.start <= passes[i][1]
    return n / len(passes)
