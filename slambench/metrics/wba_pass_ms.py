"""wba_pass_ms: the mean over the window's requests of the program's
timings["wba_pass_s"] x 1000 / timings["wba_passes"], the host ms of one
windowed-BA pass (its windows' LM steps, enqueued: nothing in a pass
waits for the device); None where no request reports them (a program
without the counters, or another sweep mode)."""


def read(ctx):
    vals = [1e3 * r.timings["wba_pass_s"] / r.timings["wba_passes"]
            for r in ctx.requests if r.timings.get("wba_passes")]
    return sum(vals) / len(vals) if vals else None
