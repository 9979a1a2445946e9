"""wba_accept_share: the windows' LM steps that the accept test took, over
all the steps the windowed-BA passes made, summed over the window's
requests (the program's timings["wba_accepted"] / ["wba_steps"]); None
where no request reports them."""


def read(ctx):
    reqs = [r.timings for r in ctx.requests if r.timings.get("wba_steps")]
    if not reqs:
        return None
    return (sum(t["wba_accepted"] for t in reqs)
            / sum(t["wba_steps"] for t in reqs))
