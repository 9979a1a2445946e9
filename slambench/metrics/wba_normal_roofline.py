"""wba_normal_roofline: the windowed-BA window systems' share of their
roofline over the traced solves, in %: the least time of every normal
system and solve the traced requests made, over the device time of the
kernels that formed and solved them, picked out by the names the card's
trace gives them (torch 2.11, CUDA 12.8): cuBLAS's GEMM of J^T J and
GEMV of J^T r, and the batched LU (MAGMA's getf2 panels, row swaps,
triangular solves and trailing GEMMs, with their pointer and pivot
set-up) and its two triangular solves.

The systems come from the program's timings: the traced sub-window
serves the same requests as the window's first R (``drive.Entry``'s
``traced`` and ``window`` both call ``request(i)`` from i = 0), R the
``icm.run`` / ``icm.run_batched`` spans in the trace; of those requests,
``wba_steps`` systems, ``wba_rows`` residual rows and ``wba_cols`` pose
columns summed over them, and ``wba_passes`` x ``wba_steps`` /
``wba_windows`` batched solves (one a pass's LM step).  None without a
trace, without those counters (a program without them, or another sweep
mode), or where the LUs found (one ``magma_iset_pointer`` set-up each)
are not the batched solves counted."""
from slambench.harness.bounds import PEAK_BYTES_PER_S, PEAK_F32_FLOPS
from slambench.harness.spans import TOP

KERNELS = ("gemm", "gemv", "getf2", "laswp", "trsm", "displace_pointers",
           "pivinfo", "ipiv", "iset_pointer", "offsetpointerarray")
LU = "iset_pointer"                 # one a batched LU
FLOAT = 4
KEYS = ("wba_steps", "wba_rows", "wba_cols", "wba_passes", "wba_windows")


def solve_bound_us(systems: int, rows: int, k: int) -> float:
    """The least time of ``systems`` window systems of k columns with
    ``rows`` residual rows among them: a system of m rows costs 2 m k^2
    flops for J^T J, 2 m k for J^T r and (2/3) k^3 + 2 k^2 for the LU
    solve, over the f32 peak, against J and r read once and H and the
    step written once, over the memory rate."""
    flops = rows * (2 * k * k + 2 * k) + systems * (2 * k ** 3 / 3
                                                    + 2 * k * k)
    byts = FLOAT * (rows * k + rows + systems * (k * k + k))
    return 1e6 * max(flops / PEAK_F32_FLOPS, byts / PEAK_BYTES_PER_S)


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    n = sum(s.name in TOP for s in t.spans)
    reqs = [r.timings for r in ctx.requests[:n]]
    if not n or len(reqs) < n or not all(r.get("wba_steps") for r in reqs):
        return None
    k = reqs[0]["wba_cols"] // reqs[0]["wba_steps"]
    if any(r["wba_cols"] != k * r["wba_steps"] for r in reqs):
        return None
    solves = sum(r["wba_passes"] * r["wba_steps"] // r["wba_windows"]
                 for r in reqs)
    runs = [e for e in t.kernels
            if any(f in e.name.lower() for f in KERNELS)]
    if sum(LU in e.name for e in runs) != solves:
        return None
    bound_us = solve_bound_us(sum(r["wba_steps"] for r in reqs),
                              sum(r["wba_rows"] for r in reqs), k)
    device_us = sum(e.end - e.start for e in runs) * 1e-3
    return 100.0 * bound_us / device_us
