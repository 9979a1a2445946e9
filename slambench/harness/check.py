"""Whether what the window's timed path produced is correct, once the
window has closed: for a sample of the served worlds, drawn from the
run's seed (``Entry.held``), the reference runs the world whole, and every
distinct answer the window gave for those worlds (an answer that repeats
bitwise is held once) is held to that run, number by number
(``Entry.numbers``, ``reference/compare.py``), with the parameters the
entry took from its reference at set-up (``Entry.params``).  Each
number's worst reading is held to the cell's limit."""
from __future__ import annotations

import hashlib


def _digest(answer) -> str:
    h = hashlib.sha256()
    for a in answer:
        h.update(a.tobytes())
    return h.hexdigest()


def judge(gen, requests, limits: dict, seed: int):
    """Returns (correct, the worst reading of each number of the cell's
    limits, the number of distinct answers held, the number of requests
    with an answer out of its limits)."""
    params = gen.params
    lim = limits["limits"]
    whole = gen.held(seed, [k for r in requests for k in r.worlds],
                     int(limits["check_worlds"]))
    runs = {k: gen.reference(k, params) for k in whole}
    worst = {n: 0.0 for n in lim}
    verdict = {}
    for r in requests:
        for k, ans in zip(r.worlds, r.answers):
            key = (k, _digest(ans))
            if k not in runs or key in verdict:
                continue
            got = gen.numbers(k, ans, runs[k], params)
            for n in lim:
                worst[n] = max(worst[n], got[n])
            verdict[key] = all(got[n] <= lim[n] for n in lim)
    failed = sum(not all(verdict.get((k, _digest(a)), True)
                         for k, a in zip(r.worlds, r.answers))
                 for r in requests)
    correct = bool(verdict) and all(worst[n] <= lim[n] for n in lim)
    return correct, worst, len(verdict), failed
