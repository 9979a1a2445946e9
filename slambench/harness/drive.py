"""The traffic generator.  A mix is a file of parameters
(``traffic/<mix>.json``); its ``"entry"`` names a file
``entries/<entry>.py`` whose ``Entry`` (a subclass of ``Entry`` here)
serves one request through the program, and, where the mix needs another
shape of load, brings its own request loop.  What every entry shares lives
here: the worlds from the run's seed, the solver's configuration, the
spans, the closed loop of one client, the traced sub-window, and what the
correctness check asks of an entry (the reference the configuration names
and its parameters, which worlds it holds, the reference's run of a world,
the numbers compared).

A mix's common parameters: ``entry``; ``trace``, the traced sub-window of
a ``--trace 1`` run (``{"requests": n}``); the rest are the entry's own
(its docstring lists them).  The worlds come from the run's seed
(``worlds.make_worlds``, by the configuration's generator); the program
gets only them.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Optional

from slambench.harness.worlds import make_worlds
from slambench.reference import compare


@dataclasses.dataclass
class Request:
    worlds: list            # the index of each answer's world
    answers: list           # (x_init, x, map_pos, map_counts) a world
    start: float
    end: float
    frames: int
    timings: dict
    chunk_s: list = dataclasses.field(default_factory=list)
    finish_s: Optional[float] = None


def answer(res):
    return (res.x_init, res.x, res.map_pos, res.map_counts)


def sample(seed: int, served, k: int) -> list:
    """``k`` of the world indices ``served``, drawn from the run's seed,
    one from each of ``k`` runs of neighbouring indices: a fault confined
    to a contiguous part of a fleet (its first or its second half) lies
    under the sample on every seed."""
    served = sorted(set(served))
    k = min(k, len(served))
    rng = random.Random(seed)
    cuts = [len(served) * i // k for i in range(k + 1)]
    return [rng.choice(served[a:b]) for a, b in zip(cuts, cuts[1:])]


class Entry:
    """One program entry point under a closed loop of one client: each
    request starts as the last one returns.  A subclass gives
    ``n_worlds`` and ``request`` and, where they differ from these,
    ``warm``, ``traced``, ``window`` and the check's hooks.

    ``self.ref`` is the reference module that the configuration's
    ``"reference"`` names (``icm`` where it names none), and
    ``self.params`` its ``Params`` of the configuration's solver: a
    configuration that the reference does not implement is refused here,
    before any world is made or served."""

    def __init__(self, traffic: dict, config: dict, seed: int, device,
                 registry):
        import torch
        from icm_slam_tpu_torch.config import ICMConfig
        from icm_slam_tpu_torch.data.datasets import Dataset
        self.torch = torch
        self.traffic, self.device = traffic, device
        self.solver_spec = config["solver"]
        self.ref = registry.reference(config.get("reference", "icm"))
        self.params = self.ref.Params.from_solver(self.solver_spec)
        self.solver = ICMConfig(**{
            k: (tuple(v) if isinstance(v, list) else v)
            for k, v in self.solver_spec.items()})
        self.worlds = make_worlds(config["world"], seed,
                                  self.n_worlds(traffic, config),
                                  registry.world_generator)
        self.datasets = [Dataset(w.scans, w.odom, w.u, w.x0)
                         for w in self.worlds]

    def n_worlds(self, traffic: dict, config: dict) -> int:
        raise NotImplementedError

    def request(self, i: int) -> Request:
        """The window's ``i``-th request, served to its end."""
        raise NotImplementedError

    def span(self, name):
        return self.torch.profiler.record_function(name)

    def sync(self):
        if self.torch.device(self.device).type == "cuda":
            self.torch.cuda.synchronize()

    def warm(self) -> None:
        """Every shape the mix uses, once: a request on each world."""
        for k in range(len(self.worlds)):
            self.request(k)
        self.sync()

    def window(self, seconds: float) -> list:
        """Requests back to back until ``seconds`` have passed since the
        first started; each runs to its end."""
        out = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            out.append(self.request(len(out)))
        return out

    def traced(self) -> int:
        """The bounded sub-window a ``--trace 1`` run profiles: the mix's
        ``trace.requests`` requests; returns the frames served."""
        return sum(self.request(i).frames
                   for i in range(int(self.traffic["trace"]["requests"])))

    # what the correctness check asks of the entry
    def held(self, seed: int, served, k: int) -> list:
        """The worlds whose answers the check holds to the reference."""
        return sample(seed, served, k)

    def reference(self, k: int, params, dtype=None):
        """The reference's run of world ``k`` as this entry serves it."""
        dtype = dtype or self.torch.float32
        return self.ref.offline(self.worlds[k], params, self.device, dtype)

    def numbers(self, k: int, ans, whole, params) -> dict:
        """Every number of ``reference/compare.py`` for the answer ``ans``
        of world ``k`` against the reference's run ``whole``, and against
        the map the reference builds from the answer's own state."""
        got = compare.gaps(ans, whole)
        got.update(compare.selfs(ans, self.ref.remap(
            self.worlds[k], ans[1], ans[2], ans[3], params, self.device)))
        return got
