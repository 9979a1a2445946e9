"""Finds a cell's pieces by name, each in a file of its own, so that a new
configuration, traffic mix, metric or check limit is a new file and an
entry in ``BENCHMARK.json``, never an edit of a file that exists:

* ``BENCHMARK.json`` at the checkout's root: the cells and the metrics;
* ``slambench/configs/<config>.json``: a deployment (the worlds and the
  solver's parameters);
* ``slambench/traffic/<traffic>.json``: a mix's parameters, which the
  generator (``drive.py``) reads;
* ``slambench/entries/<entry>.py``: the ``Entry`` that a mix's ``entry``
  names, which serves a request through the program (and brings its own
  request loop where the mix needs another shape of load);
* ``slambench/metrics/<metric>.py``: a per-layer metric's reader, a
  ``read(ctx)`` that returns a number or None;
* ``slambench/reference/<reference>.py``: the plain reference that a
  configuration's ``"reference"`` names (``icm`` where it names none);
* ``slambench/worlds/<generator>.py``: the world generator that a
  configuration's ``world.generator`` names, a ``generate(seed=..., **kw)``
  (``synthetic_world`` is ``harness/worlds.py``'s own);
* ``slambench/limits/<cell>.json``: the limits of the cell's correctness
  check.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

from slambench.harness.worlds import synthetic_world

ROOT = Path(__file__).resolve().parents[2]


class Registry:
    def __init__(self, root=ROOT):
        self.root = Path(root)
        self.dir = self.root / "slambench"
        with open(self.root / "BENCHMARK.json") as f:
            self.bench = json.load(f)

    def _json(self, kind: str, name: str) -> dict:
        with open(self.dir / kind / f"{name}.json") as f:
            return json.load(f)

    def cell(self, name: str) -> dict:
        for c in self.bench["workloads"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, cell: str) -> dict:
        return self._json("limits", cell)

    def end_to_end(self, cell: str) -> list:
        """The cell's end-to-end metrics: those with no ``workloads`` key,
        and those that list it."""
        return [m for m in self.bench["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        """The cell's per-layer metrics: those whose ``workloads`` list
        it (every per-layer metric lists its cells)."""
        return [m for m in self.bench["per_layer"]
                if cell in m["workloads"]]

    def _module(self, kind: str, name: str):
        path = self.dir / kind / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no {kind} {name!r}: {path} is not a file")
        spec = importlib.util.spec_from_file_location(
            f"slambench_{kind}_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        # a dataclass looks its module up while the class is made
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        return mod

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        return self._module("metrics", metric).read

    def entry(self, name: str):
        """The ``Entry`` class of ``entries/<name>.py``."""
        return self._module("entries", name).Entry

    def reference(self, name: str):
        """The module ``reference/<name>.py``: its ``Params`` (with
        ``from_solver``), ``offline`` and ``remap``, and what an entry of
        its own calls."""
        return self._module("reference", name)

    def world_generator(self, name: str):
        """The generator a configuration's ``world.generator`` names:
        ``synthetic_world``, or the ``generate`` of ``worlds/<name>.py``."""
        if name == "synthetic_world":
            return synthetic_world
        return self._module("worlds", name).generate

    def generator(self, traffic: str, config: dict, seed: int, device):
        """The mix ``traffic``'s entry over the worlds of ``config``."""
        mix = self.traffic(traffic)
        return self.entry(mix["entry"])(mix, config, seed, device,
                                        registry=self)
