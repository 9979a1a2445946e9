"""CPU tests of ``metrics/graph_hit_share.py``: the mean share of a
call's two graphs taken from the program's cache, and None for a program
whose timings do not report it.

    python -m pytest slambench/tests/test_slambench_graph_hits.py -q
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from slambench.harness import bench, drive  # noqa: E402
from slambench.harness.registry import Registry  # noqa: E402


def _ctx(*timings):
    reqs = [drive.Request([0], [], 0.0, 1.0, 100, dict(t)) for t in timings]
    return bench.Context("grove.offline", {}, 1.0, reqs)


@pytest.mark.parametrize("hits, want", [((2, 2), 1.0), ((0, 2), 0.5),
                                        ((0, 1, 2, 1), 0.5), ((0,), 0.0)])
def test_the_share_of_graphs_taken_from_the_cache(hits, want):
    read = Registry().reader("graph_hit_share")
    ctx = _ctx(*({"graph_hits": h, "init_s": 0.1} for h in hits))
    assert read(ctx) == pytest.approx(want)


def test_none_where_the_program_reports_no_hits():
    read = Registry().reader("graph_hit_share")
    assert read(_ctx({"init_capture_s": 0.1, "capture_s": 0.1})) is None


def test_listed_for_both_cells():
    reg = Registry()
    for cell in ("grove.offline", "fleet8.offline"):
        names = {m["name"]: m for m in reg.per_layer(cell)}
        assert names["graph_hit_share"]["moves"] == "frames_per_s"
