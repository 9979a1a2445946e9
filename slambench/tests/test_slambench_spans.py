"""CPU tests of the readers of the program's spans (``harness/spans.py``,
``metrics/graph_capture_s.py``, ``replay_launch_ms.py``,
``eager_launches.py``, ``alloc_calls.py``) on hand-built traces, and of
how a device-side annotation of a program span passes through
``tracing.from_events``.

    python -m pytest slambench/tests/test_slambench_spans.py -q
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from slambench.harness import bench, drive, readers, tracing  # noqa: E402
from slambench.harness.registry import Registry  # noqa: E402

METRICS = ("graph_capture_s", "replay_launch_ms", "eager_launches",
           "alloc_calls")
MS = 10 ** 6        # ns


def _ev(name, start, end):
    return tracing.Event(name, start, end)


def _request(init_capture_s, capture_s):
    return drive.Request([0], [], 0.0, 1.0, 100,
                         {"init_capture_s": init_capture_s,
                          "capture_s": capture_s, "init_s": 0.1})


def _trace(spans, host):
    return tracing.Trace([], [(0, 1)], (0, 20 * MS), {}, sorted(
        host, key=lambda e: e.start), sorted(spans, key=lambda e: e.start))


# two calls of the program in a traced sub-window, in ms: the first
# captures a graph (its recording inside) and replays it twice, the second
# replays once; the harness's own spans around them
SPANS = [_ev(tracing.WINDOW, 0, 20 * MS),
         _ev("slambench.solve", 0, 9 * MS),
         _ev("icm.run", 1 * MS, 8 * MS),
         _ev("icm.init", 1 * MS, 5 * MS),
         _ev("icm.graph.capture", 2 * MS, 3 * MS),
         _ev("icm.graph.record", 2 * MS + 400_000, 2 * MS + 900_000),
         _ev("icm.graph.replay", 3 * MS, 3 * MS + 50_000),
         _ev("icm.graph.replay", 4 * MS, 4 * MS + 10_000),
         _ev("slambench.solve", 10 * MS, 19 * MS),
         _ev("icm.run", 11 * MS, 18 * MS),
         _ev("icm.graph.replay", 12 * MS, 12 * MS + 20_000)]
HOST = [_ev("cudaLaunchKernel", 1 * MS + 100, 1 * MS + 200),      # counted
        _ev("cudaLaunchKernel", 2 * MS + 500_000, 2 * MS + 500_010),
        # ^ recorded into the graph
        _ev("cudaMalloc", 2 * MS + 600_000, 2 * MS + 600_100),
        # ^ the graph's private pool: counted
        _ev("cudaMalloc", 2 * MS + 100, 2 * MS + 200),            # counted
        _ev("cudaFree", 2 * MS + 300, 2 * MS + 400),              # counted
        _ev("cudaGraphLaunch", 3 * MS + 10, 3 * MS + 40_000),
        _ev("cudaLaunchKernel", 9 * MS + 100, 9 * MS + 200),     # outside
        _ev("cudaFree", 9 * MS + 300, 9 * MS + 400),             # outside
        _ev("cuLaunchKernel", 11 * MS + 100, 11 * MS + 200),     # counted
        _ev("cudaLaunchKernelExC", 13 * MS, 13 * MS + 100),       # counted
        _ev("cudaMalloc", 14 * MS, 14 * MS + 100),                # counted
        _ev("cudaMallocHost", 14 * MS + 200, 14 * MS + 300),      # no
        _ev("aten::add", 15 * MS, 15 * MS + 100)]


def _read(metric, trace, requests):
    ctx = bench.Context("grove.offline", {}, 1.0, requests, trace)
    return Registry().reader(metric)(ctx)


@pytest.mark.parametrize("metric,want", [
    ("graph_capture_s", (0.03 + 0.02 + 0.05 + 0.01) / 2),
    ("replay_launch_ms", (0.05 + 0.01 + 0.02) / 2),
    ("eager_launches", 3 / 2),
    ("alloc_calls", 4 / 2)])
def test_readers_on_a_hand_built_trace(metric, want):
    reqs = [_request(0.03, 0.02), _request(0.05, 0.01)]
    assert _read(metric, _trace(SPANS, HOST), reqs) == pytest.approx(want)


@pytest.mark.parametrize("metric", METRICS)
def test_readers_without_program_spans_give_none(metric):
    """A program that opens no span of its own (the parent's): nothing
    to read, whatever the harness's spans and the host did."""
    harness_only = [s for s in SPANS if not s.name.startswith("icm.")]
    reqs = [_request(0.03, 0.02)]
    assert _read(metric, _trace(harness_only, HOST), reqs) is None
    assert _read(metric, None, reqs) is None


@pytest.mark.parametrize("metric", METRICS)
def test_readers_are_listed_for_both_cells(metric):
    reg = Registry()
    for cell in ("grove.offline", "fleet8.offline"):
        assert metric in [m["name"] for m in reg.per_layer(cell)]
        assert callable(reg.reader(metric))


class _Raw:
    """A stand-in for one of the profiler's raw events as torch 2.11 gives
    them: no activity type, ``is_user_annotation`` true for the host's and
    the device's ranges of a ``record_function``."""

    def __init__(self, name, kind, start, end, cuda=False):
        self._n, self._k, self._s, self._e, self._d = (name, kind, start,
                                                       end, cuda)

    def name(self):
        return self._n

    def is_user_annotation(self):
        return "annotation" in self._k

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def start_thread_id(self):
        return 1


class _RawTyped(_Raw):
    """The same with the activity type later torches give."""

    def activity_type(self):
        return self._k


@pytest.mark.parametrize("_Raw", [_Raw, _RawTyped])
def test_a_device_side_program_span_is_no_kernel_and_no_busy_time(_Raw):
    ev = [_Raw(tracing.WINDOW, "user_annotation", 0, 1000),
          _Raw("icm.run", "user_annotation", 0, 1000),
          _Raw("icm.init", "user_annotation", 0, 500),
          _Raw("cudaFree", "cuda_runtime", 40, 160),
          _Raw("k_a", "kernel", 200, 300, cuda=True),
          # the device's range of icm.init: from its first kernel to its
          # last, over the idle time between them
          _Raw("icm.init", "gpu_user_annotation", 200, 450, cuda=True),
          _Raw("k_b", "kernel", 400, 450, cuda=True)]
    t = tracing.from_events(ev, {})
    assert [k.name for k in t.kernels] == ["k_a", "k_b"]
    assert t.busy == [(200, 300), (400, 450)]
    assert readers.idle_pct(t) == pytest.approx(85.0)
    bd = t.breakdown()
    assert not any(n.startswith("icm.") for n, _ in bd["device_ops"])
    # the idle gaps are named by the program's innermost span
    assert bd["idle_gaps"][0][0] == "icm.run/idle host"      # 450-1000
    assert dict(bd["idle_gaps"])["icm.init/cudaFree"] == pytest.approx(
        200e-9)
