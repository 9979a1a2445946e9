"""The port's examples (examples_torch/01-07) as their users run them, on
the CPU at a small size: each in a process of its own with ``--device
cpu``, where importing JAX or the JAX package fails (so an example that
reached for either would fail here), all at once.  Each must exit 0 and
print its outcome line; 01 writes its two PNGs into its working
directory; 05 runs on two gloo ranks (``ICM_COORDINATOR`` /
``ICM_NUM_PROCESSES`` / ``ICM_PROCESS_ID``) and prints the census of the
one-rank run.
"""
import os
import re
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples_torch")

# run the example as ``python example.py`` would, with an import hook that
# refuses jax and icm_slam_tpu (not icm_slam_tpu_torch)
RUN_WITHOUT_JAX = (
    "import runpy, sys\n"
    "class NoJax:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'icm_slam_tpu'):\n"
    "            raise ImportError(f'{name} refused: the port needs no JAX')\n"
    "sys.meta_path.insert(0, NoJax())\n"
    "path = sys.argv[1]\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_path(path, run_name='__main__')\n")

# example -> (arguments at the test's size, the outcome line's pattern)
CASES = {
    "01_offline_pipeline.py": (
        ["--frames", "200", "--iters", "2"],
        r"^wrote slam_result\.png, convergence\.png$"),
    "02_online_streaming.py": (
        ["--frames", "200", "--iters", "2"],
        r"^online run: 200 poses, \d+ landmarks$"),
    "03_custom_potentials.py": (
        ["--frames", "120", "--iters", "2"],
        r"^robust-h run: \d+ landmarks$"),
    "04_pose_graph_loop_closure.py": (
        [], r"^residual norm: \S+ -> \S+$"),
    "06_fleet_mode.py": (
        ["--frames", "120", "--iters", "2"],
        r"^fleet sharded over 1 rank\(s\): same censuses \[[\d, ]+\]"),
    "07_live_rosbridge.py": (
        [], r"^landmarks: \d+$"),
}
SHARDING = "05_multichip_sharding.py"
SHARDED_LINE = r"^sharded sweep over (\d) rank\(s\): (\d+) landmarks, " \
               r"poses \(400, 3\)$"


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(name, args, cwd, **env):
    return subprocess.Popen(
        [sys.executable, "-c", RUN_WITHOUT_JAX,
         os.path.join(EXAMPLES, name), "--device", "cpu", *args],
        cwd=cwd, env=dict(os.environ, OMP_NUM_THREADS="1", **env),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    return proc.returncode, out, err


def _stdout(runs, name):
    rc, out, err = runs[name]
    assert rc == 0, f"{name}: exit {rc}\n{err[-3000:]}"
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every example's exit code, standard output and error (05: one rank,
    then each of two ranks), all run at once; and their directories."""
    work = {name: tmp_path_factory.mktemp(name[:2]) for name in CASES}
    procs = {name: _start(name, args, work[name])
             for name, (args, _) in CASES.items()}
    procs["05 one rank"] = _start(SHARDING, [], REPO)
    port = str(_free_port())
    for r in (0, 1):
        procs[f"05 rank {r}"] = _start(
            SHARDING, [], REPO, ICM_COORDINATOR=f"localhost:{port}",
            ICM_NUM_PROCESSES="2", ICM_PROCESS_ID=str(r))
    try:
        return {name: _finish(p) for name, p in procs.items()}, work
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_and_reports(runs, name):
    out = _stdout(runs[0], name)
    assert any(re.match(CASES[name][1], ln) for ln in out.splitlines()), out
    if name.startswith("01"):
        for f in ("slam_result.png", "convergence.png"):
            assert os.path.getsize(runs[1][name] / f) > 1000


def test_example_05_two_gloo_ranks_match_one(runs):
    out = {k: _stdout(runs[0], k)
           for k in ("05 one rank", "05 rank 0", "05 rank 1")}
    one = re.search(SHARDED_LINE, out["05 one rank"], re.M)
    two = re.search(SHARDED_LINE, out["05 rank 0"], re.M)
    assert one and two, out
    assert one.group(1) == "1" and two.group(1) == "2"
    assert one.group(2) == two.group(2)             # the census
    assert not re.search(SHARDED_LINE, out["05 rank 1"], re.M)  # primary
