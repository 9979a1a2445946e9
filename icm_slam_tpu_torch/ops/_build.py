"""Build the CUDA sources under ``csrc/`` with nvcc and load them via ctypes.

The first call on a GPU compiles every ``csrc/*.cu`` into an object, one
nvcc per source, all started together, and links them into one shared
library with a plain C interface, under ``build/icm_slam_tpu_torch/`` at
the root of the checkout, named by a hash of the sources and the flags;
later calls (and later processes) load the cached file.  Nothing here runs
at import time.  ``nvcc`` is found through ``CUDA_HOME``, then ``PATH``,
then ``/usr/local/cuda/bin``.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "icm_slam_tpu_torch")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "--fmad=false",
              "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
# C signatures of the exported launchers; each returns a cudaError_t
_SIGNATURES = {
    # pts, map, mask, nact, W, T, B, K, map_ws, thr2, threads, shmem, lab,
    # d2min, sums, stream
    "icm_assoc_sums": (_P, _P, _P, _P, _I, _I, _I, _I, _LL, _F, _I, _I, _P,
                       _P, _P, _P),
    # pts, map, nact, W, n_pts, L, map_ws, lanes, blocks, threads, shmem,
    # sqrt_key, lab, dist, stream
    "icm_nearest_landmark": (_P, _P, _P, _I, _I, _I, _LL, _I, _I, _I, _I,
                             _I, _P, _P, _P),
    # nn, close, n, W, K, threads, shmem, lab, stream
    "icm_relabel_walk": (_P, _P, _P, _I, _I, _I, _I, _P, _P),
    # fields (13 pointers), strides (13 long longs), sqrt_r, sqrt_q,
    # sqrt_odom, P, B, two_sided, iters, deltat, lam0, lam_down, lam_up,
    # f_vec, f_v, g_v, h_v, shmem, x_out, stream
    "icm_pose_lm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _I,
                    _I, _I, _I, _I, _P, _P),
}

_lock = threading.Lock()
_lib = None

# kernel launches, keyed (kernel, shape of the call): every wrapper adds
# one through ``count_launch`` where it launches its kernel, and nowhere
# else (the plain versions do not count)
LAUNCHES = collections.Counter()


def count_launch(kernel: str, shape: tuple) -> None:
    LAUNCHES[(kernel, shape)] += 1


def launches(kernel: str) -> int:
    """``kernel``'s launches since the counts were last cleared."""
    return sum(n for (k, _), n in LAUNCHES.items() if k == kernel)


def launch_shapes(kernel: str) -> dict:
    """``kernel``'s launches by the shape of the call."""
    return {s: n for (k, s), n in LAUNCHES.items() if k == kernel}


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _headers():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libicm_kernels_{h.hexdigest()[:16]}.so")


def _run_all(cmds) -> None:
    """Run the commands at once; raise with the first failure's output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def _compile(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = find_nvcc(), f"{out}.{os.getpid()}"
    objs = [f"{tag}.{os.path.basename(src)}.o" for src in _sources()]
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                  for src, obj in zip(_sources(), objs)])
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", f"{tag}.tmp",
                   *objs]])
        os.replace(f"{tag}.tmp", out)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _compile(path)
            lib = ctypes.CDLL(path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t from a launcher."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")


def check_pairs_aligned(**tensors) -> None:
    """Raise unless every (..., 2) float32 tensor starts on an 8-byte
    boundary: the kernels read and copy its rows as ``float2``, and a
    contiguous view that starts on an odd float would fault on the card."""
    for name, a in tensors.items():
        if a.data_ptr() % 8:
            raise ValueError(f"{name} must start on an 8-byte boundary "
                             f"(its rows are read as float2)")


_CURRENT = contextlib.nullcontext()


def on_device(device: torch.device):
    """A context in which ``device`` is the current CUDA device: nothing
    when it already is, as in every single-card run."""
    if device.index is None or device.index == torch.cuda.current_device():
        return _CURRENT
    return torch.cuda.device(device)


def current_stream(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device``: inside
    ``torch.cuda.graph`` that is the capturing stream."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def as_count(nact, device: torch.device):
    """``nact`` as an int32 tensor on ``device`` (0-d, or (W,) for a fleet);
    a tensor that already is one comes back as it is."""
    if isinstance(nact, torch.Tensor) and nact.dtype == torch.int32 \
            and nact.device == device:
        return nact
    return torch.as_tensor(nact, dtype=torch.int32, device=device)


def world_stride(map_pos) -> int:
    """Floats between two worlds' tables in a (W, K, 2) ``map_pos`` whose
    rows are contiguous (a column slice ``pos[:, :K]`` of a wider table is
    one); raises on any other layout, or on a stride that would start a
    world's table off the 8-byte boundary its float2 rows need."""
    if map_pos.stride(-1) != 1 or (map_pos.shape[-2] > 1
                                   and map_pos.stride(-2) != 2):
        raise ValueError("map_pos rows must be contiguous (K, 2) pairs")
    ws = map_pos.stride(0) if map_pos.shape[0] > 1 else 0
    if ws % 2:
        raise ValueError("map_pos worlds must start on 8-byte boundaries")
    return ws
