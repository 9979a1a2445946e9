"""Process-group bring-up for multi-rank runs.

Port of ``icm_slam_tpu.parallel.distributed``: one process per rank, every
rank runs the same program after ``initialize()``; ``parallel.mesh``
builds its meshes over the ranks of the group.  On the card each rank
binds one GPU and the group runs NCCL; on the CPU (``device="cpu"``, what
the tests ask for) it runs gloo.  Nothing falls back: a ``cuda`` request
without CUDA raises.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _env(*names):
    """The first of the environment variables ``names`` that is set."""
    for n in names:
        v = os.environ.get(n)
        if v is not None and v != "":
            return v
    return None


def device_type(device) -> str:
    """``device`` (a name or a torch.device) as "cuda" or "cpu"; a CUDA
    request without CUDA raises, as ``solver.icm.resolve_device`` does."""
    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"no process-group backend for device {device!r}")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but "
                           f"torch.cuda.is_available() is False")
    return kind


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device="cuda") -> None:
    """``torch.distributed.init_process_group`` with environment fallbacks
    (a no-op when nothing is configured: a one-process run).

    Fallbacks: ``ICM_COORDINATOR`` (host:port), ``ICM_NUM_PROCESSES``,
    ``ICM_PROCESS_ID``, as in the JAX package, then torchrun's
    ``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.  The group
    meets at ``tcp://<coordinator>``; its backend is NCCL for ``cuda``
    (each rank binds ``cuda:LOCAL_RANK % device_count``, ``LOCAL_RANK``
    defaulting to the process id) and gloo for ``cpu``.
    """
    if coordinator_address is None:
        coordinator_address = _env("ICM_COORDINATOR")
        if coordinator_address is None and _env("MASTER_ADDR"):
            coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                                   f"{_env('MASTER_PORT') or 29500}")
    if num_processes is None:
        v = _env("ICM_NUM_PROCESSES", "WORLD_SIZE")
        num_processes = int(v) if v is not None else None
    if process_id is None:
        v = _env("ICM_PROCESS_ID", "RANK")
        process_id = int(v) if v is not None else None
    if coordinator_address is None and num_processes is None:
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            f"initialize needs a coordinator, a process count and a process "
            f"id; got {coordinator_address!r}, {num_processes!r}, "
            f"{process_id!r}")
    kind = device_type(device)
    if kind == "cuda":
        local = int(_env("LOCAL_RANK") or process_id)
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(BACKENDS[kind],
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def is_primary() -> bool:
    """Rank 0 of the group, or the one process of a run without one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def global_mesh(device="cuda"):
    """1-D time-axis mesh over every rank of the group."""
    from icm_slam_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(device=device)
