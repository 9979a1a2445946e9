"""Meshes over the ranks of a process group, and the rank-local blocks the
engines take.

Port of ``icm_slam_tpu.parallel.mesh``.  JAX shards a global array over a
device mesh and lets GSPMD insert the collectives; here every rank holds
one contiguous block of the sharded axis as a plain tensor (the kernels
take raw pointers, so no DTensor sits in front of them), and the engines
make the cross-rank steps themselves through ``TimeBlock``:

* the fleet axis (``make_fleet_mesh``, axis ``"w"``): worlds never exchange
  information, so a fleet's ranks need no collective until the results
  are gathered (``solver.icm.run_batched(mesh=...)``);
* the time axis (``make_mesh``, axis ``"t"``): per-frame association and
  pose solves stay local; the label and running-mean prefixes over
  earlier frames are cross-rank scans, the neighbour poses of a block's
  edge frames are halos, and the map table is summed from every rank's
  totals (``solver.sweeps.refine_sweep_batched(..., mesh=...)``).

Every cross-rank sum is an ``all_gather`` added up in rank order on every
rank, never an ``all_reduce`` (whose order is the backend's): so every
rank holds the same bits, and ``filter_map`` decides the same everywhere.
A one-process caller with no group gets a one-rank group, and that mesh
runs the same code.
"""
from __future__ import annotations

import math
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard
from torch.utils._pytree import tree_map

from icm_slam_tpu_torch.parallel.distributed import (BACKENDS, device_type,
                                                     initialize)

TIME_AXIS = "t"
FLEET_AXIS = "w"

# collectives issued by this module and parallel.pipeline since the
# caller last set it to 0 (what chip_smoke.py reports)
COLLECTIVES = 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mesh(axis: str, n_devices, device) -> DeviceMesh:
    """A 1-D mesh named ``axis`` over every rank of the process group,
    rank r at coordinate r; the group is made first where there is none
    (from the environment, as ``initialize()``, else one rank on a free
    local port)."""
    kind = device_type(device)
    if not dist.is_initialized():
        initialize(device=kind)
    if not dist.is_initialized():
        initialize(f"localhost:{_free_port()}", 1, 0, device=kind)
    backend = dist.get_backend()
    if backend != BACKENDS[kind]:
        raise ValueError(f"a {kind} mesh needs a {BACKENDS[kind]} process "
                         f"group; this one runs {backend}")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh of {n_devices} ranks asked for; the "
                         f"process group has {n}")
    return DeviceMesh(kind, list(range(n)), mesh_dim_names=(axis,))


def make_mesh(n_devices=None, device="cuda") -> DeviceMesh:
    """1-D mesh over the time axis: rank r holds the r-th contiguous block
    of frames (``shard_sweep_inputs``)."""
    return _mesh(TIME_AXIS, n_devices, device)


def make_fleet_mesh(n_devices=None, device="cuda") -> DeviceMesh:
    """1-D mesh over the fleet (world) axis: rank r runs the r-th block of
    worlds through the fleet engine on its own."""
    return _mesh(FLEET_AXIS, n_devices, device)


def check_axis(mesh: DeviceMesh, axis: str) -> None:
    """Raise unless ``mesh`` is a 1-D mesh over ``axis`` (a fleet mesh
    where the time axis is wanted would shard the wrong axis)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if tuple(names or ()) != (axis,):
        make = {TIME_AXIS: "make_mesh", FLEET_AXIS: "make_fleet_mesh"}[axis]
        raise ValueError(f"a mesh over axis {axis!r} is needed "
                         f"(icm_slam_tpu_torch.parallel.mesh.{make}); got "
                         f"{mesh!r}")


def fleet_sharding(mesh: DeviceMesh):
    """Leading-axis (world) sharding on a fleet mesh, as DTensor
    placements."""
    return [Shard(0)]


def time_sharding(mesh: DeviceMesh):
    """Leading-axis (frame) sharding on a time mesh."""
    return [Shard(0)]


def replicated(mesh: DeviceMesh):
    return [Replicate()]


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's blocks live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _local_block(mesh: DeviceMesh, a, what: str):
    """This rank's contiguous block of ``a`` along axis 0, on its
    device."""
    a = torch.as_tensor(a)
    n, r = mesh.size(), mesh.get_local_rank()
    if a.shape[0] % n:
        raise ValueError(f"{what}: {a.shape[0]} rows do not split over "
                         f"{n} ranks")
    per = a.shape[0] // n
    return a[r * per:(r + 1) * per].to(mesh_device(mesh)).contiguous()


def put_fleet_sharded(mesh: DeviceMesh, tree):
    """This rank's block of worlds of a stacked (W, ...) pytree (every rank
    passes the whole tree); W must be a multiple of the mesh size (callers
    pad by repeating a world, as ``solver.icm.run_batched`` does)."""
    return tree_map(lambda a: _local_block(mesh, a, "put_fleet_sharded"),
                    tree)


def put_time_sharded(mesh: DeviceMesh, a):
    """This rank's block of frames of one (T, ...) array; T must be a
    multiple of the mesh size (``shard_sweep_inputs`` pads it)."""
    return _local_block(mesh, a, "put_time_sharded")


def put_replicated(mesh: DeviceMesh, tree):
    """A pytree every rank holds whole, on this rank's device (every rank
    must pass identical values)."""
    dev = mesh_device(mesh)
    return tree_map(lambda a: torch.as_tensor(a).to(dev), tree)


def shard_sweep_inputs(mesh: DeviceMesh, data, x, pad_to=None):
    """This rank's block of SweepData and poses: the per-frame arrays
    split along T, a shared 1-D ``ang`` whole.

    T is padded to a multiple of ``pad_to`` (and of the mesh size) with
    all-masked frames, which the sweep treats as empty and leaves alone
    past its ``last_t``; a per-frame (T, B) ``ang`` is padded like the
    rest.  Returns (data, x, the true T).
    """
    from icm_slam_tpu_torch.solver.sweeps import SweepData

    n = mesh.size()
    T = data.dist.shape[0]
    pad = (-T) % math.lcm(pad_to or 1, n)
    if pad:
        def pad_t(a):
            return torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])

        data = SweepData(
            dist=pad_t(data.dist), mask=pad_t(data.mask),
            ang=data.ang if data.ang.dim() == 1 else pad_t(data.ang),
            odom=pad_t(data.odom), u=pad_t(data.u))
        x = pad_t(x)
    data = SweepData(
        dist=put_time_sharded(mesh, data.dist),
        mask=put_time_sharded(mesh, data.mask),
        ang=(put_replicated(mesh, data.ang) if data.ang.dim() == 1
             else put_time_sharded(mesh, data.ang)),
        odom=put_time_sharded(mesh, data.odom),
        u=put_time_sharded(mesh, data.u))
    return data, put_time_sharded(mesh, x), T


def gather_blocks(mesh: DeviceMesh, a):
    """Every rank's block ``a`` (R, ...), concatenated in rank order along
    axis 0: (n R, ...) on every rank, by one ``all_gather_into_tensor``
    (bool blocks travel as uint8)."""
    global COLLECTIVES
    COLLECTIVES += 1
    src = a.to(torch.uint8) if a.dtype == torch.bool else a
    out = src.new_empty((mesh.size() * a.shape[0],) + tuple(a.shape[1:]))
    dist.all_gather_into_tensor(out, src.contiguous(),
                                group=mesh.get_group())
    return out.to(torch.bool) if a.dtype == torch.bool else out


def gather_time_sharded(mesh: DeviceMesh, x_local, T: int):
    """The whole (T, ...) array on every rank from each rank's block of a
    time-sharded one (padding dropped)."""
    return gather_blocks(mesh, x_local)[:T]


class TimeBlock:
    """This rank's contiguous block of frames on a time mesh, and the
    cross-rank steps of a sweep over it.

    Arrays have the fleet's leading world axis W and the frames on axis 1:
    (W, T, ...), T the block's frame count (the same on every rank).  Rank
    r holds the global frames ``start`` .. ``start + T - 1`` of ``total``.
    """

    def __init__(self, mesh: DeviceMesh, T: int):
        check_axis(mesh, TIME_AXIS)
        self.mesh = mesh
        self.rank, self.n = mesh.get_local_rank(), mesh.size()
        self.T, self.start, self.total = T, mesh.get_local_rank() * T, \
            mesh.size() * T

    def _gather(self, a):
        """(n, ...): every rank's ``a``, in rank order."""
        return gather_blocks(self.mesh, a[None])

    def scan(self, total):
        """(exclusive prefix, global total) of the per-rank ``total``s: the
        sum over the earlier ranks (None on rank 0: nothing to add) and over
        all, each added up in rank order, the same on every rank."""
        g = self._gather(total)
        acc, pre = g[0], None
        for r in range(1, self.n):
            if r == self.rank:
                pre = acc
            acc = acc + g[r]
        return pre, acc

    def frames(self, a):
        """(W, total, ...): every rank's frames of ``a`` (W, T, ...), in
        global order."""
        g = self._gather(a)                                  # (n, W, T, ...)
        return g.movedim(0, 1).reshape(
            (a.shape[0], self.total) + tuple(a.shape[2:]))

    def halo(self, a):
        """(W, T + 2, ...): ``a`` between the previous rank's last frame and
        the next rank's first; the ends of the axis repeat their own edge
        frame (which a clamped neighbour index reads)."""
        g = self._gather(torch.stack([a[:, 0], a[:, -1]], dim=1))
        left = g[self.rank - 1, :, 1] if self.rank > 0 else a[:, 0]
        right = g[self.rank + 1, :, 0] if self.rank < self.n - 1 \
            else a[:, -1]
        return torch.cat([left[:, None], a, right[:, None]], dim=1)
