"""State carried between the JAX package and the port, through NumPy.

The port imports no JAX: these helpers take anything ``np.asarray`` reads
(JAX arrays included) and the JAX package's NamedTuples by attribute, and
hand back the port's tensors, or turn the port's tensors into NumPy arrays
that JAX functions accept.  The parity tests use them to give both
packages the same config, init map and poses.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from icm_slam_tpu_torch.config import ICMConfig
from icm_slam_tpu_torch.mapping.landmark_map import MapState
from icm_slam_tpu_torch.solver.sweeps import SweepData

_PORT_FIELDS = {f.name for f in dataclasses.fields(ICMConfig)}


def config_dict(config) -> dict:
    """The fields of any ICMConfig-like dataclass that the port's config
    has (the TPU-only knobs are left out)."""
    return {f.name: getattr(config, f.name)
            for f in dataclasses.fields(config) if f.name in _PORT_FIELDS}


def config_to_torch(config) -> ICMConfig:
    return ICMConfig(**config_dict(config))


def _t(a, device, dtype=None):
    return torch.as_tensor(np.array(a), device=device, dtype=dtype)


def map_to_torch(state, device) -> MapState:
    """A (pos, counts, nact) map state -> the port's MapState."""
    return MapState(_t(state.pos, device, torch.float32),
                    _t(state.counts, device, torch.float32),
                    _t(state.nact, device, torch.int32))


def map_to_numpy(state: MapState):
    """(pos, counts, nact) as NumPy float32, float32, int32."""
    return (state.pos.cpu().numpy(), state.counts.cpu().numpy(),
            np.int32(int(state.nact)))


def sweep_data_to_torch(data, device) -> SweepData:
    return SweepData(dist=_t(data.dist, device, torch.float32),
                     mask=_t(data.mask, device, torch.bool),
                     ang=_t(data.ang, device, torch.float32),
                     odom=_t(data.odom, device, torch.float32),
                     u=_t(data.u, device, torch.float32))


def sweep_data_to_numpy(data: SweepData):
    """(dist, mask, ang, odom, u) as NumPy arrays."""
    return tuple(a.cpu().numpy() for a in data)


def poses_to_torch(x, device) -> torch.Tensor:
    return _t(x, device, torch.float32)


def poses_to_numpy(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()
