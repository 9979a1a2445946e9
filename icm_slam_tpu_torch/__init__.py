"""icm_slam_tpu_torch — the ICM-SLAM engine on PyTorch and CUDA.

A port of ``icm_slam_tpu`` (JAX/XLA/Pallas) that mirrors its module layout
and names.  Plain tensor code is PyTorch with a leading batch axis where
the JAX package used ``vmap``; the two association kernels the JAX package
wrote in Pallas are hand-written CUDA C++ for Hopper (``csrc/``), built
with ``nvcc`` at first use and bound through ``ctypes`` (``ops/_build.py``).

This package imports neither ``jax`` nor ``icm_slam_tpu``.
"""
from icm_slam_tpu_torch.config import ICMConfig

__version__ = "0.1.0"
__all__ = ["ICMConfig"]
