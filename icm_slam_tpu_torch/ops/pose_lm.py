"""The pose solve's fused LM loop (K4): wrapper and plain version.

Port of what XLA makes of ``icm_slam_tpu.solver.gauss_newton.lm_minimize``
over the default model's costs (``icm_slam_tpu.core.energy``): one device
loop per batch of problems.  On a CUDA tensor ``pose_lm`` launches the
hand-written kernel in ``csrc/pose_lm.cu`` (or raises); on a CPU tensor it
runs ``pose_lm_plain``, the same contract in plain PyTorch.  Neither reads
anything back to the host, so a sweep or an init chunk that calls it can
be captured in a CUDA graph.

Contract, for P problems: ``prob`` a ``core.energy.PoseProblem`` with a
leading P (dist, ang (P, B) float32, mask (P, B) bool, matched (P, B, 2),
x_prev, odo_prev, odo_cur (P, 3), u_prev (P, 2); two-sided also x_next,
odo_next (P, 3), u_cur (P, 2)), start poses ``x0`` (P, 3), the
``core.energy.weights`` tuple ``w`` (sqrt_r (3,), sqrt_q (2,), sqrt_odom
(), deltat), ``iters`` LM steps and, two-sided, an optional ``fold`` (P,)
bool that zeroes the 6 forward rows of those problems' residuals and
Jacobians (the last frame's one-sided system folded into a two-sided
batch).  Returns x (P, 3): ``solver.gauss_newton.lm_minimize`` on the
default one-sided cost (``one_sided_residuals`` / ``one_sided_jacobian``)
or two-sided cost, with Marquardt damping, the cofactor solve, a strict
``f_new < fx`` to accept and ``lam_down`` / ``lam_up``.

On the card the kernel is bitwise the plain version: it computes every
row with the plain version's float operations and adds the rows up in the
order torch's CUDA reduction adds the plain version's products
(``reduce_plan``, held against torch's sums by the ``cuda`` tests).  A
torch whose reduction order differs leaves the two equal to f32 rounding
only; the kernel repeats bitwise from run to run either way.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from icm_slam_tpu_torch.core.energy import (DEFAULT_MODEL, EnergyModel,
                                            PoseProblem, one_sided_jacobian,
                                            one_sided_residuals,
                                            two_sided_jacobian,
                                            two_sided_residuals)
from icm_slam_tpu_torch.ops import _build
from icm_slam_tpu_torch.solver.gauss_newton import lm_minimize

# the launches are counted in ``_build.LAUNCHES`` as "pose_lm", by the
# call's shape (P, B, "one" | "two")

LAM0, LAM_DOWN, LAM_UP = 1e-4, 0.25, 8.0
# the kernel's rows and partials live in the static shared memory a block
# may take without opting in
_MAX_SHMEM = 48 * 1024
# torch's reduction: threads a block for 4-byte values, lanes a warp, the
# per-thread values above which a block's warps split one output's inputs
# and above which blocks would (ATen/native/cuda/Reduce.cuh)
_MAX_THREADS, _WARP, _MAX_VALUES = 512, 32, 256


class LaunchPlan(NamedTuple):
    """How one call of K4 is laid out: a block of one warp a problem, and
    the order of its sums (``reduce_plan`` of f, g and H)."""
    shmem: int              # bytes: 4 m floats of rows, then the partials
    f_vec: int              # 1: f by torch's four-float vector loads
    f_v: int                # virtual threads of f's sum
    g_v: int                # of g's
    h_v: int                # of H's


def _last_pow2(n: int) -> int:
    return 1 << (int(n).bit_length() - 1)


def reduce_plan(P: int, m: int, outs: int):
    """How torch's CUDA sum over dim 1 of a contiguous float32 (P, m) tensor
    (``outs`` = 1), (P, m, 3) (3) or (P, m, 3, 3) (9) adds up each output:
    ``(vec, V)``, V virtual threads whose partials a halving tree combines,
    each adding every V-th of the m values from its own index (or, ``vec``,
    four-float vectors V apart) into four interleaved accumulators.  The
    port of ``setReduceConfig`` for these shapes, held against torch's own
    sums on the card (``tests/test_torch_kernels_cuda.py``); a shape it
    does not model raises."""
    fastest = outs == 1
    if fastest:
        dim0, dim1 = m, P
        vec = dim0 >= 128
        if vec:
            dim0 //= 4
    else:
        dim0, dim1, vec = P * outs, m, False
    d0 = _last_pow2(dim0) if dim0 < _MAX_THREADS else _MAX_THREADS
    d1 = _last_pow2(dim1) if dim1 < _MAX_THREADS else _MAX_THREADS
    bw = min(d0, _WARP)
    bh = min(d1, _MAX_THREADS // bw)
    bw = min(d0, _MAX_THREADS // bh)
    step = bw if fastest else 1
    split = -(-m // step) >= min(bh * 16, _MAX_VALUES)
    if split and (-(-m // (step * bh)) >= _MAX_VALUES
                  or (fastest and bh > 1)):
        raise ValueError(f"pose_lm: torch's sum order at P={P}, m={m} "
                         "(split over blocks or over both block axes) is "
                         "not modelled")
    if fastest:
        return int(vec), bw
    return 0, (bh if split else 1)


@functools.lru_cache(maxsize=256)
def launch_plan(P: int, B: int, two_sided: bool) -> LaunchPlan:
    m = (12 if two_sided else 6) + 2 * B
    P = max(P, 1)
    f_vec, f_v = reduce_plan(P, m, 1)
    g_v, h_v = reduce_plan(P, m, 3)[1], reduce_plan(P, m, 9)[1]
    shmem = 4 * (4 * m + max(9 * max(g_v, h_v), f_v))
    if shmem > _MAX_SHMEM:
        raise ValueError(f"pose_lm: B={B} beams need {shmem} bytes of "
                         f"shared memory a problem, above {_MAX_SHMEM}")
    return LaunchPlan(shmem, f_vec, f_v, g_v, h_v)


def _folded(fn, fold):
    """``fn`` with the 6 forward rows of the problems ``fold`` (P,) zeroed
    in its (P, m) residuals or (P, m, 3) Jacobians."""
    is_last = fold[:, None]

    def out(xx):
        v = fn(xx)
        rows = is_last & (torch.arange(v.shape[1], device=v.device) < 6)
        return torch.where(rows.view(rows.shape + (1,) * (v.dim() - 2)),
                           0.0, v)
    return out


def pose_lm_plain(prob: PoseProblem, x0, w, iters: int, two_sided: bool,
                  fold=None, model: EnergyModel = DEFAULT_MODEL,
                  lam0=LAM0, lam_down=LAM_DOWN, lam_up=LAM_UP):
    """The contract in plain PyTorch: ``lm_minimize`` on the residual and
    Jacobian builders of ``core.energy``.  ``model`` gives another
    ``EnergyModel``'s cost (its hooks by forward mode), which the kernel
    cannot run: the sweeps take this route for a config's model."""
    if two_sided:
        def resid(xx):
            return two_sided_residuals(xx, prob, w, model)

        def jac(xx):
            return two_sided_jacobian(xx, prob, w, model)
        if fold is not None:
            resid, jac = _folded(resid, fold), _folded(jac, fold)
    else:
        def resid(xx):
            return one_sided_residuals(xx, prob, w, model)

        def jac(xx):
            return one_sided_jacobian(xx, prob, w, model)
    return lm_minimize(resid, jac, x0, iters=iters, lam0=lam0,
                       lam_down=lam_down, lam_up=lam_up)


_READ_ONE = ("dist", "ang", "mask", "matched", "x_prev", "u_prev",
             "odo_prev", "odo_cur")
_READ_TWO = ("x_next", "u_cur", "odo_next")
# the kernel's fields, in its order (csrc/pose_lm.cu, ``Field``)
_FIELDS = _READ_ONE + _READ_TWO + ("x0", "fold")


def _rows(a):
    """``a`` (P, ...) and its row stride in elements, for a kernel that
    reads each row's elements contiguously: a view whose rows are
    contiguous (a frame of (W, T, B) data, an expanded beam-angle row) is
    read where it lies, anything else is copied."""
    inner = a[0] if a.shape[0] else a
    if not inner.is_contiguous():
        a = a.contiguous()
    return a, (a.stride(0) if a.shape[0] > 1 else 0)


def _check(prob: PoseProblem, x0, w, two_sided, fold):
    P = x0.shape[0] if x0.dim() == 2 else -1
    if x0.dim() != 2 or x0.shape[1] != 3 or x0.dtype != torch.float32:
        raise ValueError(f"x0 must be (P, 3) float32, got {tuple(x0.shape)} "
                         f"{x0.dtype}")
    B = prob.dist.shape[-1] if prob.dist.dim() == 2 else -1
    want = {"dist": (P, B), "ang": (P, B), "mask": (P, B),
            "matched": (P, B, 2), "x_prev": (P, 3), "u_prev": (P, 2),
            "odo_prev": (P, 3), "odo_cur": (P, 3), "x_next": (P, 3),
            "u_cur": (P, 2), "odo_next": (P, 3)}
    for name in _READ_ONE + (_READ_TWO if two_sided else ()):
        a = getattr(prob, name)
        dtype = torch.bool if name == "mask" else torch.float32
        if tuple(a.shape) != want[name] or a.dtype != dtype:
            raise ValueError(f"{name} must be {want[name]} {dtype}, got "
                             f"{tuple(a.shape)} {a.dtype}")
        if a.device != x0.device:
            raise ValueError(f"{name} is on {a.device}, x0 on {x0.device}")
    if fold is not None and (not two_sided or tuple(fold.shape) != (P,)
                             or fold.dtype != torch.bool
                             or fold.device != x0.device):
        raise ValueError("fold must be a (P,) bool on x0's device, for a "
                         "two-sided call")
    for name, a, n in (("sqrt_r", w[0], 3), ("sqrt_q", w[1], 2),
                       ("sqrt_odom", w[2], 1)):
        if a.numel() != n or a.dtype != torch.float32 \
                or a.device != x0.device:
            raise ValueError(f"{name} must be {n} float32 on {x0.device}")


def launch(prob: PoseProblem, x0, w, iters: int, two_sided: bool, fold,
           plan: LaunchPlan, lam0=LAM0, lam_down=LAM_DOWN, lam_up=LAM_UP):
    """K4 on CUDA tensors with the launch plan ``plan``: the fields are
    checked and read where they lie when each row's own elements are
    contiguous (otherwise copied); a plan the kernel refuses raises."""
    _check(prob, x0, w, two_sided, fold)
    P, B = prob.dist.shape
    out = torch.empty((P, 3), dtype=torch.float32, device=x0.device)
    if P == 0:
        return out
    given = prob._asdict()
    given.update(x0=x0, fold=fold)
    if not two_sided:
        given.update(x_next=None, u_cur=None, odo_next=None)
    rows = [None if given[name] is None else _rows(given[name])
            for name in _FIELDS]
    ptrs = (ctypes.c_void_p * len(_FIELDS))(*[
        None if r is None else r[0].data_ptr() for r in rows])
    strides = (ctypes.c_longlong * len(_FIELDS))(*[
        0 if r is None else r[1] for r in rows])
    wts = [a.contiguous() for a in w[:3]]
    fn = _build.library().icm_pose_lm
    with _build.on_device(x0.device):
        err = fn(ptrs, strides, *[a.data_ptr() for a in wts], P, B,
                 int(two_sided), int(iters), float(w[3]), float(lam0),
                 float(lam_down), float(lam_up), plan.f_vec, plan.f_v,
                 plan.g_v, plan.h_v, plan.shmem, out.data_ptr(),
                 _build.current_stream(x0.device))
    _build.check(err, "icm_pose_lm")
    _build.count_launch("pose_lm", (P, B, "two" if two_sided else "one"))
    return out


def pose_lm(prob: PoseProblem, x0, w, iters: int, two_sided: bool,
            fold=None, lam0=LAM0, lam_down=LAM_DOWN, lam_up=LAM_UP):
    """K4 on CUDA tensors, the plain version on CPU tensors (same contract
    as ``pose_lm_plain`` with the default model).  One launch for all P
    problems."""
    if x0.is_cpu:
        return pose_lm_plain(prob, x0, w, iters, two_sided, fold, lam0=lam0,
                             lam_down=lam_down, lam_up=lam_up)
    if not x0.is_cuda:
        raise ValueError(f"pose_lm: unsupported device {x0.device}")
    return launch(prob, x0, w, iters, two_sided, fold,
                  launch_plan(*prob.dist.shape, bool(two_sided)), lam0,
                  lam_down, lam_up)
