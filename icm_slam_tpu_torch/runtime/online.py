"""Online (streaming) SLAM engine on ``device``.

Port of ``icm_slam_tpu.runtime.online.OnlineSLAM``: frames arrive through
``push()`` into host-side buffers; every ``chunk_size`` frames the causal
init runs on the device over them (``solver.sweeps.init_chunk``, carrying
the map and the last pose), so the result is the sequential causal init
frame for frame.  ``finish()`` filters the map and optionally refines
the streamed state offline with the batched sweeps.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from icm_slam_tpu_torch.config import ICMConfig
from icm_slam_tpu_torch.core.energy import weights
from icm_slam_tpu_torch.core.geometry import beam_angles, beams_to_world
from icm_slam_tpu_torch.data.datasets import Dataset
from icm_slam_tpu_torch.frontend.scan_filter import (filter_scans,
                                                     preprocess_ranges)
from icm_slam_tpu_torch.mapping.landmark_map import (empty_map, filter_map,
                                                     seed_from_clusters)
from icm_slam_tpu_torch.solver import icm
from icm_slam_tpu_torch.solver.sweeps import SweepData, init_chunk


class OnlineSLAM:
    def __init__(self, config: ICMConfig, device, chunk_size: int = 64,
                 verbose: bool = False):
        icm.check_supported(config)
        self.config = config
        self.device = icm.resolve_device(device)
        self.chunk = chunk_size
        self.verbose = verbose
        self.dtype = getattr(torch, config.dtype)
        self._w = weights(config, self.device)
        self._ang = beam_angles(config.n_beams, config.beam_step_deg,
                                config.beam0_deg, self.dtype,
                                device=self.device)
        # host-side frame buffers
        self._scans, self._odom, self._u = [], [], []
        self._pending = 0
        self._state = None       # MapState carry
        self._xt = None          # last pose carry
        self._poses = []         # committed pose chunks (NumPy)

    def push(self, ranges, odom, u):
        """Ingest one frame (raw ranges (B,), odometry (3,), control (2,))."""
        self._scans.append(np.asarray(ranges, np.float64).reshape(-1))
        self._odom.append(np.asarray(odom, np.float64).reshape(3))
        self._u.append(np.asarray(u, np.float64).reshape(2))
        self._pending += 1
        if self._state is None and len(self._scans) == 1:
            self._bootstrap()
            self._pending = 0
        elif self._pending >= self.chunk:
            self._flush()

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), device=self.device).to(
            self.dtype)

    def _filter(self, scans_np):
        c = self.config
        r = preprocess_ranges(self._tensor(scans_np), c.rango_laser_max,
                              c.radio)
        return filter_scans(r, c.rango_laser_max, c.dist_thr, c.n_beams,
                            c.beam_step_deg, c.beam0_deg)

    def _bootstrap(self):
        """Frame 0: pose = first odometry; host-clustered map seed."""
        x0 = self._tensor(self._odom[0])
        dist, mask = self._filter(np.asarray(self._scans[:1]))
        pts = beams_to_world(x0, dist[0], self._ang).cpu().numpy()
        m0 = mask[0].cpu().numpy()
        if m0.any():
            labels = icm.first_frame_labels(pts[m0], self.config.dist_thr)
            self._state = seed_from_clusters(self.config.L, pts[m0], labels,
                                             self.dtype, self.device)
        else:
            self._state = empty_map(self.config.L, self.dtype, self.device)
        self._xt = x0
        self._poses.append(x0.cpu().numpy()[None, :])

    def _flush(self):
        """Run the causal init on the device over the pending frames."""
        if self._pending == 0 or self._state is None:
            return
        total = len(self._scans)
        start = total - self._pending
        # the window starts one frame early: its control and odometry feed
        # the first pending frame's kinematic and odometry terms
        dist, mask = self._filter(np.asarray(self._scans[start - 1:total]))
        data = SweepData(dist=dist, mask=mask, ang=self._ang,
                         odom=self._tensor(self._odom[start - 1:total]),
                         u=self._tensor(self._u[start - 1:total]))
        self._state, self._xt, xs = init_chunk(
            data, self._state, self._xt, self.config, self._w, t_offset=1)
        self._poses.append(xs.cpu().numpy())
        self._pending = 0
        if self.verbose:
            print(f"[online] processed {total} frames, "
                  f"landmarks={int(self._state.nact)}", flush=True)

    def finish(self, refine: bool = True,
               n_iters: Optional[int] = None) -> icm.ICMResult:
        """Flush, filter the map, optionally refine offline.

        The refinement starts from the streamed state (map and
        trajectory); nothing of the init is recomputed.
        """
        self._flush()
        # the streamed nact is the raw allocated-label count: past L,
        # observations were dropped
        if self._state is not None:
            icm.check_table_overflow(int(self._state.nact), self.config.L,
                                     "online init")
        if not self._poses:
            raise RuntimeError(
                "online session captured no frames: nothing was pushed "
                "before finish()")
        x_init = np.concatenate(self._poses, axis=0)
        fm = filter_map(self._state, self.config.cota, self.config.dist_thr)
        if not refine:
            nact = int(fm.nact)
            return icm.ICMResult(
                x_init=x_init, x=x_init,
                map_pos=fm.pos[:nact].cpu().numpy(),
                map_counts=fm.counts[:nact].cpu().numpy(),
                changes=np.zeros((0, 3)), timings={})

        ds = Dataset(np.asarray(self._scans), np.asarray(self._odom),
                     np.asarray(self._u), x_init[0], name="online")
        n_iters = self.config.N if n_iters is None else n_iters
        data = icm.prepare(ds, self.config, self.device)
        config = icm.resolve_config(self.config, data)
        icm.check_witness(
            np.array([int(self._state.nact),
                      int(icm.kept_count(self._state, config.cota))]),
            config, "online init")
        data = icm.hoist_compaction(data, config)
        x = torch.as_tensor(x_init, device=self.device).to(data.dist.dtype)

        def report(k, cur_map, x):
            corr = float(torch.linalg.vector_norm(
                x.cpu() - torch.from_numpy(x_init).to(x.dtype), dim=1).sum())
            print(f"[online] refine {k + 1}/{n_iters} "
                  f"landmarks={int(cur_map.nact)} correction={corr:.4f}",
                  flush=True)

        t0 = time.perf_counter()
        cur_map, x, changes = icm.refine_loop(
            data, fm, x, config, self._w, n_iters,
            stride=1 if self.verbose else 0,
            on_segment=report if self.verbose else None)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        nact = int(cur_map.nact)
        return icm.ICMResult(
            x_init=x_init, x=x.cpu().numpy(),
            map_pos=cur_map.pos[:nact].cpu().numpy(),
            map_counts=cur_map.counts[:nact].cpu().numpy(),
            changes=changes,
            timings={"refine_s": time.perf_counter() - t0})
