"""Typed configuration, without JAX or a module-level YAML import.

Field names, defaults and semantics follow ``icm_slam_tpu.config.ICMConfig``
(see there for the long notes on each knob), so the same YAML files and
keyword arguments configure both packages.  The TPU-only knobs
(``use_pallas_assoc``, ``use_pallas_fused_assoc``,
``assoc_onehot_max_elems``), the bundle-adjustment knobs and the fields
no ported code reads (the ROS topics, ``time``, ``file``, ``n_beams``,
``dist_thr_obs``) are not fields here.  ``from_yaml`` ignores unknown
keys, so the same YAML files load.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ICMConfig:
    """Physics / algorithm parameters (reference-compatible)."""

    # --- reference parameters (config_ros.yaml keys) ---
    N: int = 30                      # outer ICM iterations
    deltat: float = 0.1              # sampling period [s]
    L: int = 1024                    # landmark table capacity
    Q: Tuple[float, float] = (1.0, 1.0)          # observation weight diag
    R: Tuple[float, float, float] = (1.0, 1.0, 1.0)  # motion-model weight diag
    cte_odom: float = 1.0            # odometry-residual weight
    cota: float = 300.0              # min observations to keep a landmark
    dist_thr: float = 1.0            # association / merge distance gate [m]
    rango_laser_max: float = 10.0    # lidar max range [m]
    radio: float = 0.137             # tree trunk radius compensation [m]

    # --- sensor geometry ---
    beam0_deg: float = 0.0
    beam_step_deg: float = 1.0

    # --- engine knobs ---
    sweep_mode: str = "batched"      # only "batched" is ported
    init_mode: str = "auto"          # auto | batched ("sequential": not ported)
    init_rounds: int = 2             # Picard rounds per chunk (batched init)
    init_chunk_len: int = 32         # frames per chunk of the batched init
    init_merge_cap: int = 0          # batched init's final merge width:
                                     # 0 = full L, -1 = map_run_cap, >0 explicit
    init_final_assoc: bool = True    # rebuild each chunk's table from the
                                     # converged poses
    init_gn_iters: int = 0           # LM iterations per init solve (0 = pose_gn_iters)
    pose_gn_iters: int = 8           # LM iterations per pose solve
    pose_passes: int = 2             # red-black half-pass pairs per sweep
    pose_update: str = "redblack"    # redblack ("jacobi": not ported)
    replicate_new_obs_quirk: bool = True  # ICM_SLAM.py:176 empty-slice quirk
    obs_cap: int = 0                 # beams per frame after compaction (0 = auto)
    map_run_cap: int = 256           # running-mean table width for old
                                     # landmarks (0 = full L)
    map_run_cap_checked: bool = False  # keep the cap and witness it at runtime
    dtype: str = "float32"
    model: Optional[Any] = None      # custom EnergyModel hooks (not ported)

    @staticmethod
    def from_yaml(path: str, **overrides) -> "ICMConfig":
        """Load a reference-format YAML (top-level key ``D``)."""
        import yaml
        with open(path) as f:
            data = yaml.safe_load(f)
        d = data.get("D", data)
        known = {f.name for f in dataclasses.fields(ICMConfig)}
        kwargs = {}
        for k, v in d.items():
            if k not in known:
                continue
            if k in ("Q", "R"):
                v = tuple(float(x) for x in v)
            kwargs[k] = v
        kwargs.update(overrides)
        return ICMConfig(**kwargs)
