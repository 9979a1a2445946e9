"""Typed configuration, without JAX and without PyYAML.

Field names, defaults and semantics follow ``icm_slam_tpu.config.ICMConfig``
(see there for the long notes on each knob), so the same YAML files and
keyword arguments configure both packages.  The TPU-only knobs
(``use_pallas_assoc``, ``use_pallas_fused_assoc``,
``assoc_onehot_max_elems``) and the fields no ported code reads (``file``,
``dist_thr_obs``) are not fields here.  ``model`` takes
the port's ``core.energy.EnergyModel``, whose hooks are torch code.
``from_yaml`` ignores unknown keys, so the same YAML files
load; it reads them with ``read_yaml``, a reader of the reference format
(the machine with the GPU has no PyYAML).
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Optional, Tuple

_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?")
_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
_WORD = re.compile(r"[A-Za-z_/][A-Za-z0-9_/.-]*")      # e.g. a ROS topic
# words PyYAML reads as something other than a string
_RESERVED = re.compile(r"(?i:yes|no|on|off|true|false|null)")


def _scalar(tok: str):
    """One scalar of the reference format: an int, a float (with a dot), a
    lower-case bool, a quoted string or a plain word (``/scan``), typed as
    ``yaml.safe_load`` types it.  Anything else raises ValueError."""
    tok = tok.strip()
    if tok[:1] == "'" and tok[-1:] == "'" and len(tok) > 1:
        return tok[1:-1].replace("''", "'")
    if tok[:1] == '"' and tok[-1:] == '"' and len(tok) > 1:
        return json.loads(tok)
    if tok in ("true", "false"):
        return tok == "true"
    if _INT.fullmatch(tok):
        return int(tok)
    if _FLOAT.fullmatch(tok):
        return float(tok)
    if _WORD.fullmatch(tok) and not _RESERVED.fullmatch(tok):
        return tok
    raise ValueError(f"unsupported scalar {tok!r}")


def _value(tok: str):
    tok = tok.strip()
    if tok.startswith("[") and tok.endswith("]"):
        inner = tok[1:-1].strip()
        return [_scalar(p) for p in inner.split(",")] if inner else []
    return _scalar(tok)


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def read_yaml(path: str) -> dict:
    """Read a reference-format YAML file: top-level keys whose values are
    scalars, flow lists (``[1, 1]``) or one nested mapping of those (the
    ``D:`` block).  Returns what ``yaml.safe_load`` returns for such a
    file; anything outside that format raises ValueError."""
    out: dict = {}
    block = None
    with open(path) as f:
        for n, raw in enumerate(f, 1):
            line = _strip_comment(raw.rstrip("\n")).rstrip()
            if not line.strip():
                continue
            indent = len(line) - len(line.lstrip(" "))
            key, sep, rest = line.strip().partition(":")
            if not sep or not key or (rest and rest[0] not in " \t"):
                raise ValueError(f"{path}:{n}: not a 'key: value' line")
            key = key.strip()
            if not _KEY.fullmatch(key) or _RESERVED.fullmatch(key):
                raise ValueError(f"{path}:{n}: unsupported key {key!r}")
            if indent == 0:
                if rest.strip():
                    out[key] = _value(rest)
                    block = None
                else:
                    block = out[key] = {}
            elif block is not None:
                if not rest.strip():
                    raise ValueError(f"{path}:{n}: nesting deeper than one "
                                     f"mapping is not supported")
                block[key] = _value(rest)
            else:
                raise ValueError(f"{path}:{n}: indented line outside a "
                                 f"mapping")
    for k, v in out.items():
        if v == {}:
            out[k] = None
    return out


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
    time: float = 275.0              # online capture window [s] (the CLI's
                                     # ``online`` without --duration)

    # --- sensor geometry ---
    n_beams: int = 181               # beams per scan (the online engine's)
    beam0_deg: float = 0.0
    beam_step_deg: float = 1.0

    # --- ROS topics (the CLI's ``online`` over rosbridge) ---
    topic_laser: str = "/pioneer2dx/laser/scan_Lidar_horizontal"
    topic_laser_msg: str = "sensor_msgs/LaserScan"
    topic_odometry: str = "/pioneer2dx/ground_truth/odom"
    topic_odometry_msg: str = "nav_msgs/Odometry"

    # --- engine knobs ---
    sweep_mode: str = "batched"      # sequential | batched | ba | windowed_ba
    init_mode: str = "auto"          # auto | sequential | batched
    init_rounds: int = 2             # Picard rounds per chunk (batched init)
    init_chunk_len: int = 32         # frames per chunk of the batched init
    init_merge_cap: int = 0          # batched init's final merge width:
                                     # 0 = full L, -1 = map_run_cap, >0 explicit
    init_final_assoc: bool = True    # rebuild each chunk's table from the
                                     # converged poses
    init_gn_iters: int = 0           # LM iterations per batched-init solve
                                     # (0 = pose_gn_iters)
    pose_gn_iters: int = 8           # LM iterations per pose solve
    pose_passes: int = 2             # pose passes per batched sweep
    pose_update: str = "redblack"    # redblack | jacobi
    replicate_new_obs_quirk: bool = True  # ICM_SLAM.py:176 empty-slice quirk
    obs_cap: int = 0                 # beams per frame after compaction (0 = auto)
    map_run_cap: int = 256           # running-mean table width for old
                                     # landmarks (0 = full L)
    map_run_cap_checked: bool = False  # keep the cap and witness it at runtime
    ba_gn_iters: int = 4             # outer GN steps per BA refinement (and
                                     # per window solve in windowed_ba)
    ba_cg_iters: int = 12            # PCG iterations per GN step (ba)
    ba_window: int = 64              # keyframe block size (windowed_ba)
    dtype: str = "float32"
    model: Optional[Any] = None      # core.energy.EnergyModel hooks; None =
                                     # the default model

    @staticmethod
    def from_yaml(path: str, **overrides) -> "ICMConfig":
        """Load a reference-format YAML (top-level key ``D``)."""
        data = read_yaml(path)
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
