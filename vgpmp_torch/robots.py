"""Robot specification artifacts: the port's own copy of ``vgpmp_tpu/robots.py``.

Reads the JSON specs under ``vgpmp_tpu/assets/robots/`` by path (data, not an
import of the JAX package).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

import numpy as np

__all__ = ["RobotSpec", "ASSET_DIR", "available_robots", "load_robot"]

ASSET_DIR = Path(__file__).resolve().parents[1] / "vgpmp_tpu" / "assets"


@dataclass(frozen=True)
class RobotSpec:
    """Static robot description: ``dof`` joints, ``F`` sphere-carrying FK
    frames (``len(fk_slice)``), ``P`` collision spheres."""

    name: str
    dof: int
    craig_dh: bool            # Craig/modified DH convention (franka)
    dh: np.ndarray            # [dof, 3] columns (d, a, alpha)
    twist: np.ndarray         # [dof] additive joint-angle offset
    fk_slice: np.ndarray      # [F] indices into the (dof+1)-frame FK chain
    sphere_frame: np.ndarray  # [P] index into fk_slice frames per sphere
    sphere_offsets: np.ndarray  # [P, 3] offsets in the DH frame
    sphere_radii: np.ndarray  # [P]
    joint_limits: np.ndarray  # [dof, 2] (high, low)
    velocity_limits: np.ndarray  # [dof, 2] (high, low)
    default_pose: np.ndarray  # [dof]
    meta: Dict = field(default_factory=dict)

    @property
    def num_spheres(self) -> int:
        return int(self.sphere_radii.shape[0])

    @property
    def limits_high(self) -> np.ndarray:
        return self.joint_limits[:, 0]

    @property
    def limits_low(self) -> np.ndarray:
        return self.joint_limits[:, 1]

    @classmethod
    def from_json(cls, text: str) -> "RobotSpec":
        d = json.loads(text)
        f64 = lambda k: np.asarray(d[k], dtype=np.float64)
        i32 = lambda k: np.asarray(d[k], dtype=np.int32)
        return cls(
            name=d["name"], dof=int(d["dof"]), craig_dh=bool(d["craig_dh"]),
            dh=f64("dh"), twist=f64("twist"), fk_slice=i32("fk_slice"),
            sphere_frame=i32("sphere_frame"), sphere_offsets=f64("sphere_offsets"),
            sphere_radii=f64("sphere_radii"), joint_limits=f64("joint_limits"),
            velocity_limits=f64("velocity_limits"), default_pose=f64("default_pose"),
            meta=d.get("meta", {}),
        )


def available_robots() -> List[str]:
    return sorted(p.stem for p in (ASSET_DIR / "robots").glob("*.json"))


def load_robot(name: str) -> RobotSpec:
    path = ASSET_DIR / "robots" / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no robot spec {name!r} — available: {available_robots()}")
    return RobotSpec.from_json(path.read_text())
