"""Typed configuration: the reference's ``parameters.yaml`` schema.

The port's own copy of ``vgpmp_tpu/config.py`` (numpy and yaml only). A root
YAML selects the robot and the scene and gives the trainable flags; the
robot's data comes from its spec file, and the planner's hyperparameters
either from the benchmark problemset (benchmark mode) or inline under
``non_benchmark_attributes``. Graphics keys are parsed and ignored (no
simulator runs in the loop).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import yaml

__all__ = ["VgpmpConfig", "load_parameters_yaml"]


@dataclass
class VgpmpConfig:
    """Flattened, validated configuration."""

    robot_name: str
    benchmark: bool
    problemset_name: Optional[str]
    scene_position: List[float]
    scene_orientation: List[float]
    environment_name: Optional[str]
    states: Optional[np.ndarray]          # non-benchmark explicit states
    robot_pos_and_orn: Optional[Tuple[List[float], List[float]]]
    planner_params: Optional[Dict[str, Any]]
    trainable_params: Dict[str, bool] = field(default_factory=dict)
    graphics_params: Dict[str, Any] = field(default_factory=dict)

    def trainable_mask(self) -> Dict[str, bool]:
        """The reference's trainable keys mapped onto the ``PlannerParams`` leaves."""
        t = self.trainable_params
        return {
            "q_mu": bool(t.get("q_mu", True)),
            "q_sqrt": bool(t.get("q_sqrt", True)),
            "lengthscales_u": bool(t.get("lengthscales", True)),
            "variance_u": bool(t.get("kernel_variance", True)),
            "z_u": bool(t.get("inducing_variable", False)),
            "sigma_obs_u": bool(t.get("sigma_obs", False)),
            "alpha_u": bool(t.get("alpha", False)),
        }


def load_parameters_yaml(path: str | Path) -> VgpmpConfig:
    """Parse a reference-schema ``parameters.yaml``: a list of single-key
    dicts ``[- robot: {...}, - scene: {...}, - trainable_params: {...},
    - graphics: {...}]`` (a plain mapping of the same sections also parses)."""
    raw = yaml.safe_load(Path(path).read_text())
    sections: Dict[str, Any] = {}
    if isinstance(raw, list):
        for entry in raw:
            sections.update(entry)
    else:
        sections = dict(raw)

    robot = sections.get("robot", {})
    scene = sections.get("scene", {})
    trainable = sections.get("trainable_params", {}) or {}
    graphics = sections.get("graphics", {}) or {}

    benchmark = bool(scene.get("benchmark", True))
    problemset_name = None
    states = None
    pos_orn = None
    planner_params = None
    if benchmark:
        problemset_name = (scene.get("benchmark_attributes") or {}).get("problemset_name")
    else:
        nb = scene.get("non_benchmark_attributes") or {}
        states = np.asarray(nb.get("states"), dtype=np.float64)
        if nb.get("robot_pos_and_orn") is not None:
            pos, orn = nb["robot_pos_and_orn"]
            pos_orn = (list(pos), list(orn))
        planner_params = dict(nb.get("planner_params") or {})

    return VgpmpConfig(
        robot_name=robot.get("robot_name", "franka"),
        benchmark=benchmark,
        problemset_name=problemset_name,
        scene_position=list(scene.get("position", [0.0, 0.0, 0.0])),
        scene_orientation=list(scene.get("orientation", [0.0, 0.0, 0.0, 1.0])),
        environment_name=scene.get("environment_name"),
        states=states,
        robot_pos_and_orn=pos_orn,
        planner_params=planner_params,
        trainable_params=trainable,
        graphics_params=graphics,
    )
