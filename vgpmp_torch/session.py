"""Planning session: problemset -> robot spec -> scene SDF -> planner model.

Port of ``vgpmp_tpu/session.py:PlanningSession``. Reads the robot, problemset
and scene files by path (:func:`vgpmp_torch.robots.asset`: the port's copy
under ``vgpmp_torch/assets/`` where it has one, else ``vgpmp_tpu/assets/``).
Runs on the CUDA device unless ``device`` says otherwise; with ``device=None``
and no CUDA device it raises. A float32 session keeps the Gram/Cholesky/solve island in float64.
"""

from __future__ import annotations

import itertools
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from vgpmp_torch import resolve_device
from vgpmp_torch.config import load_parameters_yaml
from vgpmp_torch.engine.solver import TrainConfig
from vgpmp_torch.kinematics.dh import FkModel
from vgpmp_torch.likelihoods.collision import CollisionModel
from vgpmp_torch.models.vgpmp import PlannerModel
from vgpmp_torch.robots import RobotSpec, asset, load_robot
from vgpmp_torch.scene import Primitives, Scene
from vgpmp_torch.sdf.grid import SdfGrid

__all__ = ["PlanningSession", "quat_to_rotmat", "base_pose_matrix"]


def quat_to_rotmat(q_xyzw) -> np.ndarray:
    """Quaternion (x, y, z, w) to rotation matrix."""
    x, y, z, w = (float(v) for v in q_xyzw)
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _host_or_tensor(x):
    """A tensor as it is, anything else (arrays, nested lists) as one numpy array."""
    return x if torch.is_tensor(x) else np.asarray(x)


def base_pose_matrix(position, orientation_xyzw) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = quat_to_rotmat(orientation_xyzw)
    T[:3, 3] = position
    return T


@dataclass
class PlanningSession:
    """One robot x environment planning context.

    ``sdf_mode``: ``'packed'`` (bf16 fast path), ``'nearest'`` (the
    reference's nearest cell and central-difference gradient) or
    ``'trilinear'``; on CUDA kernel K1 runs each of the three, in the
    session's ``dtype`` (float32 or float64). ``use_tuned`` applies the
    problemset's ``planner_params_tuned`` overlay; ``overrides`` go on top.
    """

    robot_name: str
    problemset_name: str
    dtype: Any = torch.float32
    sdf_mode: str = "packed"
    use_tuned: bool = True
    overrides: Dict[str, Any] = field(default_factory=dict)
    explicit: Optional[Dict[str, Any]] = None
    extra_grids: Optional[Tuple[SdfGrid, ...]] = None
    extra_offsets: Optional[Any] = None
    primitives: Optional[Primitives] = None
    device: Any = None

    @classmethod
    def from_config(cls, path, dtype: Any = torch.float32, sdf_mode: str = "packed",
                    device=None) -> "PlanningSession":
        """A session from a reference-schema ``parameters.yaml``
        (:func:`vgpmp_torch.config.load_parameters_yaml`): benchmark mode builds
        from the problemset, non-benchmark mode from the file's states, base
        pose and planner parameters. ``trainable`` is the file's mask."""
        cfg = load_parameters_yaml(path)
        if cfg.benchmark:
            sess = cls(cfg.robot_name, cfg.problemset_name, dtype=dtype, sdf_mode=sdf_mode,
                       device=device)
        else:
            pos, orn = cfg.robot_pos_and_orn or ([0, 0, 0], [0, 0, 0, 1])
            sess = cls(cfg.robot_name, cfg.environment_name, dtype=dtype, sdf_mode=sdf_mode,
                       device=device,
                       explicit=dict(states=cfg.states, robot_position=pos,
                                     robot_orientation_xyzw=orn,
                                     environment_position=cfg.scene_position,
                                     planner_params=cfg.planner_params))
        sess.trainable = cfg.trainable_mask()
        return sess

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.trainable = None  # the default benchmark mask
        self.spec: RobotSpec = load_robot(self.robot_name)
        if self.explicit is not None:
            ps = self.explicit
        else:
            problemsets = json.loads(asset("problemsets", f"{self.robot_name}.json").read_text())
            if self.problemset_name not in problemsets:
                raise KeyError(f"robot {self.robot_name!r} has no problemset "
                               f"{self.problemset_name!r}; available: {sorted(problemsets)}")
            ps = problemsets[self.problemset_name]
        self.states = np.asarray(ps["states"], dtype=np.float64)
        self.planner_params: Dict[str, Any] = dict(ps["planner_params"])
        if self.use_tuned:
            self.planner_params.update(ps.get("planner_params_tuned", {}))
        self.planner_params.update(self.overrides)
        self.base_pose = base_pose_matrix(ps["robot_position"], ps["robot_orientation_xyzw"])
        self.scene_offset = np.asarray(ps["environment_position"], dtype=np.float64)

        # degenerate problemsets (all-zero states and params) carry no model
        if int(self.planner_params.get("num_steps", 0)) == 0:
            self.sdf = self.scene = self.model = self.train_config = None
            return

        dt, dev = self.dtype, self.device
        self.sdf = SdfGrid.load(asset("scenes", f"{self.problemset_name}.npz"), dt, dev)
        fk = FkModel.from_spec(self.spec, self.base_pose, dtype=dt, device=dev)
        self.scene = Scene(
            base=self.sdf,
            base_offset=torch.as_tensor(self.scene_offset, dtype=dt, device=dev),
            extra_grids=tuple(g.to(dev, dt) for g in self.extra_grids or ()),
            extra_offsets=(torch.as_tensor(_host_or_tensor(self.extra_offsets), dtype=dt, device=dev)
                           if self.extra_offsets is not None else None),
            primitives=self.primitives.to(dev, dt) if self.primitives is not None else None,
            mode=self.sdf_mode,
        )
        if self.sdf_mode == "packed":
            self.scene = self.scene.packed()
        collision = CollisionModel(fk=fk, scene=self.scene, epsilon=float(self.planner_params["epsilon"]))
        # float32 sessions run the Gram/Cholesky/solve island in float64
        default_solve = torch.float64 if dt == torch.float32 else None
        solve_dtype = self.planner_params.get("solve_dtype", default_solve)
        pp = self.planner_params
        self.model = PlannerModel(
            collision=collision,
            ny=torch.tensor([0.0, 1.0], dtype=dt, device=dev),
            limits_low=torch.as_tensor(self.spec.limits_low, dtype=dt, device=dev),
            limits_high=torch.as_tensor(self.spec.limits_high, dtype=dt, device=dev),
            num_samples=int(pp["num_samples"]),
            num_bases=int(pp.get("num_bases", 1024)),
            num_inducing=int(pp["num_inducing"]),
            # 1e-9 rather than the reference's 1e-6: endpoint-clamp softness
            # is jitter * ||Kuu^-1 r||; the float64 island keeps 1e-9 safe
            jitter=float(pp.get("jitter", 1e-9)),
            solve_dtype=solve_dtype,
            # escalation retries exist for float32 Cholesky headroom only
            jitter_escalations=int(pp.get("jitter_escalations",
                                          0 if solve_dtype == torch.float64 else 3)),
            # the reference's fixed 0.1 bound makes the inverse transform
            # NaN for problemsets that initialise the variance at or below it
            variance_lower=float(pp.get("variance_lower", min(0.1, 0.5 * float(pp["variance"])))),
            kernel=str(pp.get("kernel", "matern52")),
            antithetic=bool(pp.get("antithetic", False)),
            velocity_constrained=bool(pp.get("velocity_constrained", False)),
        )
        self.train_config = TrainConfig(
            num_steps=int(pp["num_steps"]),
            learning_rate=float(pp["learning_rate"]),
            time_spacing_X=int(pp["time_spacing_X"]),
            time_spacing_Xnew=int(pp["time_spacing_Xnew"]),
            lr_peak=float(pp.get("lr_peak", 0.0)),
            warmup_steps=int(pp.get("warmup_steps", 10)),
            sigma_anneal=float(pp.get("sigma_anneal", 1.0)),
            randomize_timesteps=bool(pp.get("randomize_timesteps", False)),
        )

    def queries(self) -> Tuple[np.ndarray, np.ndarray]:
        """All C(n, 2) start/goal pairs: (starts ``[Q, L]``, goals ``[Q, L]``)."""
        pairs = list(itertools.combinations(range(len(self.states)), 2))
        return self.states[[a for a, _ in pairs]], self.states[[b for _, b in pairs]]

    @property
    def num_queries(self) -> int:
        n = len(self.states)
        return n * (n - 1) // 2
