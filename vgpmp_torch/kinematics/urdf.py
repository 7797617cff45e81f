"""Minimal URDF toolchain (port of ``vgpmp_tpu/kinematics/urdf.py``).

Reads a robot's URDF without a simulator: the collision-proxy spheres encoded
as extra ``<visual>`` shapes, in the enumeration order of the reference's
``p.getVisualShapeData`` walk, and a ground-truth forward-kinematics chain.
It runs once, offline (building a robot's sphere set for a new robot,
checking a spec against its URDF), so its FK stays numpy in float64, as the
JAX package's does; nothing here runs on the device.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "UrdfJoint",
    "UrdfLink",
    "UrdfSphere",
    "UrdfModel",
    "rpy_to_matrix",
    "pose_to_matrix",
    "axis_angle_matrix",
]


def rpy_to_matrix(rpy: Tuple[float, float, float]) -> np.ndarray:
    """URDF roll-pitch-yaw (extrinsic x-y-z) to a 3x3 rotation matrix."""
    r, p, y = rpy
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def pose_to_matrix(xyz, rpy) -> np.ndarray:
    """(xyz, rpy) origin to a 4x4 homogeneous transform."""
    T = np.eye(4)
    T[:3, :3] = rpy_to_matrix(tuple(rpy))
    T[:3, 3] = xyz
    return T


def axis_angle_matrix(axis: np.ndarray, theta: float) -> np.ndarray:
    """Rodrigues rotation about ``axis`` (unit 3-vector) by ``theta``."""
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    kx, ky, kz = axis
    K = np.array([[0, -kz, ky], [kz, 0, -kx], [-ky, kx, 0]])
    R = np.eye(3) + math.sin(theta) * K + (1.0 - math.cos(theta)) * (K @ K)
    T = np.eye(4)
    T[:3, :3] = R
    return T


def _parse_floats(s: Optional[str], default):
    if s is None:
        return np.asarray(default, dtype=np.float64)
    return np.asarray([float(v) for v in s.split()], dtype=np.float64)


@dataclass
class UrdfSphere:
    """A collision-proxy sphere attached to a link (visual-shape encoding)."""

    link: str
    radius: float
    offset: np.ndarray  # xyz in the link frame
    name: str = ""


@dataclass
class UrdfLink:
    name: str
    spheres: List[UrdfSphere] = field(default_factory=list)


@dataclass
class UrdfJoint:
    name: str
    joint_type: str  # revolute | continuous | prismatic | fixed
    parent: str
    child: str
    origin: np.ndarray  # 4x4
    axis: np.ndarray  # 3
    index: int  # document order == PyBullet link index of the child link


class UrdfModel:
    """Parsed URDF with kinematic-chain FK and sphere discovery.

    Link indices follow the PyBullet convention used by the reference
    (``robot.py:229-238``): joints are numbered in document order and the
    child link of joint *i* has link index *i*; the root link has index -1.
    """

    def __init__(self, path: str):
        root = ET.parse(path).getroot()
        self.name = root.get("name", "robot")
        self.links: Dict[str, UrdfLink] = {}
        self.joints: List[UrdfJoint] = []
        self.joint_by_name: Dict[str, UrdfJoint] = {}
        self.parent_joint_of_link: Dict[str, UrdfJoint] = {}

        for elem in root.findall("link"):
            link = UrdfLink(name=elem.get("name"))
            for vis in elem.findall("visual"):
                sph = vis.find("geometry/sphere")
                if sph is None:
                    continue
                origin = vis.find("origin")
                xyz = _parse_floats(origin.get("xyz") if origin is not None else None, [0, 0, 0])
                link.spheres.append(
                    UrdfSphere(
                        link=link.name,
                        radius=float(sph.get("radius")),
                        offset=xyz,
                        name=vis.get("name", ""),
                    )
                )
            self.links[link.name] = link

        for idx, elem in enumerate(root.findall("joint")):
            origin = elem.find("origin")
            xyz = _parse_floats(origin.get("xyz") if origin is not None else None, [0, 0, 0])
            rpy = _parse_floats(origin.get("rpy") if origin is not None else None, [0, 0, 0])
            axis = _parse_floats(
                elem.find("axis").get("xyz") if elem.find("axis") is not None else None, [1, 0, 0]
            )
            joint = UrdfJoint(
                name=elem.get("name"),
                joint_type=elem.get("type", "fixed"),
                parent=elem.find("parent").get("link"),
                child=elem.find("child").get("link"),
                origin=pose_to_matrix(xyz, rpy),
                axis=axis,
                index=idx,
            )
            self.joints.append(joint)
            self.joint_by_name[joint.name] = joint
            self.parent_joint_of_link[joint.child] = joint

        children = {j.child for j in self.joints}
        roots = [name for name in self.links if name not in children]
        if len(roots) != 1:
            raise ValueError(f"expected a single root link, found {roots}")
        self.root_link = roots[0]

    # ------------------------------------------------------------------ FK

    def link_index(self, link_name: str) -> int:
        """PyBullet-convention link index (-1 for the root link)."""
        if link_name == self.root_link:
            return -1
        return self.parent_joint_of_link[link_name].index

    def chain_to(self, link_name: str) -> List[UrdfJoint]:
        """Joints from the root down to ``link_name``, root-first."""
        chain = []
        while link_name != self.root_link:
            joint = self.parent_joint_of_link[link_name]
            chain.append(joint)
            link_name = joint.parent
        return chain[::-1]

    def link_transform(
        self,
        link_name: str,
        joint_values: Dict[str, float],
        base_pose: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """World 4x4 pose of a link frame for the given joint values.

        Unspecified movable joints default to zero. ``base_pose`` is the world
        pose of the root link (defaults to identity).
        """
        T = np.eye(4) if base_pose is None else np.asarray(base_pose, dtype=np.float64)
        for joint in self.chain_to(link_name):
            T = T @ joint.origin
            theta = joint_values.get(joint.name, 0.0)
            if joint.joint_type in ("revolute", "continuous"):
                T = T @ axis_angle_matrix(joint.axis, theta)
            elif joint.joint_type == "prismatic":
                D = np.eye(4)
                D[:3, 3] = np.asarray(joint.axis) * theta
                T = T @ D
        return T

    # ------------------------------------------------------------ spheres

    def spheres_in_link_order(self) -> List[UrdfSphere]:
        """All spheres ordered by (link index, in-link document order).

        This reproduces the enumeration order of the reference's
        ``p.getVisualShapeData`` walk (``robot.py:482-499``): the root link
        (-1) first, then links by joint index.
        """
        ordered_links = sorted(self.links.values(), key=lambda l: self.link_index(l.name))
        out: List[UrdfSphere] = []
        for link in ordered_links:
            out.extend(link.spheres)
        return out

    def sphere_world_positions(
        self, joint_values: Dict[str, float], base_pose: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """[P, 3] world positions of all spheres (validation ground truth)."""
        positions = []
        for sph in self.spheres_in_link_order():
            T = self.link_transform(sph.link, joint_values, base_pose)
            positions.append(T[:3, :3] @ sph.offset + T[:3, 3])
        return np.asarray(positions)
