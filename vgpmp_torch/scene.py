"""Composed scene SDF: base environment grid + extra grids + analytic primitives.

Port of ``vgpmp_tpu/scene.py`` (``Primitives``, ``Scene``, ``SceneBuilder``,
``OBJECT_LIBRARY``). :meth:`Scene.distance` is the plain composition, on any
device; on CUDA the collision likelihood and the metric compose the same
sources inside kernels K1 and K3 (``likelihoods/collision.py``,
``csrc/scene.cuh``).

The primitives' norms are written ``sqrt(sum(v * v))``, JAX's formula, and
the box's ``max(q, 0)`` is differentiated as ``jnp.maximum``'s, so that the
gradient is NaN where JAX's is: at a sphere's centre, on a capsule's segment
and anywhere inside or on a box.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, replace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from vgpmp_torch import resolve_device
from vgpmp_torch.sdf.grid import (
    PackedSdfGrid, SdfGrid, nearest_distance, packed_nearest_distance, trilinear_distance,
)

__all__ = ["Primitives", "Scene", "SceneBuilder", "OBJECT_LIBRARY"]

_BIG = 1e9


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis as JAX's ``jnp.linalg.norm`` computes
    and differentiates it: its gradient at the zero vector is NaN."""
    return torch.sqrt((v * v).sum(dim=-1))


def _max0(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0)`` differentiated as ``jnp.maximum(x, 0.0)`` is: the upstream
    gradient times 1 where ``x > 0``, 0.5 where ``x == 0`` and 0 elsewhere. A
    product, where ``torch.clamp``'s backward selects, so a NaN upstream stays
    NaN: inside a box the norm of ``max(q, 0) = 0`` makes JAX's gradient NaN."""
    return x * ((x > 0).to(x.dtype) + 0.5 * (x == 0).to(x.dtype))


@dataclass
class Primitives:
    """Batched analytic SDF primitives in the world frame (empty batches allowed)."""

    sphere_centers: torch.Tensor  # [Ks, 3]
    sphere_radii: torch.Tensor    # [Ks]
    box_centers: torch.Tensor     # [Kb, 3]
    box_rotations: torch.Tensor   # [Kb, 3, 3] world -> box
    box_half_extents: torch.Tensor  # [Kb, 3]
    capsule_a: torch.Tensor       # [Kc, 3]
    capsule_b: torch.Tensor       # [Kc, 3]
    capsule_radii: torch.Tensor   # [Kc]

    @classmethod
    def empty(cls, dtype=torch.float32, device=None) -> "Primitives":
        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        return cls(sphere_centers=z(0, 3), sphere_radii=z(0), box_centers=z(0, 3),
                   box_rotations=z(0, 3, 3), box_half_extents=z(0, 3), capsule_a=z(0, 3),
                   capsule_b=z(0, 3), capsule_radii=z(0))

    def to(self, device=None, dtype=None) -> "Primitives":
        """The same primitives with their tensors on ``device`` in ``dtype``."""
        return Primitives(*(getattr(self, f.name).to(device, dtype) for f in fields(self)))

    def kind_distances(self, points: torch.Tensor) -> List[Tuple[str, torch.Tensor]]:
        """``[..., 3]`` -> ``[(kind, [...])]``: each non-empty kind's minimum
        signed distance, spheres, boxes, then capsules."""
        out = []
        if self.sphere_radii.shape[0]:
            d = _norm(points[..., None, :] - self.sphere_centers) - self.sphere_radii
            out.append(("spheres", d.min(dim=-1).values))
        if self.box_half_extents.shape[0]:
            local = torch.einsum("kij,...kj->...ki", self.box_rotations,
                                 points[..., None, :] - self.box_centers)
            q = torch.abs(local) - self.box_half_extents
            outside = _norm(_max0(q))
            inside = torch.clamp(q.max(dim=-1).values, max=0.0)
            out.append(("boxes", (outside + inside).min(dim=-1).values))
        if self.capsule_radii.shape[0]:
            ab = self.capsule_b - self.capsule_a
            ap = points[..., None, :] - self.capsule_a
            t = torch.clamp((ap * ab).sum(-1) / (ab * ab).sum(-1), 0.0, 1.0)
            closest = self.capsule_a + t[..., None] * ab
            d = _norm(points[..., None, :] - closest) - self.capsule_radii
            out.append(("capsules", d.min(dim=-1).values))
        return out

    def distance(self, points: torch.Tensor) -> torch.Tensor:
        """``[..., 3] -> [...]`` min signed distance over all primitives."""
        out = torch.full(points.shape[:-1], _BIG, dtype=points.dtype, device=points.device)
        for _, d in self.kind_distances(points):
            out = torch.minimum(out, d)
        return out


@dataclass
class Scene:
    """Environment grid + optional extra object grids + primitives.

    ``mode``: ``'packed'`` (bf16 fast path, set by :meth:`packed`),
    ``'nearest'`` (exact nearest cell) or ``'trilinear'``.
    """

    base: SdfGrid
    base_offset: torch.Tensor  # [3] world position of the environment mesh frame
    extra_grids: Tuple[SdfGrid, ...] = ()
    extra_offsets: Optional[torch.Tensor] = None  # [G, 3]
    primitives: Optional[Primitives] = None
    mode: str = "nearest"
    base_packed: Optional[PackedSdfGrid] = None
    extra_packed: Tuple[PackedSdfGrid, ...] = ()

    def packed(self) -> "Scene":
        """A copy with the packed tables built (host-side, once per session)."""
        return replace(
            self, mode="packed", base_packed=PackedSdfGrid.pack(self.base),
            extra_packed=tuple(PackedSdfGrid.pack(g) for g in self.extra_grids),
        )

    def sources(self, points: torch.Tensor,
                mode_override: str | None = None) -> List[Tuple[str, torch.Tensor]]:
        """Each source's signed distance at the world-frame points ``[..., 3]``,
        in the order the composition takes them: ``'base'``, ``'grid0'``, ...,
        then each non-empty primitive kind (:meth:`Primitives.kind_distances`);
        ``mode_override`` looks the grids up otherwise than ``mode``."""
        mode = self.mode if mode_override in (None, "packed") else mode_override
        if mode == "packed":
            lookup, base, grids = packed_nearest_distance, self.base_packed, self.extra_packed
        else:
            lookup = trilinear_distance if mode == "trilinear" else nearest_distance
            base, grids = self.base, self.extra_grids
        out = [("base", lookup(base, points - self.base_offset))]
        out += [(f"grid{g}", lookup(grid, points - self.extra_offsets[g])) for g, grid in enumerate(grids)]
        if self.primitives is not None:
            out += self.primitives.kind_distances(points)
        return out

    def distance(self, points: torch.Tensor, mode_override: str | None = None) -> torch.Tensor:
        """World-frame ``[..., 3] -> [...]`` composed signed distance, the
        minimum over :meth:`sources`."""
        srcs = self.sources(points, mode_override)
        d = srcs[0][1]
        for _, s in srcs[1:]:
            d = torch.minimum(d, s)
        return d


# The reference's named objects (``utils/bullet_object.py:13-19``), each as an
# analytic SDF in the object's local frame with the same nominal dimensions:
# cube 1 m, the pybullet table's top, the duck as a 0.1 m ball, the pringles
# can as a 0.23 m x 0.04 m capsule.
OBJECT_LIBRARY: Dict[str, Dict[str, Any]] = {
    "cube": {"kind": "box", "half_extents": [0.5, 0.5, 0.5]},
    "table": {"kind": "box", "half_extents": [0.75, 0.5, 0.03], "local_z": 0.625},
    "duck": {"kind": "sphere", "radius": 0.05, "local_z": 0.05},
    "pringles": {"kind": "capsule", "radius": 0.04, "height": 0.23},
}


@dataclass
class _SceneObject:
    name: str
    kind: str             # 'sphere' | 'box' | 'capsule' | 'grid'
    position: np.ndarray  # [3] world
    spec: Dict[str, Any]
    grid: Optional[SdfGrid] = None


@dataclass
class SceneBuilder:
    """Named-object scene registry (the reference's ``Scene.add_object`` /
    ``remove_object`` surface) -> :class:`Scene`.

    Objects are added, looked up and removed by name or index and moved by
    name; :meth:`build` composes the current set on ``device`` (the CUDA
    device unless the caller names another). A moved object changes only the
    built scene's pose tensors, which
    :meth:`vgpmp_torch.likelihoods.collision.CollisionModel.move_objects`
    takes without rebuilding the model.
    """

    base: SdfGrid
    base_offset: Any = (0.0, 0.0, 0.0)
    mode: str = "nearest"
    dtype: Any = torch.float32
    device: Any = None
    objects: List[_SceneObject] = field(default_factory=list)

    def add_object(self, name: str, position, grid: Optional[SdfGrid] = None,
                   spec: Optional[Dict[str, Any]] = None) -> None:
        """Add a named object at a world position: a library name
        (``OBJECT_LIBRARY``), an explicit analytic ``spec`` or a voxel ``grid``."""
        if grid is not None:
            obj = _SceneObject(name, "grid", np.asarray(position, float), {}, grid)
        else:
            s = spec if spec is not None else OBJECT_LIBRARY.get(name)
            if s is None:
                raise KeyError(
                    f"Object {name!r} not found in the object library of supported "
                    f"objects and no explicit spec/grid given; supported: "
                    f"{sorted(OBJECT_LIBRARY)}"
                )
            obj = _SceneObject(name, s["kind"], np.asarray(position, float), dict(s))
        self.objects.append(obj)

    def get_object_index_by_name(self, name: str) -> int:
        for i, o in enumerate(self.objects):
            if o.name == name:
                return i
        raise KeyError(name)

    def get_object_by_name(self, name: str) -> _SceneObject:
        return self.objects[self.get_object_index_by_name(name)]

    def get_object_by_index(self, index: int) -> _SceneObject:
        return self.objects[index]

    @property
    def names(self) -> List[str]:
        return [o.name for o in self.objects]

    def remove_object(self, name: str) -> None:
        del self.objects[self.get_object_index_by_name(name)]

    def remove_object_by_index(self, index: int) -> None:
        del self.objects[index]

    def move_object(self, name: str, position) -> None:
        self.get_object_by_name(name).position = np.asarray(position, float)

    def build(self) -> Scene:
        """The current objects composed over the base grid: spheres, boxes
        (axis-aligned, raised by ``local_z``), capsules standing on their
        position (segment ``height - 2r``, clipped at 0) and grid objects at
        their offsets; packed when ``mode`` is ``'packed'``."""
        dt, dev = self.dtype, resolve_device(self.device)
        sph_c, sph_r = [], []
        box_c, box_R, box_h = [], [], []
        cap_a, cap_b, cap_r = [], [], []
        grids, offsets = [], []
        for o in self.objects:
            p = o.position.copy()
            p[2] += float(o.spec.get("local_z", 0.0))
            if o.kind == "sphere":
                sph_c.append(p)
                sph_r.append(o.spec["radius"])
            elif o.kind == "box":
                box_c.append(p)
                box_R.append(np.eye(3))
                box_h.append(o.spec["half_extents"])
            elif o.kind == "capsule":
                h = o.spec["height"] - 2 * o.spec["radius"]
                cap_a.append(p + [0, 0, o.spec["radius"]])
                cap_b.append(p + [0, 0, o.spec["radius"] + max(h, 0.0)])
                cap_r.append(o.spec["radius"])
            elif o.kind == "grid":
                grids.append(o.grid.to(dev, dt))
                offsets.append(p)
            else:
                raise ValueError(o.kind)

        def t(x, shape):
            return torch.as_tensor(np.asarray(x, float).reshape(shape), dtype=dt, device=dev)

        prims = None
        if sph_c or box_c or cap_a:
            e = Primitives.empty(dt, dev)
            prims = Primitives(
                sphere_centers=t(sph_c, (-1, 3)) if sph_c else e.sphere_centers,
                sphere_radii=t(sph_r, (-1,)) if sph_c else e.sphere_radii,
                box_centers=t(box_c, (-1, 3)) if box_c else e.box_centers,
                box_rotations=t(box_R, (-1, 3, 3)) if box_c else e.box_rotations,
                box_half_extents=t(box_h, (-1, 3)) if box_c else e.box_half_extents,
                capsule_a=t(cap_a, (-1, 3)) if cap_a else e.capsule_a,
                capsule_b=t(cap_b, (-1, 3)) if cap_a else e.capsule_b,
                capsule_radii=t(cap_r, (-1,)) if cap_a else e.capsule_radii,
            )
        scene = Scene(
            base=self.base.to(dev, dt),
            base_offset=t(self.base_offset, (3,)),
            extra_grids=tuple(grids),
            extra_offsets=t(offsets, (-1, 3)) if grids else None,
            primitives=prims,
            mode="nearest" if self.mode == "packed" else self.mode,
        )
        return scene.packed() if self.mode == "packed" else scene
