"""Composed scene SDF: base environment grid + extra grids + analytic primitives.

Port of ``vgpmp_tpu/scene.py`` (``Primitives``, ``Scene``). On CUDA the
collision likelihood reads the packed table inside kernel K1
(``likelihoods/collision.py``), not through :meth:`Scene.distance`. A scene
with extra grids or primitives raises on CUDA: those compose on the CPU only
for now.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

from vgpmp_torch.sdf.grid import (
    PackedSdfGrid, SdfGrid, nearest_distance, packed_nearest_distance, trilinear_distance,
)

__all__ = ["Primitives", "Scene"]

_BIG = 1e9


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

    def distance(self, points: torch.Tensor) -> torch.Tensor:
        """``[..., 3] -> [...]`` min signed distance over all primitives."""
        out = torch.full(points.shape[:-1], _BIG, dtype=points.dtype, device=points.device)
        if self.sphere_radii.shape[0]:
            d = torch.linalg.norm(points[..., None, :] - self.sphere_centers, dim=-1) - self.sphere_radii
            out = torch.minimum(out, d.min(dim=-1).values)
        if self.box_half_extents.shape[0]:
            local = torch.einsum("kij,...kj->...ki", self.box_rotations,
                                 points[..., None, :] - self.box_centers)
            q = torch.abs(local) - self.box_half_extents
            outside = torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1)
            inside = torch.clamp(q.max(dim=-1).values, max=0.0)
            out = torch.minimum(out, (outside + inside).min(dim=-1).values)
        if self.capsule_radii.shape[0]:
            ab = self.capsule_b - self.capsule_a
            ap = points[..., None, :] - self.capsule_a
            t = torch.clamp((ap * ab).sum(-1) / (ab * ab).sum(-1), 0.0, 1.0)
            closest = self.capsule_a + t[..., None] * ab
            d = torch.linalg.norm(points[..., None, :] - closest, dim=-1) - self.capsule_radii
            out = torch.minimum(out, d.min(dim=-1).values)
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

    @property
    def has_extras(self) -> bool:
        return bool(self.extra_grids) or self.primitives is not None

    def packed(self) -> "Scene":
        """A copy with the packed tables built (host-side, once per session)."""
        return replace(
            self, mode="packed", base_packed=PackedSdfGrid.pack(self.base),
            extra_packed=tuple(PackedSdfGrid.pack(g) for g in self.extra_grids),
        )

    def distance(self, points: torch.Tensor, mode_override: str | None = None) -> torch.Tensor:
        """World-frame ``[..., 3] -> [...]`` composed signed distance;
        ``mode_override`` evaluates with another lookup than ``mode``."""
        if points.is_cuda and self.has_extras:
            raise NotImplementedError(
                "scenes with extra grids or primitives run on the CPU only for now")
        mode = self.mode if mode_override in (None, "packed") else mode_override
        if mode == "packed":
            d = packed_nearest_distance(self.base_packed, points - self.base_offset)
            for g, grid in enumerate(self.extra_packed):
                d = torch.minimum(d, packed_nearest_distance(grid, points - self.extra_offsets[g]))
        else:
            lookup = trilinear_distance if mode == "trilinear" else nearest_distance
            d = lookup(self.base, points - self.base_offset)
            for g, grid in enumerate(self.extra_grids):
                d = torch.minimum(d, lookup(grid, points - self.extra_offsets[g]))
        if self.primitives is not None:
            d = torch.minimum(d, self.primitives.distance(points))
        return d
