"""Batched Denavit–Hartenberg forward kinematics (port of ``vgpmp_tpu/kinematics/dh.py``).

:func:`sphere_positions` is the structure-of-arrays rollout: each chain
frame's rotation and translation are carried as 12 separate tensors and the
DH constants fold in as Python floats, term for term as the JAX function
writes them. :func:`sphere_positions_frames` (4x4 products and a frame
gather) is its cross-check twin. On the card the main path never calls
either: kernel K1 runs the same chain inside the collision likelihood.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from vgpmp_torch.robots import RobotSpec

__all__ = ["FkModel", "dh_matrices", "fk_frames", "sphere_positions",
           "sphere_positions_frames", "ee_positions"]


@dataclass
class FkModel:
    """FK constants for one robot, as tensors plus their static float twins.

    ``k1_robot``/``k1_spheres`` are the same constants laid out for kernels K1
    and K3 (in the model's dtype on its device, see ``csrc/fk.cuh``).
    """

    d: torch.Tensor              # [dof]
    a: torch.Tensor              # [dof]
    alpha: torch.Tensor          # [dof]
    twist: torch.Tensor          # [dof]
    base: torch.Tensor           # [4, 4] world pose of the FK base frame
    sphere_frame: torch.Tensor   # [P] int64 index into the (dof+1) chain frames
    sphere_offsets: torch.Tensor  # [P, 3]
    sphere_radii: torch.Tensor   # [P]
    k1_robot: torch.Tensor       # [6 dof + 12]
    k1_spheres: torch.Tensor     # [P, 5]: frame, offset xyz, radius
    craig: bool
    dof: int
    dh_static: tuple
    twist_static: tuple
    base_static: tuple
    frame_slices: tuple          # ((frame, s0, s1), ...) contiguous sphere ranges
    offsets_static: tuple

    @classmethod
    def from_spec(cls, spec: RobotSpec, base_pose: np.ndarray, dtype: Any = torch.float32,
                  device=None) -> "FkModel":
        frame_global = np.asarray(spec.fk_slice[spec.sphere_frame])
        if not np.all(np.diff(frame_global) >= 0):
            raise ValueError("sphere frames must be in kinematic-chain order")
        slices = []
        for f in range(int(spec.dof) + 1):
            idx = np.nonzero(frame_global == f)[0]
            if len(idx):
                slices.append((f, int(idx[0]), int(idx[-1]) + 1))
        base_np = np.asarray(base_pose, dtype=np.float64)
        k1_robot = []
        for (d_, a_, al_), tw in zip(np.asarray(spec.dh), np.asarray(spec.twist)):
            ca, sa = float(np.cos(al_)), float(np.sin(al_))
            trans = (a_, -d_ * sa, d_ * ca) if spec.craig_dh else (a_, 0.0, d_)
            k1_robot += [ca, sa, float(tw), *trans]
        k1_robot += list(base_np[:3, :4].reshape(-1))
        k1_spheres = np.concatenate(
            [frame_global[:, None], spec.sphere_offsets, spec.sphere_radii[:, None]], axis=1)
        t = lambda x, dt=dtype: torch.as_tensor(np.asarray(x), dtype=dt, device=device)
        return cls(
            d=t(spec.dh[:, 0]), a=t(spec.dh[:, 1]), alpha=t(spec.dh[:, 2]), twist=t(spec.twist),
            base=t(base_np), sphere_frame=t(frame_global, torch.int64),
            sphere_offsets=t(spec.sphere_offsets), sphere_radii=t(spec.sphere_radii),
            k1_robot=t(k1_robot), k1_spheres=t(k1_spheres),
            craig=bool(spec.craig_dh), dof=int(spec.dof),
            dh_static=tuple((float(d_), float(a_), float(al_)) for d_, a_, al_ in np.asarray(spec.dh)),
            twist_static=tuple(float(v) for v in np.asarray(spec.twist)),
            base_static=tuple(float(v) for v in base_np.reshape(-1)),
            frame_slices=tuple(slices),
            offsets_static=tuple(tuple(float(v) for v in row) for row in np.asarray(spec.sphere_offsets)),
        )


def dh_matrices(thetas: torch.Tensor, d, a, alpha, craig: bool) -> torch.Tensor:
    """DH link transforms ``[..., dof] -> [..., dof, 4, 4]`` (twist already added)."""
    ct, st = torch.cos(thetas), torch.sin(thetas)
    ca = torch.cos(alpha).expand(ct.shape)
    sa = torch.sin(alpha).expand(ct.shape)
    a_ = a.expand(ct.shape)
    d_ = d.expand(ct.shape)
    zero = torch.zeros_like(ct)
    one = torch.ones_like(ct)
    if craig:
        rows = [ct, -st, zero, a_,
                st * ca, ct * ca, -sa, -d_ * sa,
                st * sa, ct * sa, ca, d_ * ca,
                zero, zero, zero, one]
    else:
        rows = [ct, -st * ca, st * sa, a_ * ct,
                st, ct * ca, -ct * sa, a_ * st,
                zero, sa, ca, d_,
                zero, zero, zero, one]
    flat = torch.stack(rows, dim=-1)
    return flat.reshape(flat.shape[:-1] + (4, 4))


def fk_frames(model: FkModel, thetas: torch.Tensor) -> torch.Tensor:
    """Cumulative chain ``[..., dof] -> [..., dof+1, 4, 4]``; frame 0 is the base."""
    T = dh_matrices(thetas + model.twist, model.d, model.a, model.alpha, model.craig)
    acc = model.base.expand(thetas.shape[:-1] + (4, 4))
    frames = [acc]
    for i in range(model.dof):
        acc = acc @ T[..., i, :, :]
        frames.append(acc)
    return torch.stack(frames, dim=-3)


def sphere_positions_frames(model: FkModel, thetas: torch.Tensor) -> torch.Tensor:
    """Frame-gather sphere rollout, the cross-check twin of :func:`sphere_positions`."""
    sel = fk_frames(model, thetas)[..., model.sphere_frame, :, :]  # [..., P, 4, 4]
    R = sel[..., :3, :3]
    t = sel[..., :3, 3]
    return torch.einsum("...pij,pj->...pi", R, model.sphere_offsets) + t


def ee_positions(model: FkModel, thetas: torch.Tensor) -> torch.Tensor:
    """``[..., dof] -> [..., 3]`` end-effector (last chain frame) positions."""
    T = dh_matrices(thetas + model.twist, model.d, model.a, model.alpha, model.craig)
    acc = model.base.expand(thetas.shape[:-1] + (4, 4))
    for i in range(model.dof):
        acc = acc @ T[..., i, :, :]
    return acc[..., :3, 3]


def sphere_positions(model: FkModel, thetas: torch.Tensor) -> torch.Tensor:
    """World positions of the collision spheres: ``[..., dof] -> [..., P, 3]``."""
    dt, dev = thetas.dtype, thetas.device
    ang = thetas + torch.tensor(model.twist_static, dtype=dt, device=dev)
    ct = torch.cos(ang)
    st = torch.sin(ang)
    bsh = thetas.shape[:-1]
    b = model.base_static
    const = lambda v: torch.full(bsh, v, dtype=dt, device=dev)
    R = [[const(b[4 * i + j]) for j in range(3)] for i in range(3)]
    t = [const(b[4 * i + 3]) for i in range(3)]
    offs = model.offsets_static
    parts = []

    def emit(fidx):
        for (f, s0, s1) in model.frame_slices:
            if f != fidx:
                continue
            o = torch.tensor([offs[p] for p in range(s0, s1)], dtype=dt, device=dev)
            ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
            xyz = [R[k][0][..., None] * ox + R[k][1][..., None] * oy
                   + R[k][2][..., None] * oz + t[k][..., None] for k in range(3)]
            parts.append(torch.stack(xyz, dim=-1))  # [..., s1-s0, 3]

    emit(0)
    last_frame = model.frame_slices[-1][0]
    for i in range(min(model.dof, last_frame)):
        d_, a_, al_ = model.dh_static[i]
        ca, sa = float(np.cos(al_)), float(np.sin(al_))
        c, s = ct[..., i], st[..., i]
        if model.craig:
            Tm = [[c, -s, 0.0], [s * ca, c * ca, -sa], [s * sa, c * sa, ca]]
            p = [a_, -d_ * sa, d_ * ca]
        else:
            Tm = [[c, -s * ca, s * sa], [s, c * ca, -c * sa], [0.0, sa, ca]]
            p = [a_ * c, a_ * s, d_]
        Rn = [[None] * 3 for _ in range(3)]
        tn = [None] * 3
        for ii in range(3):
            for jj in range(3):
                acc = None
                for kk in range(3):
                    e = Tm[kk][jj]
                    if isinstance(e, float) and e == 0.0:
                        continue
                    term = R[ii][kk] * e
                    acc = term if acc is None else acc + term
                Rn[ii][jj] = acc
            accp = t[ii]
            for kk in range(3):
                e = p[kk]
                if isinstance(e, float) and e == 0.0:
                    continue
                accp = accp + R[ii][kk] * e
            tn[ii] = accp
        R, t = Rn, tn
        emit(i + 1)
    return torch.cat(parts, dim=-2)
