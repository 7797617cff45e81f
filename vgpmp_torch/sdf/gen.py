"""Mesh -> signed-distance grid (port of ``vgpmp_tpu/sdf/gen.py``).

- :func:`load_obj`: a Wavefront ``.obj`` triangle soup with its piece ids;
- :func:`mesh_to_sdf`: the grid's sizing (``delta = max_extent / dim``
  unless given, ``padding`` cells on every side, in float64 numpy as the JAX
  package sizes it), then the voxelization on the device: kernel K5
  (``csrc/k5_mesh_sdf.cuh``) on CUDA, :func:`sdf_grid_plain` on the CPU;
- :func:`sdf_grid_plain`: the plain PyTorch version, a copy of
  ``vgpmp_tpu/sdf/_numpy_sdf.py:sdf_grid_numpy`` vectorised per triangle over
  the cells of a slab of x-planes, slab by slab, so that a grid of tens of
  millions of cells fits on the card.

The magnitude is the exact point-to-triangle distance; the sign is the
parity, per piece, of the +x ray's hits beyond the cell (a cell is inside the
union if it is inside any piece), as the JAX package's voxelizers compute it.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np
import torch

from vgpmp_torch import _build, resolve_device

__all__ = ["load_obj", "mesh_to_sdf", "grid_dims", "sdf_grid", "sdf_grid_plain", "k5_mesh_sdf"]

CHUNK = 1 << 21  # cells of the plain version's slab


def load_obj(path) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse a Wavefront .obj triangle soup.

    Returns ``(verts [V,3] float64, tris [T,3] int32, piece [T] int32)`` where
    ``piece`` is the object-group id per triangle (``o ...`` / ``g ...``
    lines). Faces with >3 vertices are fan-triangulated; negative indices are
    resolved relative to the current vertex count.
    """
    verts: List[List[float]] = []
    tris: List[List[int]] = []
    piece: List[int] = []
    current_piece = 0
    seen_object = False
    for line in Path(path).read_text().splitlines():
        if line.startswith("v "):
            parts = line.split()
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif line.startswith(("o ", "g ")):
            if seen_object:
                current_piece += 1
            seen_object = True
        elif line.startswith("f "):
            idx = []
            for tok in line.split()[1:]:
                i = int(tok.split("/")[0])
                idx.append(i - 1 if i > 0 else len(verts) + i)
            for k in range(1, len(idx) - 1):
                tris.append([idx[0], idx[k], idx[k + 1]])
                piece.append(current_piece)
    return (
        np.asarray(verts, dtype=np.float64),
        np.asarray(tris, dtype=np.int32),
        np.asarray(piece, dtype=np.int32),
    )


def grid_dims(verts, delta: float | None = None, dim: int = 100, padding: int = 30):
    """The grid of a mesh: ``(origin [3] float64, delta, dims [3])``, sized as
    the JAX package sizes it (``delta = max_extent / dim`` unless given,
    ``ceil(extent / delta) + 1 + 2 padding`` cells an axis)."""
    verts = np.asarray(verts, dtype=np.float64)
    lo = verts.min(axis=0)
    extent = verts.max(axis=0) - lo
    if delta is None:
        delta = float(extent.max()) / dim
    dims = np.ceil(extent / delta).astype(int) + 1 + 2 * padding
    return lo - padding * delta, float(delta), tuple(int(d) for d in dims)


def _point_tri_dist2(p: torch.Tensor, a, b, c) -> torch.Tensor:
    """Squared distance from points ``p [N,3]`` to one triangle (a, b, c).
    The dot products are elementwise sums (no BLAS call, whose threads crowd
    a busy host)."""
    ab, ac = b - a, c - a
    ap = p - a
    d1 = (ap * ab).sum(1)
    d2 = (ap * ac).sum(1)
    bp = p - b
    d3 = (bp * ab).sum(1)
    d4 = (bp * ac).sum(1)
    cp = p - c
    d5 = (cp * ab).sum(1)
    d6 = (cp * ac).sum(1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    # region masks (Ericson 5.1.5)
    m_a = (d1 <= 0) & (d2 <= 0)
    m_b = (d3 >= 0) & (d4 <= d3)
    m_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    m_c = (d6 >= 0) & (d5 <= d6)
    m_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    m_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    v_ab = torch.nan_to_num(d1 / (d1 - d3))
    w_ac = torch.nan_to_num(d2 / (d2 - d6))
    w_bc = torch.nan_to_num((d4 - d3) / ((d4 - d3) + (d5 - d6)))
    denom = va + vb + vc
    v_in = torch.nan_to_num(vb / denom)
    w_in = torch.nan_to_num(vc / denom)

    q = a + torch.outer(v_in, ab) + torch.outer(w_in, ac)  # interior default
    q = torch.where(m_bc[:, None], b + torch.outer(w_bc, c - b), q)
    q = torch.where(m_ac[:, None], a + torch.outer(w_ac, ac), q)
    q = torch.where(m_ab[:, None], a + torch.outer(v_ab, ab), q)
    q = torch.where(m_c[:, None], c, q)
    q = torch.where(m_b[:, None], b, q)
    q = torch.where(m_a[:, None], a, q)
    d = p - q
    return (d * d).sum(1)


def sdf_grid_plain(verts: torch.Tensor, tris: torch.Tensor, piece: torch.Tensor, origin: Sequence[float],
                   delta: float, dims: Sequence[int], chunk: int = CHUNK) -> torch.Tensor:
    """Plain version of K5 on ``verts``' device: ``[nx, ny, nz]`` float32,
    float64 inside, a slab of at most ``chunk`` cells at a time."""
    nx, ny, nz = (int(v) for v in dims)
    ox, oy, oz = (float(o) for o in origin)
    f64 = dict(dtype=torch.float64, device=verts.device)
    V = verts.to(torch.float64)
    tris, piece = tris.long(), piece.long()
    A, B, C = V[tris[:, 0]], V[tris[:, 1]], V[tris[:, 2]]
    xs = ox + delta * torch.arange(nx, **f64)
    ys = oy + delta * torch.arange(ny, **f64)
    zs = oz + delta * torch.arange(nz, **f64)

    # the +x ray of every column against every triangle, once: per piece, the
    # triangles with a usable yz determinant, each with its hit mask and x
    eps = delta * 1e-4
    Y, Z = torch.meshgrid(ys + eps, zs + 0.7 * eps, indexing="ij")  # [ny, nz]
    d1, d2 = B - A, C - A
    det = d1[:, 1] * d2[:, 2] - d1[:, 2] * d2[:, 1]
    ok = (det.abs() > 1e-14).tolist()
    n_pieces = int(piece.max()) + 1 if len(piece) else 1
    rays = []
    for pc in range(n_pieces):
        hits = []
        for t in torch.nonzero(piece == pc).flatten().tolist():
            if not ok[t]:
                continue
            py = Y - A[t, 1]
            pz = Z - A[t, 2]
            u = (py * d2[t, 2] - pz * d2[t, 1]) / det[t]
            v = (d1[t, 1] * pz - d1[t, 2] * py) / det[t]
            hit = (u >= 0) & (v >= 0) & (u + v <= 1)
            hits.append((hit, A[t, 0] + u * d1[t, 0] + v * d2[t, 0]))
        rays.append(hits)

    out = torch.empty(nx, ny, nz, dtype=torch.float32, device=verts.device)
    step = max(1, chunk // (ny * nz))
    for x0 in range(0, nx, step):
        xsl = xs[x0:x0 + step]
        P = torch.stack(torch.meshgrid(xsl, ys, zs, indexing="ij"), dim=-1).reshape(-1, 3)
        best = torch.full((P.shape[0],), float("inf"), **f64)
        for t in range(len(tris)):
            best = torch.minimum(best, _point_tri_dist2(P, A[t], B[t], C[t]))
        dist = torch.sqrt(best).reshape(len(xsl), ny, nz)
        # sign: per-piece parity of +x ray hits beyond each cell
        inside = torch.zeros(len(xsl), ny, nz, dtype=torch.bool, device=verts.device)
        for hits in rays:
            parity = torch.zeros_like(inside)
            for hit, hx in hits:
                parity ^= hit[None] & (hx[None] > xsl[:, None, None])
            inside |= parity
        out[x0:x0 + step] = torch.where(inside, -dist, dist).to(torch.float32)
    return out


def k5_mesh_sdf(verts: torch.Tensor, tris: torch.Tensor, piece: torch.Tensor, origin: Sequence[float],
                delta: float, dims: Sequence[int]) -> torch.Tensor:
    """K5 launch on CUDA tensors: ``verts [V, 3]``, ``tris [T, 3]`` (T >= 1),
    ``piece [T]`` -> ``[nx, ny, nz]`` float32. The triangles go to the kernel
    as their vertices in float64, sorted by piece (stable)."""
    if not verts.is_cuda:
        raise ValueError(f"k5_mesh_sdf: needs CUDA tensors, got the vertices on {verts.device}")
    if tris.ndim != 2 or tris.shape[1] != 3 or tris.shape[0] < 1 or piece.shape != tris.shape[:1]:
        raise ValueError(f"k5_mesh_sdf: tris must be [T, 3] with T >= 1 and piece [T], got "
                         f"{tuple(tris.shape)} and {tuple(piece.shape)}")
    dims = [int(d) for d in dims]
    if len(dims) != 3 or min(dims) < 1 or max(dims) >= 2 ** 31 or len(origin) != 3:
        raise ValueError(f"k5_mesh_sdf: origin [3] and dims [3] in [1, 2^31), got {origin} and {dims}")
    piece, order = torch.sort(piece.to(torch.int32), stable=True)
    tri = verts.to(torch.float64)[tris.long()[order]].reshape(-1, 9).contiguous()
    out = _build.load().k5_mesh_sdf(tri, piece.contiguous(), [float(o) for o in origin], float(delta), dims)
    k5_mesh_sdf.launches += 1
    return out


k5_mesh_sdf.launches = 0


def sdf_grid(verts: torch.Tensor, tris: torch.Tensor, piece: torch.Tensor, origin: Sequence[float],
             delta: float, dims: Sequence[int]) -> torch.Tensor:
    """The grid on ``verts``' device: K5 on CUDA, the plain version on the CPU."""
    if verts.is_cuda:
        return k5_mesh_sdf(verts, tris, piece, origin, delta, dims)
    return sdf_grid_plain(verts, tris, piece, origin, delta, dims)


def mesh_to_sdf(
    verts: np.ndarray,
    tris: np.ndarray,
    piece: np.ndarray,
    delta: float | None = None,
    dim: int = 100,
    padding: int = 30,
    device=None,
) -> Tuple[torch.Tensor, np.ndarray, float]:
    """Voxelize a triangle soup into a signed-distance grid.

    Returns ``(data [nx,ny,nz] float32 on the device, origin [3] float64,
    delta)``, sized as :func:`grid_dims` says. Runs on the CUDA device (K5)
    unless ``device`` names another; on the CPU the plain version runs.
    """
    dev = resolve_device(device)
    origin, delta, dims = grid_dims(verts, delta, dim, padding)
    t = lambda x, dt: torch.as_tensor(np.asarray(x), dtype=dt, device=dev)
    data = sdf_grid(t(verts, torch.float64), t(tris, torch.int64), t(piece, torch.int32), origin, delta, dims)
    return data, origin, delta
