"""The collision stage's work: FK of every configuration to its spheres, one
packed-grid word (8 bytes, four to a 32-byte sector) per sphere, the hinge,
and the torques of each hinge-active sphere for d/dq."""

from __future__ import annotations

import torch

from benchmark.harness import peaks
from benchmark.reference import model as ref


def work(pb: ref.Problem, q: torch.Tensor, sigma_numel: int, grad: bool = True) -> dict:
    """Operations and bytes at configurations ``q [..., L]``:

    - bytes: the distinct 32-byte sectors of the packed grid the spheres'
      cells lie in, q and σ read once, the likelihood (and d/dq) written
      once, float32;
    - operations: per configuration 7 DH compositions (~60 each), per sphere
      its position, cell index and hinge (~30), and with ``grad`` per
      hinge-active pair the torque accumulation (~16 a joint).
    """
    L, P = pb.L, pb.P
    T = q.numel() // L
    sectors, active = 0, 0
    with torch.no_grad():
        seen = []
        for r0 in range(0, T, 65536):
            qb = q.reshape(-1, L)[r0:r0 + 65536].to(ref.F64)
            pos = ref.sphere_positions(pb, qb)
            rel = pos - pb.scene_offset
            seen.append(torch.unique(ref._cell(pb, rel) // 4))
            d = pb.packed_value[ref._cell(pb, rel)]
            active += int((float(pb.pp["epsilon"]) - (d - pb.radii) > 0).sum())
        sectors = int(torch.unique(torch.cat(seen)).numel())
    nbytes = 32 * sectors + 4 * (T * L + sigma_numel + T * (1 + (L if grad else 0)))
    flops = T * (L * 60 + P * 30) + (active * L * 16 if grad else 0)
    t = max(flops / peaks.F32_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)
    return {"bytes": nbytes, "flops": flops, "sectors": sectors, "active": active, "least_s": t}
