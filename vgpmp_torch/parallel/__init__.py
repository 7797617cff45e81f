"""The parallel layer on ``torch.distributed`` (port of ``vgpmp_tpu/parallel``):
the ``(dp, sp)`` rank mesh, the sharded solvers and the multi-process runtime
(``vgpmp_torch.parallel.multihost``)."""

from vgpmp_torch.parallel.mesh import init_distributed, make_mesh
from vgpmp_torch.parallel.sharded import make_sharded_round_solver, make_sharded_solver, pad_problems

__all__ = ["make_mesh", "init_distributed", "make_sharded_solver", "pad_problems",
           "make_sharded_round_solver"]
