"""The rank grid and the multi-process runtime on ``torch.distributed``
(port of ``vgpmp_tpu/parallel/mesh.py``).

JAX lays its devices out as a ``(dp, sp)`` mesh: independent planning
problems shard over ``dp`` with no communication, and the Monte-Carlo
samples of one problem can shard over ``sp``, whose collectives carry the
likelihood mean and the best-sample selection (``models/vgpmp.py``). Here
each process is one rank with one device, and the mesh is the same grid of
ranks with a process group for each row (``sp``) and each column (``dp``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vgpmp_torch import resolve_device

__all__ = ["DP_AXIS", "SP_AXIS", "RankMesh", "rank_grid", "make_mesh", "init_distributed",
           "local_device"]

DP_AXIS = "dp"
SP_AXIS = "sp"


@dataclass(frozen=True)
class RankMesh:
    """This rank's place in the ``(dp, sp)`` grid.

    ``sp_group`` holds the ranks of this rank's dp row (they share its
    problems), ``dp_group`` the ranks with its sp index (one a slab of the
    batch), ``world`` all of them; ``dp_ranks`` and ``sp_ranks`` are their
    global ranks in grid order. In a world of one (no process group) every
    group is ``None`` and nothing communicates.
    """

    dp: int
    sp: int
    dp_index: int
    sp_index: int
    device: torch.device
    dp_ranks: Tuple[int, ...] = (0,)
    sp_ranks: Tuple[int, ...] = (0,)
    sp_group: Any = None
    dp_group: Any = None
    world: Any = None

    @property
    def shape(self) -> dict:
        return {DP_AXIS: self.dp, SP_AXIS: self.sp}


def rank_grid(world: int, num_sample_shards: int = 1) -> np.ndarray:
    """The ``[dp, sp]`` grid of rank indices: rank ``r`` at ``(r // sp, r % sp)``,
    as JAX reshapes its device list."""
    if world % num_sample_shards != 0:
        raise ValueError(f"{world} devices not divisible by num_sample_shards={num_sample_shards}")
    return np.arange(world).reshape(world // num_sample_shards, num_sample_shards)


def local_device(device=None) -> torch.device:
    """The device of this process: ``device`` if given, else the CUDA device
    of torchrun's ``LOCAL_RANK`` (raising where there is no CUDA)."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", torch.cuda.current_device())))
    return device


def make_mesh(num_sample_shards: int = 1, group=None, device=None) -> RankMesh:
    """The ``(dp, sp)`` mesh over the ranks of ``group`` (the world by
    default): ``num_sample_shards`` ranks cooperate on each problem's
    samples, the rest of the rank count is the problem-parallel axis.

    Every rank of the group must call it, in the same order as its other
    ``new_group`` calls: it makes one group per row and per column. Without
    an initialised process group the mesh is a world of one. ``device`` is
    this rank's (:func:`local_device`); the ``nccl`` backend needs a CUDA one.
    """
    device = local_device(device)
    if not dist.is_initialized():
        if group is not None:
            raise ValueError("a process group was given, but torch.distributed is not initialised")
        rank_grid(1, num_sample_shards)
        return RankMesh(1, 1, 0, 0, device)
    if dist.get_backend(group) == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend carries CUDA tensors only; this rank's device is {device}")
    ranks = dist.get_process_group_ranks(group) if group is not None else list(range(dist.get_world_size()))
    grid = np.asarray(ranks)[rank_grid(len(ranks), num_sample_shards)]
    rows = [dist.new_group(row.tolist()) for row in grid]
    cols = [dist.new_group(col.tolist()) for col in grid.T]
    dp_index, sp_index = map(int, np.argwhere(grid == dist.get_rank())[0])
    return RankMesh(
        dp=grid.shape[0], sp=grid.shape[1], dp_index=dp_index, sp_index=sp_index, device=device,
        dp_ranks=tuple(grid[:, sp_index].tolist()), sp_ranks=tuple(grid[dp_index].tolist()),
        sp_group=rows[dp_index], dp_group=cols[sp_index],
        world=group if group is not None else dist.group.WORLD)


def init_distributed(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, backend: Optional[str] = None,
                     device=None) -> None:
    """Initialise the multi-process runtime (a no-op when single-process).

    Call once at program start on every process. The arguments default to
    torchrun's environment: ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``, and ``LOCAL_RANK`` for the device (:func:`local_device`). The
    backend follows the device: ``nccl`` for a CUDA device, ``gloo`` for the
    CPU; pass ``backend="gloo"`` for ranks that share one card (NCCL refuses
    two ranks on one device; gloo carries the CUDA tensors through the host).
    """
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if num_processes is None or num_processes <= 1:
        return
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    device = local_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
