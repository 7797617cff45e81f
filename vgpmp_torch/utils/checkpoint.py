"""Checkpoint and resume of batched planner state (port of
``vgpmp_tpu/utils/checkpoint.py``, on ``torch.save``/``torch.load`` where JAX
uses orbax).

A checkpoint is one file written by ``torch.save``: a dict of CPU tensors,
numbers, strings and lists, loaded back with ``weights_only=True``.

- :func:`save_solver_state` keeps a batched ``PlannerParams`` with the problem
  id of each row and a dict of extras. The parameters go through
  :func:`vgpmp_torch.convert.params_to_numpy`, so a mapping of numpy arrays,
  such as a JAX solver state converted by ``np.asarray``, saves and restores
  the same way.
- :func:`save_train_state` keeps a :class:`~vgpmp_torch.engine.solver.TrainState`
  (parameters, Adam moments and counts, the absolute step, the training
  grid, the log-prior anchors) and, when given, the state of the
  ``torch.Generator`` that drives the run, so that a run resumed from it draws
  what an unbroken run draws.

``restore_*`` put the tensors on ``device``, the CUDA device by default.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from vgpmp_torch import resolve_device
from vgpmp_torch.convert import params_from_numpy, params_to_numpy
from vgpmp_torch.engine.solver import TrainState
from vgpmp_torch.models.vgpmp import PlannerParams

__all__ = ["save_solver_state", "restore_solver_state", "save_train_state", "restore_train_state"]

SOLVER_FORMAT = "vgpmp_torch.solver_state/1"
TRAIN_FORMAT = "vgpmp_torch.train_state/1"


def _leaves_to_cpu(params) -> Dict[str, torch.Tensor]:
    """The seven leaves as CPU tensors, from a ``PlannerParams`` or a mapping
    (or attribute object) of arrays."""
    if isinstance(params, PlannerParams):
        arrays = params_to_numpy(params)
    else:
        get = params.__getitem__ if isinstance(params, Mapping) else lambda k: getattr(params, k)
        arrays = {k: np.asarray(get(k)) for k in PlannerParams.names()}
    return {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}


def _params_on(leaves: Dict[str, torch.Tensor], device: torch.device) -> PlannerParams:
    return params_from_numpy({k: v.numpy() for k, v in leaves.items()}).map(lambda x: x.to(device))


def _load(path, fmt: str) -> dict:
    payload = torch.load(Path(path), map_location="cpu", weights_only=True)
    if payload.get("format") != fmt:
        raise ValueError(f"{path}: not a {fmt} checkpoint (format {payload.get('format')!r})")
    return payload


def save_solver_state(path, params, problem_ids, extras: Optional[Dict[str, Any]] = None) -> None:
    """Write a batched ``PlannerParams`` (or a mapping of the seven leaves as
    arrays), the problem id of each row (``[B]``, ties a row to its query so
    that a restore can re-associate warm starts after re-batching) and
    ``extras`` (tensors, numbers, strings and containers of them)."""
    torch.save({"format": SOLVER_FORMAT, "params": _leaves_to_cpu(params),
                "problem_ids": torch.from_numpy(np.array(problem_ids)),
                "extras": dict(extras or {})}, Path(path))


def restore_solver_state(path, device=None) -> Tuple[PlannerParams, np.ndarray, Dict[str, Any]]:
    """``(params on device, problem_ids, extras)`` saved by :func:`save_solver_state`."""
    payload = _load(path, SOLVER_FORMAT)
    return (_params_on(payload["params"], resolve_device(device)), payload["problem_ids"].numpy(),
            payload["extras"])


def save_train_state(path, state: TrainState, generator: Optional[torch.Generator] = None) -> None:
    """Write a mid-run ``TrainState`` and, when given, ``generator``'s state."""
    torch.save({
        "format": TRAIN_FORMAT, "params": _leaves_to_cpu(state.params),
        "mu": _leaves_to_cpu(state.mu), "nu": _leaves_to_cpu(state.nu),
        "count": state.count.cpu(), "step": int(state.step),
        "X_train": state.X_train.detach().cpu(),
        "anchors": None if state.anchors is None else [a.detach().cpu() for a in state.anchors],
        "generator_state": None if generator is None else generator.get_state(),
    }, Path(path))


def restore_train_state(path, device=None, generator: Optional[torch.Generator] = None) -> TrainState:
    """The ``TrainState`` saved by :func:`save_train_state`, on ``device``. With
    ``generator`` (on that device), its state is set to the saved one."""
    payload = _load(path, TRAIN_FORMAT)
    dev = resolve_device(device)
    if generator is not None:
        if payload["generator_state"] is None:
            raise ValueError(f"{path}: the checkpoint holds no generator state")
        generator.set_state(payload["generator_state"])
    anchors = payload["anchors"]
    return TrainState(
        params=_params_on(payload["params"], dev), mu=_params_on(payload["mu"], dev),
        nu=_params_on(payload["nu"], dev), count=payload["count"].to(dev), step=payload["step"],
        X_train=payload["X_train"].to(dev),
        anchors=None if anchors is None else tuple(a.to(dev) for a in anchors))
