"""Carry planner state between the JAX package and the port as numpy arrays."""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from vgpmp_torch.engine.validator import ValidationReport
from vgpmp_torch.models.vgpmp import PlannerParams

__all__ = ["params_from_numpy", "params_to_numpy", "report_from_numpy", "report_to_numpy"]


def params_from_numpy(d: Any) -> PlannerParams:
    """``PlannerParams`` from a mapping (or an object with attributes) of the
    seven leaves as arrays, e.g. a JAX ``PlannerParams`` converted by
    ``np.asarray``; shapes and dtypes are kept as given, on the CPU."""
    get = d.__getitem__ if isinstance(d, Mapping) else lambda k: getattr(d, k)
    return PlannerParams(**{
        k: torch.as_tensor(np.array(get(k)))
        for k in PlannerParams.names()
    })


def params_to_numpy(p: PlannerParams) -> dict:
    """The seven leaves as numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in p.leaves().items()}


def report_from_numpy(d: Any) -> ValidationReport:
    """``ValidationReport`` from a mapping (or an object with attributes, e.g.
    the JAX ``ValidationReport``) of its fields as arrays; ``None`` fields
    stay ``None``."""
    get = d.__getitem__ if isinstance(d, Mapping) else lambda k: getattr(d, k)
    return ValidationReport(**{
        k: None if get(k) is None else torch.as_tensor(np.array(get(k)))
        for k in ValidationReport._fields
    })


def report_to_numpy(r: ValidationReport) -> dict:
    """The report's fields as numpy arrays (``None`` where a field is unset)."""
    return {k: None if v is None else v.detach().cpu().numpy() for k, v in r._asdict().items()}
