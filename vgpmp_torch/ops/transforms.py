"""Parameter bijectors: unconstrained optimisation space <-> constrained space.

Port of ``vgpmp_tpu/ops/transforms.py``: GPflow ``positive(lower)`` softplus,
the TFP ``Sigmoid(low, high)`` box, and the lower-triangular projection. The
transform lower bounds of ``vgpmp_tpu/models/vgpmp.py:42-45`` live here too.
"""

from __future__ import annotations

import torch

__all__ = [
    "VARIANCE_LOWER", "SIGMA_OBS_LOWER", "ALPHA_LOWER", "Z_LOW", "Z_HIGH",
    "softplus", "softplus_inverse", "positive", "positive_inverse",
    "sigmoid_box", "sigmoid_box_inverse", "lower_triangular",
]

VARIANCE_LOWER = 1e-1      # kernel variance
SIGMA_OBS_LOWER = 1e-5     # collision likelihood scale
ALPHA_LOWER = 1e-4         # likelihood weight
Z_LOW, Z_HIGH = 0.09, 0.91  # inducing-time box


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def softplus_inverse(y: torch.Tensor) -> torch.Tensor:
    # log(expm1(y)), stable for large y: y + log(-expm1(-y))
    return y + torch.log(-torch.expm1(-y))


def positive(u: torch.Tensor, lower: float = 0.0) -> torch.Tensor:
    """Unconstrained -> (lower, inf)."""
    return softplus(u) + lower


def positive_inverse(c: torch.Tensor, lower: float = 0.0) -> torch.Tensor:
    return softplus_inverse(c - lower)


def sigmoid_box(u: torch.Tensor, low, high) -> torch.Tensor:
    """Unconstrained -> (low, high) via a scaled logistic."""
    return low + (high - low) * torch.reciprocal(1.0 + torch.exp(-u))


def sigmoid_box_inverse(c: torch.Tensor, low, high) -> torch.Tensor:
    t = (c - low) / (high - low)
    return torch.log(t) - torch.log1p(-t)


def lower_triangular(u: torch.Tensor) -> torch.Tensor:
    return torch.tril(u)
