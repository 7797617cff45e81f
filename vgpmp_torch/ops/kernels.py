"""Stationary kernels over scalar time, batched per latent GP.

Port of ``vgpmp_tpu/ops/kernels.py`` (``matern52`` and
``squared_exponential``): inputs ``[..., L, A] x [..., L, B]`` with
per-latent hyperparameters ``[..., L]`` give a Gram ``[..., L, A, B]``.
"""

from __future__ import annotations

import torch

__all__ = ["matern52", "squared_exponential", "KERNELS"]

SQRT_5 = 2.2360679774997898


def _pairwise_diff(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    return x1[..., :, None] - x2[..., None, :]


def _bcast_hyp(h):
    """Per-latent hyperparameter ``[..., L]`` (or a scalar) -> ``[..., L, 1, 1]``."""
    if not torch.is_tensor(h) or h.ndim == 0:
        return h
    return h[..., None, None]


def matern52(x1, x2, lengthscales, variance) -> torch.Tensor:
    """Matérn-5/2: ``k(r) = s2 (1 + √5 r/l + 5 r²/(3 l²)) exp(-√5 r/l)``."""
    l = _bcast_hyp(lengthscales)
    s2 = _bcast_hyp(variance)
    r = torch.abs(_pairwise_diff(x1, x2)) / l
    s5r = SQRT_5 * r
    return s2 * (1.0 + s5r + (5.0 / 3.0) * r * r) * torch.exp(-s5r)


def squared_exponential(x1, x2, lengthscales, variance) -> torch.Tensor:
    l = _bcast_hyp(lengthscales)
    s2 = _bcast_hyp(variance)
    diff = _pairwise_diff(x1, x2)
    return s2 * torch.exp(-0.5 * (diff / l) ** 2)


KERNELS = {"matern52": matern52, "se": squared_exponential}
