"""Analytic SVGP posterior marginals (port of ``vgpmp_tpu/gp/posterior.py``),
in the half-whitened form ``A = L⁻¹ Kuf``:

    mean = Aᵀ L⁻¹ m
    var  = kff − Σ_m A² + Σ_k (padᵀ A)² + jitter² Σ ((L⁻ᵀA)[:C])²
"""

from __future__ import annotations

from typing import Tuple

import torch

from vgpmp_torch.ops import linalg

__all__ = ["predict_f"]


def predict_f(chol_kuu: torch.Tensor, kuf: torch.Tensor, kff_diag: torch.Tensor,
              q_mu_full: torch.Tensor, q_sqrt: torch.Tensor,
              jitter: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Marginal mean and variance at the evaluation grid.

    ``chol_kuu [..., L, Mc, Mc]``, ``kuf [..., L, Mc, N]``, ``kff_diag [..., L, N]``,
    ``q_mu_full [..., Mc, L]``, ``q_sqrt [..., L, M, M]`` ->
    (mean ``[..., N, L]``, var ``[..., N, L]``).
    """
    C = chol_kuu.shape[-1] - q_sqrt.shape[-1]
    A = linalg.solve_lower(chol_kuu, kuf)  # [..., L, Mc, N]
    m_w = linalg.solve_lower(chol_kuu, q_mu_full.transpose(-1, -2)[..., None])  # [..., L, Mc, 1]
    mean = torch.einsum("...lmn,...lm->...nl", A, m_w[..., 0])
    projq = torch.einsum("...lmk,...lmn->...lkn", torch.tril(q_sqrt), A[..., C:, :])
    extra = jitter * linalg.solve_upper_T(chol_kuu, A)[..., :C, :]
    var = (
        kff_diag
        - torch.einsum("...lmn,...lmn->...ln", A, A)
        + torch.einsum("...lkn,...lkn->...ln", projq, projq)
        + torch.einsum("...lkn,...lkn->...ln", extra, extra)
    )
    return mean, var.transpose(-1, -2)
