"""Conditioned prior KL divergence (port of ``vgpmp_tpu/gp/kl.py``).

Batched over leading axes: one KL per problem.
"""

from __future__ import annotations

import torch

from vgpmp_torch.ops import linalg

__all__ = ["gauss_kl_white", "prior_kl", "prior_kl_whitened"]


def gauss_kl_white(q_mu: torch.Tensor, q_sqrt: torch.Tensor) -> torch.Tensor:
    """KL( N(q_mu, q_sqrt q_sqrtᵀ) || N(0, I) ), summed over latents.

    ``q_mu [..., M, L]``, ``q_sqrt [..., L, M, M]`` -> ``[...]``.
    """
    tril = torch.tril(q_sqrt)
    mahal = (q_mu * q_mu).sum(dim=(-2, -1))
    trace = (tril * tril).sum(dim=(-3, -2, -1))
    diag = torch.abs(torch.diagonal(tril, dim1=-2, dim2=-1))
    logdet = 2.0 * torch.log(diag).sum(dim=(-2, -1))
    const = q_mu.shape[-2] * q_mu.shape[-1]
    return 0.5 * (mahal + trace - const - logdet)


def prior_kl(kuu: torch.Tensor, chol_kuu: torch.Tensor, q_mu: torch.Tensor,
             q_sqrt: torch.Tensor, query_states: torch.Tensor) -> torch.Tensor:
    """Conditioned prior KL.

    ``kuu``/``chol_kuu [..., L, Mc, Mc]``, ``q_mu [..., M, L]``,
    ``q_sqrt [..., L, M, M]``, ``query_states [..., C, L]`` -> ``[...]``.
    """
    C = query_states.shape[-2]
    q_t = query_states.transpose(-1, -2)[..., None]  # [..., L, C, 1]
    p_mu = kuu[..., :C] @ linalg.cho_solve(chol_kuu[..., :C, :C], q_t)
    q_mu_full = torch.cat([query_states, q_mu], dim=-2)  # [..., Mc, L]
    diff = q_mu_full.transpose(-1, -2)[..., None] - p_mu  # [..., L, Mc, 1]
    whitened = linalg.solve_lower(chol_kuu, diff)[..., C:, 0].transpose(-1, -2)  # [..., M, L]
    return gauss_kl_white(whitened, q_sqrt)


def prior_kl_whitened(m_w: torch.Tensor, q_sqrt: torch.Tensor) -> torch.Tensor:
    """:func:`prior_kl` from the whitened full mean ``m_w = L⁻¹ q_mu_fullᵀ
    [..., L, Mc, 1]`` with ``q_mu_full = [query_states; q_mu]``.

    With ``Kuu = LLᵀ``, ``L⁻¹ Kuu[:, :C] = Lᵀ[:, :C]``, whose rows below ``C``
    are zero, so ``L⁻¹ p_mu`` vanishes below row ``C`` and the whitened
    difference of :func:`prior_kl` is rows ``C:`` of ``m_w``. ``q_mu_full``
    does not depend on the factor, so it can be solved beside every other
    right-hand side that shares it.
    """
    C = m_w.shape[-2] - q_sqrt.shape[-1]
    return gauss_kl_white(m_w[..., C:, 0].transpose(-1, -2), q_sqrt)
