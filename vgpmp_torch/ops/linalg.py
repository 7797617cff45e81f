"""Small batched linear algebra for the conditioned-Gram island (float64).

Port of ``vgpmp_tpu/ops/linalg.py``. The plain versions
(:func:`cholesky_unrolled`, :func:`solve_lower_unrolled`,
:func:`solve_upper_T_unrolled`) unroll over the matrix size exactly as the JAX
functions do, keeping their NaN-in, NaN-out behaviour on non-SPD input: a
negative pivot gives NaN through ``sqrt`` and is never clamped.

On a CUDA tensor the entry points (:func:`chol`, :func:`solve_lower`,
:func:`solve_upper_T`, :func:`cho_solve`) run kernel K2
(``csrc/k2_linalg.cu``) through ``torch.autograd.Function``s whose backward
passes call the same kernels; on a CPU tensor they run the plain versions.
K2 takes float64 and ``n <= 32``; anything else on CUDA raises.
"""

from __future__ import annotations

import torch

from vgpmp_torch import _build

__all__ = [
    "MAX_UNROLL", "KERNEL_MAX_N",
    "cholesky_unrolled", "solve_lower_unrolled", "solve_upper_T_unrolled",
    "cho_solve_unrolled", "k2_chol", "k2_trsm",
    "chol", "solve_lower", "solve_upper_T", "cho_solve",
]

MAX_UNROLL = 40   # plain path: unrolled up to here, torch.linalg beyond (CPU only)
KERNEL_MAX_N = 32  # K2: one warp per matrix row set


# ----------------------------------------------------------------- plain versions


def cholesky_unrolled(K: torch.Tensor) -> torch.Tensor:
    """Batched lower Cholesky of ``[..., n, n]`` by unrolled column updates."""
    n = K.shape[-1]
    rows = torch.arange(n, device=K.device)
    A = K
    cols = []
    for j in range(n):
        pivot = torch.sqrt(A[..., j, j])
        col = A[..., :, j] / pivot[..., None]
        col = torch.where(rows >= j, col, torch.zeros_like(col))
        cols.append(col)
        A = A - col[..., :, None] * col[..., None, :]
    return torch.stack(cols, dim=-1)


def solve_lower_unrolled(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Forward substitution: ``L X = B``; ``L [..., n, n]``, ``B [..., n, k]``."""
    n = L.shape[-1]
    rows = []
    acc = B
    for i in range(n):
        xi = acc[..., i, :] / L[..., i, i, None]
        rows.append(xi)
        acc = acc - L[..., :, i, None] * xi[..., None, :]
    return torch.stack(rows, dim=-2)


def solve_upper_T_unrolled(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Back substitution with the transpose of lower ``L``: ``Lᵀ X = B``."""
    n = L.shape[-1]
    rows = [None] * n
    acc = B
    for i in reversed(range(n)):
        xi = acc[..., i, :] / L[..., i, i, None]
        rows[i] = xi
        acc = acc - L[..., i, :, None] * xi[..., None, :]
    return torch.stack(rows, dim=-2)


def cho_solve_unrolled(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve ``(L Lᵀ) X = B`` given the lower Cholesky factor."""
    return solve_upper_T_unrolled(L, solve_lower_unrolled(L, B))


# ----------------------------------------------------------------- K2 wrappers


def _require_cuda(x: torch.Tensor, what: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what}: needs CUDA tensors, got one on {x.device}")


def k2_chol(K: torch.Tensor) -> torch.Tensor:
    """K2 Cholesky: ``K [T, n, n]`` float64 on CUDA, ``n <= 32`` -> lower ``L``."""
    _require_cuda(K, "k2_chol")
    L = _build.load().k2_chol(K)
    k2_chol.launches += 1
    return L


k2_chol.launches = 0


def k2_trsm(L: torch.Tensor, B: torch.Tensor, upper_t: bool) -> torch.Tensor:
    """K2 triangular solve: ``L X = B`` (``upper_t`` False) or ``Lᵀ X = B``
    (True), ``L [T, n, n]``, ``B [T, n, k]`` float64 on CUDA, ``n <= 32``."""
    _require_cuda(L, "k2_trsm")
    X = _build.load().k2_trsm(L, B, upper_t)
    k2_trsm.launches += 1
    return X


k2_trsm.launches = 0


class _CholFn(torch.autograd.Function):
    """K2 Cholesky with the Φ(LᵀL̄) backward (two K2 triangular solves)."""

    @staticmethod
    def forward(ctx, K):
        L = k2_chol(K)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, gL):
        (L,) = ctx.saved_tensors
        P = L.mT @ gL
        phi = 0.5 * (torch.tril(P) + torch.tril(P, -1).mT)
        Y = k2_trsm(L, phi.contiguous(), upper_t=True)                # L⁻ᵀ Φ
        S = k2_trsm(L, Y.mT.contiguous(), upper_t=True).mT            # L⁻ᵀ Φ L⁻¹
        # the unrolled factorisation reads only the lower triangle, so its
        # gradient is the symmetric one folded onto the lower triangle
        return torch.tril(S + S.mT) - torch.diag_embed(torch.diagonal(S, dim1=-2, dim2=-1))


class _TrsmFn(torch.autograd.Function):
    """K2 triangular solve; backward ``B̄ = L⁻ᵀX̄`` (or ``L⁻¹X̄``) and
    ``L̄ = −tril(B̄Xᵀ)`` (or ``−tril(XB̄ᵀ)``)."""

    @staticmethod
    def forward(ctx, L, B, upper_t):
        X = k2_trsm(L, B, upper_t)
        ctx.upper_t = upper_t
        ctx.save_for_backward(L, X)
        return X

    @staticmethod
    def backward(ctx, gX):
        L, X = ctx.saved_tensors
        gB = k2_trsm(L, gX.contiguous(), upper_t=not ctx.upper_t)
        gL = None
        if ctx.needs_input_grad[0]:
            gL = -torch.tril(X @ gB.mT if ctx.upper_t else gB @ X.mT)
        return gL, gB, None


# ----------------------------------------------------------------- entry points


def _cuda_n(L: torch.Tensor, what: str) -> int:
    n = L.shape[-1]
    if n > KERNEL_MAX_N:
        raise ValueError(f"{what}: K2 takes n <= {KERNEL_MAX_N} on CUDA, got n={n}")
    return n


def chol(K: torch.Tensor) -> torch.Tensor:
    """Batched lower Cholesky of ``[..., n, n]``."""
    if K.is_cuda:
        n = _cuda_n(K, "chol")
        return _CholFn.apply(K.reshape(-1, n, n).contiguous()).reshape(K.shape)
    if K.shape[-1] <= MAX_UNROLL:
        return cholesky_unrolled(K)
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))


def _solve(L: torch.Tensor, B: torch.Tensor, upper_t: bool) -> torch.Tensor:
    n = _cuda_n(L, "solve")
    batch = torch.broadcast_shapes(L.shape[:-2], B.shape[:-2])
    Lf = L.expand(batch + (n, n)).reshape(-1, n, n).contiguous()
    Bf = B.expand(batch + B.shape[-2:]).reshape(-1, n, B.shape[-1]).contiguous()
    return _TrsmFn.apply(Lf, Bf, upper_t).reshape(batch + B.shape[-2:])


def solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve ``L X = B`` with lower-triangular ``L``."""
    if L.is_cuda:
        return _solve(L, B, upper_t=False)
    if L.shape[-1] <= MAX_UNROLL:
        return solve_lower_unrolled(L, B)
    return torch.linalg.solve_triangular(L, B, upper=False)


def solve_upper_T(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve ``Lᵀ X = B`` given lower-triangular ``L``."""
    if L.is_cuda:
        return _solve(L, B, upper_t=True)
    if L.shape[-1] <= MAX_UNROLL:
        return solve_upper_T_unrolled(L, B)
    return torch.linalg.solve_triangular(L.mT, B, upper=True)


def cho_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve ``(L Lᵀ) X = B`` given the lower Cholesky factor."""
    return solve_upper_T(L, solve_lower(L, B))
