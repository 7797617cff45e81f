"""Small batched linear algebra for the conditioned-Gram island.

Port of ``vgpmp_tpu/ops/linalg.py``. The plain versions
(:func:`cholesky_unrolled`, :func:`solve_lower_unrolled`,
:func:`solve_upper_T_unrolled`) unroll over the matrix size exactly as the JAX
functions do, keeping their NaN-in, NaN-out behaviour on non-SPD input: a
negative pivot gives NaN through ``sqrt`` and is never clamped.

On a CUDA tensor the entry points (:func:`chol`, :func:`solve_lower`,
:func:`solve_upper_T`, :func:`cho_solve`, :func:`factor_solve`) run kernel K2
(``csrc/k2_linalg.cuh``) through ``torch.autograd.Function``s whose backward
passes are K2 launches too; on a CPU tensor they run the plain versions.
K2 takes float64 (the island of a float32 session, and float64 sessions) and
float32 (a session whose ``solve_dtype`` is float32) for ``n <=``
:data:`KERNEL_MAX_N` (128): a warp's rows up to ``n = 32``, a block a matrix
above. Another dtype, or a larger ``n``, raises on CUDA before any launch.

:func:`factor_solve` is the fused pair: the factorisation and the forward
substitution of every right-hand side that shares the factor in one launch
(``k2_factor_solve``), and the whole backward pass of both in one more
(``k2_factor_solve_bwd``), where :func:`chol` followed by :func:`solve_lower`
takes two launches forward and three backward.
"""

from __future__ import annotations

import torch

from vgpmp_torch import _build

__all__ = [
    "MAX_UNROLL", "KERNEL_MAX_N", "KERNEL_DTYPES",
    "cholesky_unrolled", "solve_lower_unrolled", "solve_upper_T_unrolled",
    "cho_solve_unrolled", "factor_solve_plain", "factor_solve_bwd_plain",
    "k2_chol", "k2_trsm", "k2_factor_solve", "k2_factor_solve_bwd",
    "chol", "solve_lower", "solve_upper_T", "cho_solve", "factor_solve",
]

MAX_UNROLL = 40   # plain path: unrolled up to here, torch.linalg beyond (CPU only)
KERNEL_MAX_N = 128  # K2 (csrc/kernels.h:K2_MAX_N): what a block's shared memory holds in float64
KERNEL_DTYPES = (torch.float32, torch.float64)


def k2_work(entry: str, n: int, k: int = 0) -> tuple[int, float]:
    """What one matrix of a K2 entry must move and compute, the floor of its
    bound: ``(values, operations)``. ``entry`` is ``chol``, ``trsm``, ``pair``
    (the fused pair) or ``bwd`` (its backward); ``k`` the right-hand sides'
    columns. A triangular input (K, L, dL) is read as its lower triangle, a
    dense input (B, dX, X) once, and every output (L, X, dK, dB) written once
    in full."""
    tri, sq, nk = n * (n + 1) // 2, n * n, n * k
    return {"chol": (tri + sq, n ** 3 / 3),
            "trsm": (tri + 2 * nk, n * n * k),
            "pair": (tri + sq + 2 * nk, n ** 3 / 3 + n * n * k),
            # one substitution of k columns, the lower half of dB X^T, L^T G
            # and two substitutions of n columns
            "bwd": (2 * tri + sq + 3 * nk, 2 * n * n * k + 7 * n ** 3 / 3)}[entry]


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


def factor_solve_plain(K: torch.Tensor, B: torch.Tensor):
    """Plain version of ``k2_factor_solve``: ``(L, L⁻¹B)`` for ``K = LLᵀ``."""
    L = cholesky_unrolled(K)
    return L, solve_lower_unrolled(L, B)


def _fold_lower(S: torch.Tensor) -> torch.Tensor:
    """The gradient ``S`` of a symmetric matrix, folded onto the lower triangle:
    the unrolled factorisation reads only that triangle."""
    return torch.tril(S + S.mT) - torch.diag_embed(torch.diagonal(S, dim1=-2, dim2=-1))


def factor_solve_bwd_plain(L: torch.Tensor, X: torch.Tensor, gL: torch.Tensor, gX: torch.Tensor):
    """Plain version of ``k2_factor_solve_bwd``: the gradients ``(K̄, B̄)`` of
    ``(L, X) = factor_solve_plain(K, B)`` from ``(L̄, X̄)``.

    ``B̄ = L⁻ᵀX̄``; the solve adds ``−tril(B̄Xᵀ)`` to ``L̄``; then
    ``K̄ = L⁻ᵀ Φ L⁻¹`` with ``Φ`` the symmetrised lower triangle of ``LᵀL̄``
    (diagonal halved), folded onto the lower triangle.
    """
    gB = solve_upper_T_unrolled(L, gX)
    G = torch.tril(gL) - torch.tril(gB @ X.mT)
    P = L.mT @ G
    phi = 0.5 * (torch.tril(P) + torch.tril(P, -1).mT)
    S = solve_upper_T_unrolled(L, solve_upper_T_unrolled(L, phi).mT).mT  # L⁻ᵀ Φ L⁻¹
    return _fold_lower(S), gB


# ----------------------------------------------------------------- K2 wrappers


def _k2_checks(what: str, K: torch.Tensor, *others: torch.Tensor) -> None:
    """What K2 takes, checked before a launch: CUDA tensors of one dtype,
    float32 or float64, and square matrices ``[T, n, n]`` with ``n <=``
    :data:`KERNEL_MAX_N` (a failing check inside the extension can take the
    process down)."""
    if not K.is_cuda:
        raise ValueError(f"{what}: needs CUDA tensors, got one on {K.device}")
    if K.ndim != 3 or K.shape[1] != K.shape[2]:
        raise ValueError(f"{what}: needs square matrices [T, n, n], got {tuple(K.shape)}")
    _cuda_n(K, what, *others)


def _count(fn, x: torch.Tensor) -> None:
    """One launch of the K2 wrapper ``fn``, in all and by dtype."""
    fn.launches += 1
    key = str(x.dtype).removeprefix("torch.")
    fn.launches_by[key] = fn.launches_by.get(key, 0) + 1


def k2_chol(K: torch.Tensor) -> torch.Tensor:
    """K2 Cholesky: ``K [T, n, n]`` float32 or float64 on CUDA, ``n <= 128``
    -> lower ``L`` (NaN from a non-positive pivot on, in that matrix only)."""
    _k2_checks("k2_chol", K)
    L = _build.load().k2_chol(K)
    _count(k2_chol, K)
    return L


def k2_trsm(L: torch.Tensor, B: torch.Tensor, upper_t: bool) -> torch.Tensor:
    """K2 triangular solve: ``L X = B`` (``upper_t`` False) or ``Lᵀ X = B``
    (True), ``L [T, n, n]``, ``B [T, n, k]`` float32 or float64 on CUDA,
    ``n <= 128``."""
    _k2_checks("k2_trsm", L, B)
    X = _build.load().k2_trsm(L, B, upper_t)
    _count(k2_trsm, L)
    return X


def k2_factor_solve(K: torch.Tensor, B: torch.Tensor):
    """K2 fused pair, forward: ``K [T, n, n]``, ``B [T, n, k]`` float32 or
    float64 on CUDA, ``n <= 128`` -> ``(L, X = L⁻¹B)`` in one launch."""
    _k2_checks("k2_factor_solve", K, B)
    L, X = _build.load().k2_factor_solve(K, B)
    _count(k2_factor_solve, K)
    return L, X


def k2_factor_solve_bwd(L: torch.Tensor, X: torch.Tensor, gL: torch.Tensor, gX: torch.Tensor):
    """K2 fused pair, backward: ``(L, X, L̄, X̄) -> (K̄, B̄)`` in one launch, as
    :func:`factor_solve_bwd_plain`."""
    _k2_checks("k2_factor_solve_bwd", L, X, gL, gX)
    gK, gB = _build.load().k2_factor_solve_bwd(L, X, gL, gX)
    _count(k2_factor_solve_bwd, L)
    return gK, gB


for _fn in (k2_chol, k2_trsm, k2_factor_solve, k2_factor_solve_bwd):
    _fn.launches, _fn.launches_by = 0, {}
del _fn


class _FactorSolveFn(torch.autograd.Function):
    """The fused pair: one K2 launch forward, one backward."""

    @staticmethod
    def forward(ctx, K, B):
        L, X = k2_factor_solve(K, B)
        ctx.save_for_backward(L, X)
        return L, X

    @staticmethod
    def backward(ctx, gL, gX):
        L, X = ctx.saved_tensors
        return k2_factor_solve_bwd(L, X, gL.contiguous(), gX.contiguous())


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
        return _fold_lower(S)


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


def _cuda_n(L: torch.Tensor, what: str, *others: torch.Tensor) -> int:
    """The matrices' size, checked against K2's envelope before any launch
    (a failing check inside the extension can take the process down)."""
    n = L.shape[-1]
    if n > KERNEL_MAX_N:
        raise ValueError(f"{what}: K2 takes n <= {KERNEL_MAX_N} on CUDA (the most a block's shared "
                         f"memory holds in float64), got n={n}")
    for x in (L, *others):
        if x.dtype not in KERNEL_DTYPES or x.dtype != L.dtype:
            raise TypeError(f"{what}: K2 takes float32 or float64 tensors of one dtype on CUDA, got "
                            f"{L.dtype} and {x.dtype}")
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
    n = _cuda_n(L, "solve", B)
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


def factor_solve(K: torch.Tensor, B: torch.Tensor):
    """``(L, X)`` with ``K = LLᵀ`` and ``LX = B``: ``K [..., n, n]``,
    ``B [..., n, k]`` with the same leading axes. On CUDA one fused K2 launch;
    on the CPU :func:`chol` then :func:`solve_lower`."""
    if K.is_cuda:
        n = _cuda_n(K, "factor_solve", B)
        if B.shape[:-1] != K.shape[:-1]:
            raise ValueError(f"factor_solve: B {tuple(B.shape)} does not match K {tuple(K.shape)}")
        L, X = _FactorSolveFn.apply(K.reshape(-1, n, n).contiguous(),
                                    B.reshape(-1, n, B.shape[-1]).contiguous())
        return L.reshape(K.shape), X.reshape(B.shape)
    L = chol(K)
    return L, solve_lower(L, B)
