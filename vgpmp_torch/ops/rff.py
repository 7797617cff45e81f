"""The prior's sample paths at a set of points from random Fourier features:
``Φ(x) w``, ``Φ(x)[..., a, b] = scale · cos(ω_b x_a + φ_b)`` (``-ω_b sin(ω_b x_a
+ φ_b)`` on a derivative row, ``gp/velocity.py``), contracted with the basis
weights ``w``.

On a CUDA tensor :func:`prior_paths` runs kernel K6 (``csrc/k6_rff.cuh``)
through a ``torch.autograd.Function`` whose backward is a K6 launch too: the
features are never stored, forward or backward. On a CPU tensor it runs the
plain version, :func:`prior_paths_plain` (:func:`rff_features`, the scale
and an ``einsum``), which is also what the tests hold K6 to. K6 takes float32
and float64; another dtype, or mixed dtypes, raise on CUDA before any launch.
Gradients reach ``x``, ``omega`` and ``scale``; the phase and ``w`` are noise
and get none (a phase or ``w`` that requires a gradient raises on CUDA).
"""

from __future__ import annotations

from typing import Optional

import torch

from vgpmp_torch import _build

__all__ = ["KERNEL_DTYPES", "rff_features", "prior_paths_plain", "k6_rff", "k6_rff_bwd", "prior_paths"]

KERNEL_DTYPES = (torch.float32, torch.float64)


def rff_features(x: torch.Tensor, omega: torch.Tensor, phase: torch.Tensor,
                 deriv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """cos features: ``x [..., L, A], omega/phase [..., L, B] -> [..., L, A, B]``.

    Rows flagged by ``deriv_mask [A]`` are derivative observations, whose
    feature is ``d/dx cos(ωx + φ) = -ω sin(ωx + φ)`` (the velocity-constrained
    inducing set, ``gp/velocity.py``)."""
    arg = x[..., :, None] * omega[..., None, :] + phase[..., None, :]
    cos = torch.cos(arg)
    if deriv_mask is None:
        return cos
    return torch.where(deriv_mask[:, None], -omega[..., None, :] * torch.sin(arg), cos)


def prior_paths_plain(x: torch.Tensor, omega: torch.Tensor, phase: torch.Tensor, scale: torch.Tensor,
                      w: torch.Tensor, deriv_mask: Optional[torch.Tensor] = None,
                      x_const: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K6 (:func:`prior_paths`' arguments): the features,
    their scale and an ``einsum``, the points ``x_const`` appended to ``x``.
    ``k6_rff.plain_on_card`` counts its calls on CUDA tensors."""
    if x.is_cuda:
        k6_rff.plain_on_card += 1
    if x_const is not None:
        x = torch.cat([x, x_const.expand(x.shape[:-1] + x_const.shape[-1:])], dim=-1)
        if deriv_mask is not None:
            deriv_mask = torch.cat([deriv_mask, deriv_mask.new_zeros(x_const.shape[-1])])
    phi = rff_features(x, omega, phase, deriv_mask) * scale[..., None]
    return torch.einsum("...lab,...slb->...sla", phi, w)


def _count(entry: str, x: torch.Tensor) -> None:
    k6_rff.launches += 1
    key = (entry, str(x.dtype).removeprefix("torch."))
    k6_rff.launches_by[key] = k6_rff.launches_by.get(key, 0) + 1


def k6_rff(x, omega, phase, scale, w, flags: Optional[torch.Tensor]) -> torch.Tensor:
    """K6 launch, forward: ``x [P, A]``, ``omega``/``phase [P, nb]``, ``scale
    [P]``, ``w [R, S, L, nb]`` with ``P = R L``, contiguous CUDA tensors of one
    dtype, float32 or float64; ``flags [A]`` uint8 (the derivative rows) or
    None -> ``[R, S, L, A]``. ``launches`` counts every K6 launch, and
    ``launches_by`` those of each (entry, dtype), entry ``forward`` or
    ``backward``."""
    _checks("k6_rff", x, omega, phase, scale, w)
    out = _build.load().k6_rff(x, omega, phase, scale, w, _flags(flags, x))
    _count("forward", x)
    return out


def k6_rff_bwd(g, x, omega, phase, scale, w, flags: Optional[torch.Tensor], n_dx: int):
    """K6 launch, backward: ``g [R, S, L, A]``, the gradient of the forward's
    output, and its inputs -> ``(d omega [P, nb], d scale [P], d x [P, n_dx])``
    (``d x`` of the first ``n_dx`` points)."""
    _checks("k6_rff_bwd", x, omega, phase, scale, w, g)
    d_omega, d_scale, d_x = _build.load().k6_rff_bwd(g, x, omega, phase, scale, w, _flags(flags, x), n_dx)
    _count("backward", x)
    return d_omega, d_scale, d_x


k6_rff.launches = 0
k6_rff.launches_by = {}
k6_rff.plain_on_card = 0


def _checks(what: str, *ts: torch.Tensor) -> None:
    """K6 takes CUDA tensors of one dtype, float32 or float64, checked before
    any launch (a failing check inside the extension can take the process
    down)."""
    if not ts[0].is_cuda:
        raise ValueError(f"{what}: needs CUDA tensors, got one on {ts[0].device}")
    for t in ts:
        if t.dtype not in KERNEL_DTYPES or t.dtype != ts[0].dtype:
            raise TypeError(f"{what}: K6 takes float32 or float64 tensors of one dtype, got "
                            f"{ts[0].dtype} and {t.dtype}")


def _flags(flags: Optional[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return flags if flags is not None else torch.empty(0, dtype=torch.uint8, device=x.device)


class _K6Fn(torch.autograd.Function):
    """K6 forward and backward. ``xg [P, Ag]`` are the points that may take
    a gradient, ``xn [P, An]`` (or None) points that take none, appended."""

    @staticmethod
    def forward(ctx, xg, xn, omega, phase, scale, w, flags):
        x = xg if xn is None else torch.cat([xg, xn], dim=-1)
        ctx.save_for_backward(x, omega, phase, scale, w)
        ctx.flags, ctx.n_dx = flags, xg.shape[-1]
        return k6_rff(x, omega, phase, scale, w, flags)

    @staticmethod
    def backward(ctx, g):
        x, omega, phase, scale, w = ctx.saved_tensors
        n_dx = ctx.n_dx if ctx.needs_input_grad[0] else 0
        d_omega, d_scale, d_x = k6_rff_bwd(g.contiguous(), x, omega, phase, scale, w, ctx.flags, n_dx)
        return d_x if n_dx else None, None, d_omega, None, d_scale, None, None


def prior_paths(x: torch.Tensor, omega: torch.Tensor, phase: torch.Tensor, scale: torch.Tensor,
                w: torch.Tensor, deriv_mask: Optional[torch.Tensor] = None,
                x_const: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The prior's sample paths ``Φ(x) w`` at ``x [..., L, A]``: ``omega``/``phase
    [..., L, B]``, ``scale [..., L, 1]``, ``w [..., S, L, B]`` -> ``[..., S,
    L, A]``; ``deriv_mask [A]`` flags derivative rows. ``x_const [..., L, N]``,
    points that take no gradient (the time grid), are appended: ``[..., S,
    L, A + N]`` from one launch. K6 on CUDA, :func:`prior_paths_plain` on the
    CPU."""
    if not x.is_cuda:
        return prior_paths_plain(x, omega, phase, scale, w, deriv_mask, x_const)
    batch, (L, nb), S = omega.shape[:-2], omega.shape[-2:], w.shape[-3]
    if phase.requires_grad or w.requires_grad:
        raise ValueError("prior_paths: K6 gives the phase and w no gradient; they are noise")
    R, P = 1, L
    for n in batch:
        R, P = R * n, P * n

    def rows(t):  # [..., L, k] -> [P, k]
        return t.expand(batch + (L, t.shape[-1])).reshape(P, t.shape[-1]).contiguous()

    A = x.shape[-1] + (0 if x_const is None else x_const.shape[-1])
    flags = None
    if deriv_mask is not None:
        flags = torch.zeros(A, dtype=torch.uint8, device=x.device)
        flags[:deriv_mask.shape[0]] = deriv_mask.to(device=x.device, dtype=torch.uint8)
    out = _K6Fn.apply(rows(x), None if x_const is None else rows(x_const), rows(omega), rows(phase),
                      scale.expand(batch + (L, 1)).reshape(P).contiguous(),
                      w.reshape((R, S, L, nb)).contiguous(), flags)
    return out.reshape(batch + (S, L, A))
