"""Collision likelihood p(e | f): FK -> SDF clearance -> hinge cost.

Port of ``vgpmp_tpu/likelihoods/collision.py``. ``log_prob`` is
``-0.5 Σ_P max(ε − (sdf − r), 0)² / σ`` (first-power σ division). On a CUDA
tensor with a packed scene it runs kernel K1 (``csrc/k1_collision.cu``), which
fuses FK, the packed-table gather and the hinge and computes ``∂/∂q`` in the
same pass; on a CPU tensor it runs :func:`log_prob_plain`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from vgpmp_torch import _build
from vgpmp_torch.kinematics.dh import FkModel, sphere_positions
from vgpmp_torch.ops.transforms import sigmoid_box, sigmoid_box_inverse
from vgpmp_torch.scene import Scene

__all__ = ["CollisionModel", "joint_sigmoid", "joint_sigmoid_inverse", "log_prob_plain",
           "k1_loglik"]


def joint_sigmoid(f: torch.Tensor, low, high) -> torch.Tensor:
    """Latent -> joint-limit box."""
    return sigmoid_box(f, low, high)


def joint_sigmoid_inverse(q: torch.Tensor, low, high) -> torch.Tensor:
    return sigmoid_box_inverse(q, low, high)


@dataclass
class CollisionModel:
    """Collision-likelihood data for one (robot, scene) pair."""

    fk: FkModel
    scene: Scene
    epsilon: float  # hinge safety margin
    _base_offset_host: tuple = field(init=False, repr=False)

    def __post_init__(self):
        self.epsilon = float(self.epsilon)
        self._base_offset_host = tuple(float(v) for v in self.scene.base_offset.tolist())

    def sphere_clearance(self, configs: torch.Tensor) -> torch.Tensor:
        """``[..., L] -> [..., P]`` signed clearance (sdf − radius) per sphere."""
        pos = sphere_positions(self.fk, configs)
        return self.scene.distance(pos) - self.fk.sphere_radii

    def hinge_cost(self, configs: torch.Tensor) -> torch.Tensor:
        """``max(ε − clearance, 0)`` per sphere."""
        return torch.clamp(self.epsilon - self.sphere_clearance(configs), min=0.0)

    def log_prob(self, configs: torch.Tensor, sigma_obs: torch.Tensor) -> torch.Tensor:
        """``[..., L] -> [...]`` collision log-density.

        ``sigma_obs``: ``[P]``, or ``[B, P]`` with one row per leading
        ``configs`` row (per-problem σ in a batch).
        """
        if configs.is_cuda and self.scene.mode == "packed":
            return _k1_log_prob(self, configs, sigma_obs)
        return log_prob_plain(self, configs, sigma_obs)


def _sigma_rows(sigma_obs: torch.Tensor, configs: torch.Tensor) -> torch.Tensor:
    """``[P]`` or ``[B, P]`` -> broadcastable against ``[..., P]`` costs."""
    if sigma_obs.ndim == 1:
        return sigma_obs
    return sigma_obs.reshape(sigma_obs.shape[:1] + (1,) * (configs.ndim - 2) + sigma_obs.shape[1:])


def log_prob_plain(model: CollisionModel, configs: torch.Tensor, sigma_obs: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: FK, scene lookup and hinge as separate tensor ops."""
    cost = model.hinge_cost(configs)
    return -0.5 * (cost * cost / _sigma_rows(sigma_obs, configs)).sum(dim=-1)


def k1_loglik(model: CollisionModel, q: torch.Tensor, sigma: torch.Tensor, grad: bool):
    """K1 launch: ``q [T, dof]`` float32 CUDA, ``sigma [R, P]`` float32 with
    ``T`` a multiple of ``R`` (config ``t`` uses row ``t // (T/R)``) ->
    ``(lik [T], dlik/dq [T, dof] or None)``."""
    scene, fk = model.scene, model.fk
    if not q.is_cuda:
        raise ValueError(f"k1_loglik: needs CUDA tensors, got q on {q.device}")
    if q.shape[-1] != fk.dof:
        raise ValueError(f"k1_loglik: q has {q.shape[-1]} joints, the robot {fk.dof}")
    if scene.mode != "packed" or scene.has_extras:
        raise ValueError("k1_loglik: needs a packed scene with no extra grids or primitives")
    packed = scene.base_packed
    lik, dlik = _build.load().k1_loglik(
        q, sigma, fk.k1_robot, fk.k1_spheres, packed.words, fk.craig, grad,
        [*model._base_offset_host, *packed.host_origin, packed.host_delta], list(packed.shape),
        model.epsilon)
    k1_loglik.launches += 1
    return lik, dlik


k1_loglik.launches = 0


class _K1Fn(torch.autograd.Function):
    """K1 forward; backward multiplies the saved ``∂lik/∂q`` (no second gather)."""

    @staticmethod
    def forward(ctx, configs, sigma, model, need_grad):
        q = configs.reshape(-1, configs.shape[-1]).contiguous()
        sig = sigma.reshape(-1, sigma.shape[-1]).contiguous()
        lik, dlik = k1_loglik(model, q, sig, need_grad)
        if need_grad:
            ctx.save_for_backward(dlik.reshape(configs.shape))
        return lik.reshape(configs.shape[:-1])

    @staticmethod
    def backward(ctx, g):
        (dlik,) = ctx.saved_tensors
        return g[..., None] * dlik, None, None, None


def _k1_log_prob(model: CollisionModel, configs: torch.Tensor, sigma_obs: torch.Tensor) -> torch.Tensor:
    grad_on = torch.is_grad_enabled()
    if grad_on and sigma_obs.requires_grad:
        raise NotImplementedError("K1 does not differentiate σ; freeze sigma_obs_u on CUDA")
    if sigma_obs.ndim == 1:
        sigma_obs = sigma_obs[None]
    elif sigma_obs.shape[0] != configs.shape[0]:
        raise ValueError(f"sigma_obs {tuple(sigma_obs.shape)} has no row per config row")
    return _K1Fn.apply(configs, sigma_obs, model, grad_on and configs.requires_grad)
