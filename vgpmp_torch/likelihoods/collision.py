"""Collision likelihood p(e | f): FK -> SDF clearance -> hinge cost.

Port of ``vgpmp_tpu/likelihoods/collision.py``. ``log_prob`` is
``-0.5 Σ_P max(ε − (sdf − r), 0)² / σ`` (first-power σ division). On a CUDA
tensor with a packed scene it runs kernel K1 (``csrc/k1_collision.cu``), which
fuses FK, the packed-table gather and the hinge and computes ``∂/∂q`` in the
same pass; where σ_obs is trained it also keeps the squared hinges, and the
backward's :func:`k1_dsigma` reduces them to ``∂/∂σ``. On a CPU tensor it
runs :func:`log_prob_plain`.

``min_clearance_eval`` is the success metric's clearance: the minimum over
spheres of the trilinear-interpolated clearance. On a CUDA tensor it runs
kernel K3 (``csrc/k3_clearance.cu``), on a CPU tensor
:func:`min_clearance_eval_plain`. ``probe_clearance`` is the metric's pass
over the PD-path probes: the same clearance, the tapered floor's compare and
the count of violated probes per segment. On a CUDA tensor it runs K3's fused
entry (:func:`k3_probe_clearance`), on a CPU tensor
:func:`vgpmp_torch.sim.probe_clearance_plain`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from vgpmp_torch import _build
from vgpmp_torch.kinematics.dh import FkModel, sphere_positions
from vgpmp_torch.ops.transforms import sigmoid_box, sigmoid_box_inverse
from vgpmp_torch.scene import Scene
from vgpmp_torch.sim import probe_clearance_plain

__all__ = ["CollisionModel", "joint_sigmoid", "joint_sigmoid_inverse", "log_prob_plain",
           "k1_loglik", "k1_dsigma", "dsigma_plain", "min_clearance_eval_plain", "k3_min_clearance", "k3_probe_clearance"]


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
    # host copies for kernel launches (no device sync): the base offset, and
    # the base grid's origin and delta
    _base_offset_host: tuple = field(init=False, repr=False)
    _grid_host: tuple = field(init=False, repr=False)

    def __post_init__(self):
        self.epsilon = float(self.epsilon)
        self._base_offset_host = tuple(float(v) for v in self.scene.base_offset.tolist())
        base = self.scene.base
        self._grid_host = (*(float(v) for v in base.origin.tolist()), float(base.delta))

    def sphere_clearance(self, configs: torch.Tensor) -> torch.Tensor:
        """``[..., L] -> [..., P]`` signed clearance (sdf − radius) per sphere."""
        pos = sphere_positions(self.fk, configs)
        return self.scene.distance(pos) - self.fk.sphere_radii

    def sphere_clearance_eval(self, configs: torch.Tensor) -> torch.Tensor:
        """``[..., L] -> [..., P]`` clearance by trilinear SDF interpolation (plain
        PyTorch on every device): what the executor and validator verdicts
        measure, where training keeps the one-gather nearest-cell lookup."""
        pos = sphere_positions(self.fk, configs)
        return self.scene.distance(pos, mode_override="trilinear") - self.fk.sphere_radii

    def min_clearance_eval(self, configs: torch.Tensor) -> torch.Tensor:
        """``[..., L] -> [...]``: :meth:`sphere_clearance_eval`'s minimum over the
        spheres, the quantity every caller of the metric takes. Not
        differentiable on CUDA (K3 is forward only)."""
        if configs.is_cuda:
            q = configs.detach().reshape(-1, configs.shape[-1]).contiguous()
            return k3_min_clearance(self, q).reshape(configs.shape[:-1])
        return min_clearance_eval_plain(self, configs)

    def probe_clearance(self, qs, q_s, q_g, depth_s, depth_g, visited, seg_idx, T: int,
                        radius: float, slack: float):
        """The metric's pass over the probes ``qs [B, G, L]``: ``(clear [B, G],
        seg_count [B, T] int32)``, as :func:`vgpmp_torch.sim.probe_clearance_plain`
        defines them. K3's fused entry on CUDA (forward only)."""
        if qs.is_cuda:
            return k3_probe_clearance(self, qs, q_s, q_g, depth_s, depth_g, visited, seg_idx, T,
                                      radius, slack)
        return probe_clearance_plain(self.min_clearance_eval, qs, q_s, q_g, depth_s, depth_g,
                                     visited, seg_idx, T, radius, slack)

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


def k1_loglik(model: CollisionModel, q: torch.Tensor, sigma: torch.Tensor, grad: bool,
              h2: bool = False):
    """K1 launch: ``q [T, dof]`` float32 CUDA, ``sigma [R, P]`` float32 with
    ``T`` a multiple of ``R`` (config ``t`` uses row ``t // (T/R)``) ->
    ``(lik [T], dlik/dq [T, dof] or None, h² [P, T] or None)``; ``h2`` (with
    ``grad``) also returns the squared hinges that :func:`k1_dsigma` reads.
    ``launches_h2`` counts the launches that wrote them."""
    scene, fk = model.scene, model.fk
    if not q.is_cuda:
        raise ValueError(f"k1_loglik: needs CUDA tensors, got q on {q.device}")
    if q.shape[-1] != fk.dof:
        raise ValueError(f"k1_loglik: q has {q.shape[-1]} joints, the robot {fk.dof}")
    if scene.mode != "packed" or scene.has_extras:
        raise ValueError("k1_loglik: needs a packed scene with no extra grids or primitives")
    if h2 and not grad:
        raise ValueError("k1_loglik: h2 is written only beside the gradient")
    packed = scene.base_packed
    lik, dlik, sq = _build.load().k1_loglik(
        q, sigma, fk.k1_robot, fk.k1_spheres, packed.words, fk.craig, grad, h2,
        [*model._base_offset_host, *packed.host_origin, packed.host_delta], list(packed.shape),
        model.epsilon)
    k1_loglik.launches += 1
    k1_loglik.launches_h2 += int(h2)
    return lik, dlik, sq


k1_loglik.launches = 0
k1_loglik.launches_h2 = 0


def dsigma_plain(g: torch.Tensor, h2: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`k1_dsigma`: ``g [T]``, ``h2 [P, T]``,
    ``sigma [R, P]`` -> ``[R, P]``, ``½ Σ_{t in row r} g_t h2_pt / σ_rp²``
    (the gradient of ``−½ Σ_p h²/σ`` that autograd through
    :func:`log_prob_plain` gives)."""
    R, P = sigma.shape
    rows = (g[None, :] * h2).reshape(P, R, -1).sum(dim=-1).T
    return 0.5 * rows / (sigma * sigma)


def k1_dsigma(g: torch.Tensor, h2: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """K1's d/dσ launch: the upstream gradient ``g [T]``, the forward's squared
    hinges ``h2 [P, T]`` and ``sigma [R, P]``, float32 CUDA -> ``[R, P]``
    (see :func:`dsigma_plain`)."""
    if not g.is_cuda:
        raise ValueError(f"k1_dsigma: needs CUDA tensors, got g on {g.device}")
    if g.ndim != 1 or h2.shape != (sigma.shape[-1], g.shape[0]):
        raise ValueError(f"k1_dsigma: g {tuple(g.shape)}, h2 {tuple(h2.shape)} and sigma "
                         f"{tuple(sigma.shape)} are not [T], [P, T] and [R, P]")
    out = _build.load().k1_dsigma(g.contiguous(), h2, sigma.contiguous())
    k1_dsigma.launches += 1
    return out


k1_dsigma.launches = 0


def min_clearance_eval_plain(model: CollisionModel, configs: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: FK, the eight-corner trilinear lookup and the
    minimum over spheres as separate tensor ops."""
    return model.sphere_clearance_eval(configs).min(dim=-1).values


def k3_min_clearance(model: CollisionModel, q: torch.Tensor) -> torch.Tensor:
    """K3 launch: ``q [T, dof]`` float32 CUDA -> ``[T]`` minimum over spheres of
    the trilinear clearance against the scene's base grid."""
    scene, fk = model.scene, model.fk
    if not q.is_cuda:
        raise ValueError(f"k3_min_clearance: needs CUDA tensors, got q on {q.device}")
    if q.shape[-1] != fk.dof:
        raise ValueError(f"k3_min_clearance: q has {q.shape[-1]} joints, the robot {fk.dof}")
    if scene.has_extras:
        raise ValueError("k3_min_clearance: needs a scene with no extra grids or primitives")
    out = _build.load().k3_min_clearance(
        q, fk.k1_robot, fk.k1_spheres, scene.base.data, fk.craig,
        [*model._base_offset_host, *model._grid_host])
    k3_min_clearance.launches += 1
    return out


k3_min_clearance.launches = 0


def k3_probe_clearance(model: CollisionModel, qs: torch.Tensor, q_s: torch.Tensor,
                       q_g: torch.Tensor, depth_s: torch.Tensor, depth_g: torch.Tensor,
                       visited: torch.Tensor, seg_idx: torch.Tensor, T: int, radius: float,
                       slack: float):
    """K3's fused entry: ``qs [B, G, dof]`` float32 CUDA probes, per row the
    endpoints ``q_s``/``q_g [B, dof]``, their depths ``[B]`` and ``visited [B]``
    bool, ``seg_idx [B, G]`` int64 -> ``(clear [B, G], seg_count [B, T]
    int32)`` in one launch (see :func:`vgpmp_torch.sim.probe_clearance_plain`)."""
    scene, fk = model.scene, model.fk
    if not qs.is_cuda:
        raise ValueError(f"k3_probe_clearance: needs CUDA tensors, got qs on {qs.device}")
    if qs.ndim != 3 or qs.shape[-1] != fk.dof:
        raise ValueError(f"k3_probe_clearance: qs {tuple(qs.shape)} is not [B, G, {fk.dof}]")
    if scene.has_extras:
        raise ValueError("k3_probe_clearance: needs a scene with no extra grids or primitives")
    B, G, L = qs.shape
    shapes = [tuple(x.shape) for x in (q_s, q_g, depth_s, depth_g, visited, seg_idx)]
    if shapes != [(B, L), (B, L), (B,), (B,), (B,), (B, G)]:
        raise ValueError(f"k3_probe_clearance: q_s, q_g, depth_s, depth_g, visited and seg_idx "
                         f"{shapes} do not match qs {tuple(qs.shape)}")
    clear, count = _build.load().k3_probe_clearance(
        qs.detach().reshape(B * G, L).contiguous(), fk.k1_robot, fk.k1_spheres, scene.base.data,
        fk.craig, [*model._base_offset_host, *model._grid_host], q_s.detach().contiguous(),
        q_g.detach().contiguous(), depth_s.detach().contiguous(), depth_g.detach().contiguous(),
        visited.contiguous(), seg_idx.contiguous(), int(T), float(radius), float(slack))
    k3_probe_clearance.launches += 1
    return clear.reshape(B, G), count


k3_probe_clearance.launches = 0


class _K1Fn(torch.autograd.Function):
    """K1 forward; backward multiplies the saved ``∂lik/∂q`` (no second gather)
    and, where σ needs a gradient, reduces the saved ``h²`` with
    :func:`k1_dsigma`."""

    @staticmethod
    def forward(ctx, configs, sigma, model, need_grad_q, need_grad_sigma):
        q = configs.reshape(-1, configs.shape[-1]).contiguous()
        sig = sigma.contiguous()
        need_grad = need_grad_q or need_grad_sigma
        lik, dlik, h2 = k1_loglik(model, q, sig, need_grad, need_grad_sigma)
        if need_grad:
            ctx.save_for_backward(dlik.reshape(configs.shape), h2, sig)
        ctx.need_grad_q = need_grad_q
        return lik.reshape(configs.shape[:-1])

    @staticmethod
    def backward(ctx, g):
        dlik, h2, sig = ctx.saved_tensors
        dq = g[..., None] * dlik if ctx.need_grad_q else None
        dsig = k1_dsigma(g.reshape(-1), h2, sig) if h2 is not None else None
        return dq, dsig, None, None, None


def _k1_log_prob(model: CollisionModel, configs: torch.Tensor, sigma_obs: torch.Tensor) -> torch.Tensor:
    grad_on = torch.is_grad_enabled()
    if sigma_obs.ndim == 1:
        sigma_obs = sigma_obs[None]
    elif sigma_obs.shape[0] != configs.shape[0]:
        raise ValueError(f"sigma_obs {tuple(sigma_obs.shape)} has no row per config row")
    return _K1Fn.apply(configs, sigma_obs, model, grad_on and configs.requires_grad,
                       grad_on and sigma_obs.requires_grad)
