"""Post-hoc analysis and debug probes on planner outputs (port of
``vgpmp_tpu/engine/analysis.py``).

- the end-effector path uncertainty across posterior samples;
- the first-order propagation of joint-space σ to the end-effector position
  (``torch.func.jacfwd`` of the FK chain);
- the total collision log-density of given configurations;
- the SDF gradient at every collision sphere of one configuration, by
  autograd through ``Scene.distance``: on a packed scene that is the stored
  per-voxel gradient (``sdf/grid.py:_PackedFn``), as JAX's custom VJP gives.
"""

from __future__ import annotations

import torch

from vgpmp_torch.kinematics.dh import FkModel, ee_positions, sphere_positions
from vgpmp_torch.likelihoods.collision import CollisionModel
from vgpmp_torch.models.vgpmp import PlannerModel, PlannerParams, constrain

__all__ = ["ee_positions", "ee_path_uncertainty", "ee_jacobian_uncertainty", "debug_likelihood",
           "sdf_gradient_at_config"]


def ee_path_uncertainty(fk: FkModel, samples: torch.Tensor) -> torch.Tensor:
    """Twice the per-axis standard deviation of the end-effector position
    across posterior samples: ``samples [..., S, N, L] -> [..., N, 3]``."""
    return 2.0 * ee_positions(fk, samples).std(dim=-3, unbiased=False)


def ee_jacobian_uncertainty(fk: FkModel, config: torch.Tensor,
                            config_sigma: torch.Tensor) -> torch.Tensor:
    """``σ_pos_k = sqrt(Σ_j (∂EE_k/∂q_j σ_j)²)`` for one configuration
    ``config [L]`` and joint σ ``config_sigma [L]``: ``[3]``."""
    J = torch.func.jacfwd(lambda q: ee_positions(fk, q))(config)  # [3, L]
    return torch.sqrt(((J * config_sigma[None, :]) ** 2).sum(dim=-1))


def debug_likelihood(params: PlannerParams, model: PlannerModel, configs: torch.Tensor) -> torch.Tensor:
    """Total collision log-density of constrained configurations, a scalar.

    ``params`` of one problem (a batch of one, as ``init_params`` gives it)
    scores ``configs [..., L]`` with that problem's σ_obs; a batch of ``B``
    problems needs ``configs [B, ..., L]``, row by row.
    """
    sigma = constrain(params, model.variance_lower)["sigma_obs"]
    if sigma.shape[0] == 1:
        sigma = sigma[0]
    return model.collision.log_prob(configs, sigma).sum()


def sdf_gradient_at_config(collision: CollisionModel, config: torch.Tensor) -> torch.Tensor:
    """Spatial SDF gradient at every collision-sphere centre of one
    configuration ``config [L]``: ``[P, 3]``."""
    with torch.enable_grad():
        pos = sphere_positions(collision.fk, config.detach()).detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(collision.scene.distance(pos).sum(), pos)
    return grad
