"""Plain float64 reference of the planner's model: the robot's DH chain to its
collision spheres, the scene's signed-distance grid (the packed nearest-cell
lookup the training uses, the trilinear one the metric uses), the
conditioned sparse GP with its pathwise (random Fourier feature) draws, the
Monte-Carlo ELBO, the guarded Adam step and the posterior extraction.

Written from the method's equations and the asset files alone: it imports
nothing of the program. Everything the program derives at set-up (the packed
grid words, the kinematic tables, the initial state) is worked out here
again from the robot, problemset and scene files. Random draws are inputs
(:class:`Draws`): the benchmark makes them and hands the same numbers to
both sides.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, NamedTuple

import numpy as np
import torch

F64 = torch.float64
SQRT5 = math.sqrt(5.0)
TWO_PI = 2.0 * math.pi
# the transforms' lower bounds and the inducing-time box of the method
SIGMA_OBS_LOWER, ALPHA_LOWER, Z_LOW, Z_HIGH = 1e-5, 1e-4, 0.09, 0.91
LEAVES = ("q_mu", "q_sqrt", "lengthscales_u", "variance_u", "z_u", "sigma_obs_u", "alpha_u")
TRAINABLE = ("q_mu", "q_sqrt", "lengthscales_u", "variance_u")


class Draws(NamedTuple):
    """One pathwise draw's random numbers: ``t [B, L, nb]`` (Student-t(5)),
    ``phase [B, L, nb]`` (uniform on [0, 2π)), ``w [B, S, L, nb]`` and
    ``eps [B, S, L, Mc]`` (standard normal)."""

    t: torch.Tensor
    phase: torch.Tensor
    w: torch.Tensor
    eps: torch.Tensor


def _quat_rot(q) -> np.ndarray:
    x, y, z, w = (float(v) for v in q)
    n = math.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                     [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                     [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (to nearest, ties to even), as float64."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    r = (u + np.uint32(0x8000) + ((u >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return r.view(np.float32).astype(np.float64)


@dataclass
class Problem:
    """One robot in one scene with the configuration's planner parameters,
    on ``device`` in float64."""

    craig: bool
    dh: torch.Tensor             # [L, 3] (d, a, alpha)
    twist: torch.Tensor          # [L]
    base: torch.Tensor           # [4, 4]
    frame: torch.Tensor          # [P] chain frame of each sphere (0 = base)
    offsets: torch.Tensor        # [P, 3]
    radii: torch.Tensor          # [P]
    lo: torch.Tensor             # [L] joint limits
    hi: torch.Tensor
    grid: torch.Tensor           # [nx, ny, nz] signed distances
    origin: torch.Tensor         # [3]
    delta: float
    scene_offset: torch.Tensor   # [3]
    packed_value: torch.Tensor   # [nx*ny*nz] bf16 value
    packed_grad: torch.Tensor    # [nx*ny*nz, 3] bf16 central difference
    pp: Dict
    states: np.ndarray           # [n, L] the problemset's states

    @classmethod
    def load(cls, assets: Path, robot: str, problemset: str, planner_params: Dict, device) -> "Problem":
        spec = json.loads((assets / "robots" / f"{robot}.json").read_text())
        ps = json.loads((assets / "problemsets" / f"{robot}.json").read_text())[problemset]
        with np.load(assets / "scenes" / f"{problemset}.npz") as z:
            data = z["data"].astype(np.float32)
            origin, delta = np.asarray(z["origin"], np.float64), float(z["delta"])
        base = np.eye(4)
        base[:3, :3] = _quat_rot(ps["robot_orientation_xyzw"])
        base[:3, 3] = ps["robot_position"]
        # central differences of the float32 grid, clipped at the border, with an
        # exact zero replaced by 0.1; value and gradient stored as bfloat16
        grads = []
        for ax in range(3):
            n = data.shape[ax]
            hi = np.take(data, np.minimum(np.arange(n) + 1, n - 1), axis=ax)
            lo = np.take(data, np.maximum(np.arange(n) - 1, 0), axis=ax)
            g = ((hi - lo) / np.float32(2.0 * delta)).astype(np.float32)
            grads.append(np.where(g == 0, np.float32(0.1), g))
        t = lambda x, dt=F64: torch.as_tensor(np.asarray(x), dtype=dt, device=device)
        jl = np.asarray(spec["joint_limits"], np.float64)
        fk_slice = np.asarray(spec["fk_slice"])
        return cls(
            craig=bool(spec["craig_dh"]), dh=t(spec["dh"]), twist=t(spec["twist"]), base=t(base),
            frame=t(fk_slice[np.asarray(spec["sphere_frame"])], torch.int64),
            offsets=t(spec["sphere_offsets"]), radii=t(spec["sphere_radii"]),
            lo=t(jl[:, 1]), hi=t(jl[:, 0]), grid=t(data), origin=t(origin), delta=delta,
            scene_offset=t(ps["environment_position"]),
            packed_value=t(_bf16(data).reshape(-1)),
            packed_grad=t(np.stack([_bf16(g).reshape(-1) for g in grads], axis=1)),
            pp=dict(planner_params), states=np.asarray(ps["states"], np.float64))

    @property
    def L(self) -> int:
        return int(self.lo.shape[0])

    @property
    def P(self) -> int:
        return int(self.radii.shape[0])


# ----------------------------------------------------------------- kinematics


def sphere_positions(pb: Problem, q: torch.Tensor) -> torch.Tensor:
    """World positions of the collision spheres, ``[..., L] -> [..., P, 3]``,
    by the product of the DH link transforms (Craig's modified convention
    or the standard one, as the robot's file says)."""
    th = q + pb.twist
    ct, st = torch.cos(th), torch.sin(th)
    d, a, al = pb.dh[:, 0], pb.dh[:, 1], pb.dh[:, 2]
    ca, sa = torch.cos(al).expand_as(ct), torch.sin(al).expand_as(ct)
    d, a = d.expand_as(ct), a.expand_as(ct)
    z, o = torch.zeros_like(ct), torch.ones_like(ct)
    if pb.craig:
        rows = [ct, -st, z, a, st * ca, ct * ca, -sa, -d * sa, st * sa, ct * sa, ca, d * ca, z, z, z, o]
    else:
        rows = [ct, -st * ca, st * sa, a * ct, st, ct * ca, -ct * sa, a * st, z, sa, ca, d, z, z, z, o]
    T = torch.stack(rows, dim=-1).reshape(q.shape + (4, 4))
    acc = pb.base.expand(q.shape[:-1] + (4, 4))
    frames = [acc]
    for i in range(pb.L):
        acc = acc @ T[..., i, :, :]
        frames.append(acc)
    sel = torch.stack(frames, dim=-3)[..., pb.frame, :, :]     # [..., P, 4, 4]
    return (sel[..., :3, :3] @ pb.offsets[:, :, None])[..., 0] + sel[..., :3, 3]


# ----------------------------------------------------------------- the scene


def _cell(pb: Problem, p: torch.Tensor) -> torch.Tensor:
    nx, ny, nz = pb.grid.shape
    n = torch.tensor([nx - 1, ny - 1, nz - 1], device=p.device)
    i = torch.minimum(torch.clamp(torch.floor((p - pb.origin) / pb.delta).to(torch.int64), min=0), n)
    return (i[..., 0] * ny + i[..., 1]) * nz + i[..., 2]


class _Packed(torch.autograd.Function):
    """The nearest cell's bf16 value; its gradient is the cell's stored bf16
    central difference."""

    @staticmethod
    def forward(ctx, p, pb):
        idx = _cell(pb, p)
        ctx.save_for_backward(pb.packed_grad[idx])
        return pb.packed_value[idx]

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return g[..., None] * grad, None


def packed_distance(pb: Problem, pos: torch.Tensor) -> torch.Tensor:
    """Training lookup at world points ``[..., 3]``."""
    return _Packed.apply(pos - pb.scene_offset, pb)


def trilinear_distance(pb: Problem, pos: torch.Tensor) -> torch.Tensor:
    """Metric lookup at world points ``[..., 3]``: C0 interpolation between
    the eight corners, clamped to the grid's border."""
    g = pb.grid
    nx, ny, nz = g.shape
    nmax = torch.tensor([nx - 1, ny - 1, nz - 1], dtype=F64, device=pos.device)
    rel = torch.minimum(torch.clamp((pos - pb.scene_offset - pb.origin) / pb.delta, min=0.0), nmax)
    i0 = torch.minimum(torch.floor(rel), nmax - 1)
    f = rel - i0
    i0 = i0.to(torch.int64)
    flat = g.reshape(-1)

    def c(dx, dy, dz):
        return flat[((i0[..., 0] + dx) * ny + i0[..., 1] + dy) * nz + i0[..., 2] + dz]

    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c00 = c(0, 0, 0) * (1 - fz) + c(0, 0, 1) * fz
    c01 = c(0, 1, 0) * (1 - fz) + c(0, 1, 1) * fz
    c10 = c(1, 0, 0) * (1 - fz) + c(1, 0, 1) * fz
    c11 = c(1, 1, 0) * (1 - fz) + c(1, 1, 1) * fz
    return (c00 * (1 - fy) + c01 * fy) * (1 - fx) + (c10 * (1 - fy) + c11 * fy) * fx


def log_prob(pb: Problem, q: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Collision log-density ``-½ Σ_P max(ε − (d − r), 0)² / σ_P`` of
    configurations ``[B, ..., L]`` with ``sigma [B, P]`` -> ``[B, ...]``."""
    clear = packed_distance(pb, sphere_positions(pb, q)) - pb.radii
    cost = torch.clamp(float(pb.pp["epsilon"]) - clear, min=0.0)
    sig = sigma.reshape(sigma.shape[:1] + (1,) * (q.ndim - 2) + sigma.shape[1:])
    return -0.5 * (cost * cost / sig).sum(dim=-1)


def min_clearance(pb: Problem, q: torch.Tensor) -> torch.Tensor:
    """The metric's worst sphere clearance, ``[..., L] -> [...]``."""
    return (trilinear_distance(pb, sphere_positions(pb, q)) - pb.radii).min(dim=-1).values


# ----------------------------------------------------------------- the GP


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def softplus_inv(y):
    return y + torch.log(-torch.expm1(-y))


def box(u, lo, hi):
    return lo + (hi - lo) / (1.0 + torch.exp(-u))


def box_inv(c, lo, hi):
    t = (c - lo) / (hi - lo)
    return torch.log(t) - torch.log1p(-t)


def variance_lower(pb: Problem) -> float:
    return float(pb.pp.get("variance_lower", min(0.1, 0.5 * float(pb.pp["variance"]))))


def constrain(pb: Problem, p: Dict) -> Dict:
    return {"q_mu": p["q_mu"], "q_sqrt": torch.tril(p["q_sqrt"]),
            "ls": softplus(p["lengthscales_u"]),
            "var": softplus(p["variance_u"]) + variance_lower(pb),
            "Z": box(p["z_u"], Z_LOW, Z_HIGH), "sigma": softplus(p["sigma_obs_u"]) + SIGMA_OBS_LOWER,
            "alpha": softplus(p["alpha_u"]) + ALPHA_LOWER}


def init_linear(pb: Problem, starts: torch.Tensor, goals: torch.Tensor) -> Dict:
    """The linear initial state of every row: ``q_mu`` the latent image of
    the straight line's first ``M`` of ``M + 1`` points, ``q_sqrt`` the
    identity, the inducing times evenly in [0.1, 0.9] and the problemset's
    hyperparameters, as unconstrained leaves ``[B, ...]``."""
    B, L, M, P = starts.shape[0], pb.L, int(pb.pp["num_inducing"]), pb.P
    dev = starts.device
    ar = torch.arange(M, dtype=F64, device=dev)[None, :, None]
    lin = starts[:, None] + (goals - starts)[:, None] * (ar / M)
    rep = lambda x: x.expand((B,) + x.shape).clone()
    full = lambda v, n: torch.full((n,), float(v), dtype=F64, device=dev)
    return {
        "q_mu": box_inv(lin, pb.lo, pb.hi),
        "q_sqrt": rep(torch.eye(M, dtype=F64, device=dev).repeat(L, 1, 1)),
        "lengthscales_u": rep(softplus_inv(torch.as_tensor(pb.pp["lengthscales"], dtype=F64, device=dev))),
        "variance_u": rep(softplus_inv(full(pb.pp["variance"], L) - variance_lower(pb))),
        "z_u": rep(box_inv(torch.linspace(0.1, 0.9, M, dtype=F64, device=dev)[:, None].repeat(1, L),
                           Z_LOW, Z_HIGH)),
        "sigma_obs_u": rep(softplus_inv(full(pb.pp["sigma_obs"], P) - SIGMA_OBS_LOWER)),
        "alpha_u": rep(softplus_inv(torch.tensor(float(pb.pp["alpha"]), dtype=F64, device=dev)
                                    - ALPHA_LOWER)),
    }


def matern52(x1, x2, ls, var):
    """``[..., L, A] x [..., L, C]`` with ``[..., L]`` hyperparameters -> ``[..., L, A, C]``."""
    r = torch.abs(x1[..., :, None] - x2[..., None, :]) / ls[..., None, None]
    return var[..., None, None] * (1.0 + SQRT5 * r + (5.0 / 3.0) * r * r) * torch.exp(-SQRT5 * r)


def sample_paths(pb: Problem, c: Dict, starts, goals, X: torch.Tensor, dr: Draws):
    """Pathwise posterior samples on ``X [N]``: ``f = Φ(X) w + k(X, Zy) Kuu⁻¹
    (u − Φ(Zy) w)`` with ``u ~ N(m, Λ Λᵀ)``, ``Λ = chol(Kuu) pad(q_sqrt)``
    (plus jitter on the clamped rows). Returns the latent samples ``[B, S,
    N, L]`` and the whitened mean ``L⁻¹ m`` (``[B, L, Mc]``) for the KL."""
    B, L, nb = c["ls"].shape[0], pb.L, int(pb.pp.get("num_bases", 1024))
    jitter = float(pb.pp.get("jitter", 1e-9))
    q_lat = box_inv(torch.stack([starts, goals], dim=1), pb.lo, pb.hi)        # [B, 2, L]
    m_full = torch.cat([q_lat, c["q_mu"]], dim=1).transpose(1, 2)            # [B, L, Mc]
    Cn = q_lat.shape[1]
    ny = torch.tensor([0.0, 1.0], dtype=F64, device=X.device).expand(B, L, Cn)
    zy = torch.cat([ny, c["Z"].transpose(1, 2)], dim=-1)                     # [B, L, Mc]
    Mc = zy.shape[-1]
    eye = torch.eye(Mc, dtype=F64, device=X.device)
    Lk = torch.linalg.cholesky(matern52(zy, zy, c["ls"], c["var"]) + jitter * eye)
    Kuf = matern52(zy, X.expand(B, L, X.shape[0]), c["ls"], c["var"])       # [B, L, Mc, N]
    omega = dr.t.to(F64) / c["ls"][..., None]                                # [B, L, nb]
    phase, w, eps = dr.phase.to(F64), dr.w.to(F64), dr.eps.to(F64)
    scale = torch.sqrt(2.0 * c["var"] / nb)[..., None, None]                # [B, L, 1, 1]
    phi_z = torch.cos(zy[..., None] * omega[..., None, :] + phase[..., None, :]) * scale
    f_prior_z = torch.einsum("blmk,bslk->bslm", phi_z, w)                    # [B, S, L, Mc]
    cond = (torch.arange(Mc, device=X.device) < Cn).to(F64)
    rhs = m_full[:, None] - f_prior_z + jitter * eps * cond                  # [B, S, L, Mc]
    pad = torch.einsum("blmn,bsln->bslm", torch.tril(c["q_sqrt"]), eps[..., Cn:])
    a = (torch.linalg.solve_triangular(Lk[:, None], rhs[..., None], upper=False)[..., 0]
         + torch.cat([torch.zeros_like(pad[..., :Cn]), pad], dim=-1))
    A = torch.linalg.solve_triangular(Lk, Kuf, upper=False)                  # [B, L, Mc, N]
    phi_x = torch.cos(X[:, None] * omega[..., None, :] + phase[..., None, :]) * scale  # [B, L, N, nb]
    f = torch.einsum("blnk,bslk->bsln", phi_x, w) + torch.einsum("blmn,bslm->bsln", A, a)
    m_w = torch.linalg.solve_triangular(Lk, m_full[..., None], upper=False)[..., 0]
    return f.transpose(-1, -2), m_w


def kl_whitened(m_w: torch.Tensor, q_sqrt: torch.Tensor) -> torch.Tensor:
    """KL(N(m_w[C:], S Sᵀ) || N(0, I)) summed over latents, ``[B]``."""
    M = q_sqrt.shape[-1]
    m = m_w[..., -M:]
    tril = torch.tril(q_sqrt)
    logdet = 2.0 * torch.log(torch.abs(torch.diagonal(tril, dim1=-2, dim2=-1))).sum(dim=(-2, -1))
    return 0.5 * ((m * m).sum(dim=(-2, -1)) + (tril * tril).sum(dim=(-3, -2, -1))
                  - m.shape[-1] * m.shape[-2] - logdet)


def elbo(pb: Problem, p: Dict, starts, goals, X, dr: Draws, sigma_scale: float = 1.0) -> torch.Tensor:
    """The Monte-Carlo ELBO of every row, ``[B]``: the collision likelihood of
    the sampled trajectories (mean over samples, sum over the grid) times
    alpha, less the KL of the whitened variational mean and factor."""
    c = constrain(pb, p)
    f, m_w = sample_paths(pb, c, starts, goals, X, dr)
    g = box(f, pb.lo, pb.hi)                                                 # [B, S, N, L]
    lik = log_prob(pb, g, c["sigma"] * sigma_scale)                          # [B, S, N]
    return lik.mean(dim=1).sum(dim=-1) * c["alpha"] - kl_whitened(m_w, c["q_sqrt"])


def lr_at(train: Dict, count: torch.Tensor) -> torch.Tensor:
    """Learning rate at step ``count``: constant, or a linear warm-up from 0 to
    ``lr_peak`` over ``warmup_steps`` and a cosine decay to ``learning_rate``
    at ``num_steps``."""
    count = count.to(F64)
    lr, peak, n = float(train["learning_rate"]), float(train["lr_peak"]), int(train["num_steps"])
    if peak <= 0:
        return torch.full_like(count, lr)
    warm = min(int(train["warmup_steps"]), max(n - 1, 1))
    ramp = peak * torch.clamp(count, 0.0, float(warm)) / warm
    decay = float(n - warm)
    cosine = 0.5 * (1 + torch.cos(math.pi * torch.clamp(count - warm, max=decay) / decay))
    return torch.where(count < warm, ramp, peak * ((1 - lr / peak) * cosine + lr / peak))


class Adam:
    """Adam per row, a row skipping the step (parameters, moments and count
    kept) where any entry of its update is not finite."""

    def __init__(self, train: Dict, p: Dict):
        self.train = train
        self.mu = {k: torch.zeros_like(v) for k, v in p.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in p.items()}
        self.count = torch.zeros(p["q_mu"].shape[0], dtype=torch.int64, device=p["q_mu"].device)

    def step(self, p: Dict, g: Dict) -> Dict:
        b1, b2, eps = float(self.train["beta1"]), float(self.train["beta2"]), float(self.train["adam_eps"])
        cnt = self.count + 1
        lr = lr_at(self.train, self.count)
        mu, nu, upd = {}, {}, {}
        ok = torch.ones_like(self.count, dtype=torch.bool)
        for k, x in p.items():
            shape = (-1,) + (1,) * (x.ndim - 1)
            mu[k] = (1 - b1) * g[k] + b1 * self.mu[k]
            nu[k] = (1 - b2) * g[k] * g[k] + b2 * self.nu[k]
            bc1 = (1 - b1 ** cnt.to(F64)).reshape(shape)
            bc2 = (1 - b2 ** cnt.to(F64)).reshape(shape)
            upd[k] = -lr.reshape(shape) * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
            ok &= torch.isfinite(upd[k]).reshape(x.shape[0], -1).all(dim=1)
        keep = lambda new, old: torch.where(ok.reshape((-1,) + (1,) * (old.ndim - 1)), new, old)
        self.mu = {k: keep(mu[k], self.mu[k]) for k in p}
        self.nu = {k: keep(nu[k], self.nu[k]) for k in p}
        self.count = torch.where(ok, cnt, self.count)
        return {k: keep(p[k] + upd[k], p[k]) for k in p}


def elbo_and_grad(pb: Problem, p: Dict, starts, goals, X, dr: Draws, block: int):
    """``(ELBO [B], gradient of the ELBO's negative sum per trainable leaf,
    zeros elsewhere)``, computed ``block`` rows at a time."""
    B = starts.shape[0]
    vals, grads = [], {k: [] for k in LEAVES}
    for r0 in range(0, B, block):
        sl = slice(r0, min(B, r0 + block))
        pr = {k: v[sl].detach().clone().requires_grad_(k in TRAINABLE) for k, v in p.items()}
        d = Draws(*(x[sl] for x in dr))
        v = elbo(pb, pr, starts[sl], goals[sl], X, d)
        gl = torch.autograd.grad(-v.sum(), [pr[k] for k in TRAINABLE])
        vals.append(v.detach())
        gd = dict(zip(TRAINABLE, gl))
        for k in LEAVES:
            grads[k].append(gd[k] if k in gd else torch.zeros_like(pr[k]))
    return torch.cat(vals), {k: torch.cat(v) for k, v in grads.items()}


def best_samples(pb: Problem, p: Dict, starts, goals, Xnew, dr: Draws, block: int):
    """Posterior extraction: every row's samples on ``Xnew`` scored by their
    summed collision log-density; returns ``(best score [B], sigma [B, P])``."""
    B = starts.shape[0]
    best = []
    with torch.no_grad():
        c = constrain(pb, p)
        for r0 in range(0, B, block):
            sl = slice(r0, min(B, r0 + block))
            cb = {k: v[sl] for k, v in c.items()}
            f, _ = sample_paths(pb, cb, starts[sl], goals[sl], Xnew, Draws(*(x[sl] for x in dr)))
            g = box(f, pb.lo, pb.hi)
            best.append(log_prob(pb, g, cb["sigma"]).sum(dim=-1).max(dim=1).values)
    return torch.cat(best), c["sigma"]
