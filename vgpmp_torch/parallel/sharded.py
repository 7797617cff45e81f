"""Sharded batch solvers: problems over ``dp``, Monte-Carlo samples over ``sp``
(port of ``vgpmp_tpu/parallel/sharded.py``).

Every rank runs the same program on its own device:

- each dp row of the mesh solves a contiguous slab of the problem batch,
  with no communication between problems;
- within a row the ``sp`` ranks cooperate on the slab's samples: each draws
  ``model.num_samples`` of them, the likelihood mean is averaged over the row
  every step and the best posterior sample is the row's
  (``sample_group`` in ``models/vgpmp.py``);
- the results, the per-row verdicts and the metrics come back whole on
  every rank: the slabs by one broadcast from each dp rank, the metric sums
  by one all-reduce. Both collectives carry CUDA tensors over NCCL and over
  gloo alike.

**Draws.** A solve draws from the caller's generator, which every rank must
seed alike. Each rank draws the whole batch's noise, step by step, and keeps
its own rows, so a dp-sharded solve draws what the unsharded
``make_batch_solver`` draws from the same seed, row for row. With ``sp > 1``
shard ``k`` draws from its own generator, seeded by
``SeedSequence((x, k))`` where ``x`` is one 62-bit draw from the caller's
generator, and takes its rows of the whole batch in the same way; so a row's
draws do not depend on ``dp``. They do depend on the batch size: a batch
padded to another multiple (:func:`pad_problems`) draws other numbers. Tests
pass ``noise`` instead: that shard's whole-batch draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vgpmp_torch.engine import solver as solver_mod
from vgpmp_torch.engine.validator import ValidationReport, execute_and_validate, validate_trajectory
from vgpmp_torch.gp import pathwise
from vgpmp_torch.models import vgpmp as planner
from vgpmp_torch.parallel.mesh import RankMesh

__all__ = ["pad_problems", "shard_generator", "make_sharded_solver", "make_sharded_round_solver"]


def pad_problems(starts: np.ndarray, goals: np.ndarray, multiple: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad a problem list to a multiple of the dp-shard count.

    Returns (starts, goals, valid_mask); padded rows repeat problem 0 and are
    masked out of the metrics.
    """
    q = len(starts)
    padded = -(-q // multiple) * multiple
    mask = np.zeros(padded, dtype=bool)
    mask[:q] = True
    pad = padded - q
    starts = np.concatenate([starts, np.repeat(starts[:1], pad, 0)], axis=0)
    goals = np.concatenate([goals, np.repeat(goals[:1], pad, 0)], axis=0)
    return starts, goals, mask


def shard_generator(generator: torch.Generator, mesh: RankMesh) -> torch.Generator:
    """The generator this rank's sp shard draws from: the caller's at
    ``sp = 1``; else one seeded ``SeedSequence((x, sp_index))``, ``x`` a
    62-bit draw from the caller's generator (the same on every rank)."""
    if mesh.sp == 1:
        return generator
    x = int(torch.randint(2 ** 62, (1,), generator=generator, device=generator.device))
    seed = int(np.random.SeedSequence((x, mesh.sp_index)).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=generator.device).manual_seed(seed)


class _RowDraws:
    """The step draws of one solve, made when the solver reads them (in step
    order): the whole batch's :class:`PathNoise` from ``generator``, or
    ``noise``'s, with this rank's ``rows`` kept."""

    def __init__(self, model: planner.PlannerModel, n: int, B: int, rows: slice, generator, noise):
        self.model, self.n, self.B, self.rows = model, n, B, rows
        self.generator, self.noise, self.next = generator, noise, 0

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, j: int) -> pathwise.PathNoise:
        if j != self.next:
            raise IndexError(f"step draws are read in order: wanted {self.next}, got {j}")
        self.next += 1
        if self.noise is not None:
            return _rows_of(self.noise[j], self.rows)
        return draw_rows(self.model, self.model.num_samples, self.model.antithetic, self.B,
                         self.rows, self.generator)


def _rows_of(pn: pathwise.PathNoise, rows: slice) -> pathwise.PathNoise:
    return pathwise.PathNoise(*(torch.as_tensor(x)[rows] for x in pn))


def draw_rows(model: planner.PlannerModel, num_samples: int, antithetic: bool, B: int, rows: slice,
              generator) -> pathwise.PathNoise:
    """``rows`` of one whole-batch :func:`pathwise.draw_noise`, as the model's
    draw of a ``[B]`` batch makes it."""
    C, M = model.ny.shape[0], model.num_inducing
    Mc = (2 * C if model.velocity_constrained else C) + M
    return _rows_of(pathwise.draw_noise((B,), model.num_latent, Mc, num_samples, model.num_bases,
                                        model.dtype, model.device, generator, model.kernel,
                                        antithetic), rows)


def _local_solver(model, cfg, mesh: RankMesh, trainable):
    """``solve(params_b, starts, goals, generator, noise) -> (rows, starts,
    goals, SolveResult of the rows)``: this rank's slab of a ``[B]`` batch."""
    sample_group = mesh.sp_group if mesh.sp > 1 else None
    init_state, train_chunk, extract = solver_mod.make_resumable_solver(
        model, cfg, trainable, sample_group=sample_group)
    as_t = lambda x: torch.as_tensor(x, dtype=model.dtype, device=model.device)

    def solve(params_b: planner.PlannerParams, starts, goals, generator=None,
              noise: Optional[solver_mod.SolveNoise] = None):
        if generator is None and noise is None:
            raise ValueError("a sharded solve needs a generator seeded alike on every rank, or noise")
        B = len(starts)
        if B % mesh.dp:
            raise ValueError(f"{B} problems not divisible by dp={mesh.dp}; use pad_problems")
        n = B // mesh.dp
        rows = slice(mesh.dp_index * n, (mesh.dp_index + 1) * n)
        gen = shard_generator(generator, mesh) if noise is None else None
        starts, goals = as_t(starts)[rows], as_t(goals)[rows]
        timesteps = None
        if cfg.randomize_timesteps:
            X = torch.linspace(0.0, 1.0, cfg.time_spacing_X, dtype=model.dtype, device=model.device)
            timesteps = (as_t(noise.timesteps) if noise is not None
                         else solver_mod.random_timesteps(X, B, gen))[rows]
        state = init_state(params_b.map(lambda x: x[rows]),
                           noise=solver_mod.SolveNoise([], None, timesteps))
        steps = _RowDraws(model, cfg.num_steps, B, rows, gen, None if noise is None else noise.steps)
        state, hist, logs = train_chunk(state, starts, goals, noise=solver_mod.SolveNoise(steps, None),
                                        n=cfg.num_steps)
        post = (_rows_of(noise.posterior, rows) if noise is not None
                else draw_rows(model, cfg.num_posterior_samples, False, B, rows, gen))
        res = extract(state, starts, goals, noise=solver_mod.SolveNoise([], post), elbo_history=hist)
        return rows, starts, goals, res._replace(logs=logs)

    return solve


def gather_rows(x: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    """Every dp rank's slab ``[B/dp, ...]`` as the whole ``[B, ...]`` on every
    rank: one broadcast from each dp rank in turn (bit for bit)."""
    if mesh.dp == 1:
        return x
    is_bool = x.dtype == torch.bool
    mine = (x.to(torch.uint8) if is_bool else x).contiguous()
    parts = []
    for i, src in enumerate(mesh.dp_ranks):
        buf = mine if i == mesh.dp_index else torch.empty_like(mine)
        dist.broadcast(buf, src=src, group=mesh.dp_group)
        parts.append(buf)
    out = torch.cat(parts)
    return out.to(torch.bool) if is_bool else out


def _gather_result(res: solver_mod.SolveResult, mesh: RankMesh) -> solver_mod.SolveResult:
    g = lambda x: None if x is None else gather_rows(x, mesh)
    return res._replace(best=g(res.best), mean=g(res.mean), best_score=g(res.best_score),
                        elbo_history=g(res.elbo_history), failed=g(res.failed),
                        samples=g(res.samples), ee_uncertainty=g(res.ee_uncertainty),
                        logs=None if res.logs is None else {k: g(v) for k, v in res.logs.items()})


def _gather_report(rep: ValidationReport, mesh: RankMesh) -> ValidationReport:
    return ValidationReport(**{k: None if v is None else gather_rows(v, mesh)
                               for k, v in rep._asdict().items()})


def make_sharded_round_solver(model: planner.PlannerModel, cfg: solver_mod.TrainConfig, mesh: RankMesh,
                              trainable: Optional[dict] = None):
    """dp-sharded :func:`engine.solver.make_round_solver`: the same
    ``solve(params_b, starts, goals, generator=None, noise=None) -> (best,
    reports)``, problems split over the mesh's ``dp`` ranks (``B`` divisible
    by dp; see :func:`pad_problems`), samples over ``sp``. Every rank returns
    the whole ``[B]`` best trajectories and report, so
    :func:`engine.solver.solve_adaptive` runs on every rank in step; ``solve``
    carries ``dp_size``, to which that engine rounds its bucket sizes.
    """
    local = _local_solver(model, dataclasses.replace(cfg, ee_uncertainty=False), mesh, trainable)

    def solve(params_b, starts, goals, generator=None, noise=None):
        _, s, g, res = local(params_b, starts, goals, generator, noise)
        with torch.no_grad():
            rep = execute_and_validate(model.collision, res.best, s, g, model.limits_low,
                                       model.limits_high)
        return gather_rows(res.best, mesh), _gather_report(rep, mesh)

    solve.dp_size = mesh.dp
    return solve


def make_sharded_solver(model: planner.PlannerModel, cfg: solver_mod.TrainConfig, mesh: RankMesh,
                        trainable: Optional[dict] = None, validate: bool = True):
    """The mesh-sharded batch solver.

    Returns ``solve(params_b, starts, goals, generator=None, mask=None,
    noise=None) -> (SolveResult, metrics)``: every argument has the leading
    problem axis ``B`` (divisible by dp; see :func:`pad_problems`), the same
    on every rank; ``mask [B]`` (all rows by default) marks the rows the
    metrics count. The result is the whole ``[B]`` on every rank. Per-rank
    sample counts are ``model.num_samples``, so the effective budget is
    ``num_samples * sp``. The metrics are JAX's: ``success_rate``,
    ``num_problems`` and ``num_failed`` summed over the dp ranks of the masked
    rows, ``mean_min_clearance`` over the masked rows that did not diverge,
    and the per-row ``success``, ``min_clearance`` and ``failed`` (each
    ``validate_trajectory``'s); ``{}`` without ``validate``.
    """
    local = _local_solver(model, cfg, mesh, trainable)

    def solve(params_b, starts, goals, generator=None, mask=None, noise=None):
        rows, s, g, res = local(params_b, starts, goals, generator, noise)
        metrics = {}
        if validate:
            with torch.no_grad():
                rep = validate_trajectory(model.collision, res.best, s, g, model.limits_low,
                                          model.limits_high)
            dt = res.best.dtype
            w = (torch.ones(len(s), dtype=dt, device=s.device) if mask is None
                 else torch.as_tensor(mask, device=s.device)[rows].to(dt))
            failed = res.failed.to(dt)
            wf = w * (1.0 - failed)
            sums = torch.stack([w.sum(), (rep.success.to(dt) * w).sum(), (failed * w).sum(),
                                (torch.nan_to_num(rep.min_clearance) * wf).sum(), wf.sum()])
            if mesh.dp_group is not None:
                dist.all_reduce(sums, group=mesh.dp_group)
            denom, solved, num_failed, clear, n_clear = sums
            metrics = {
                "success_rate": solved / denom,
                "num_problems": denom,
                "num_failed": num_failed,
                "mean_min_clearance": clear / torch.clamp(n_clear, min=1.0),
                "success": gather_rows(rep.success, mesh),
                "min_clearance": gather_rows(rep.min_clearance, mesh),
                "failed": gather_rows(res.failed, mesh),
            }
        return _gather_result(res, mesh), metrics

    return solve
