"""What decides ``correct``: the program's answers against the plain reference
(``benchmark/reference``), each number beside its limit.

Two comparisons, both after the window has closed:

- **the model** (:func:`model_numbers`), on the rows of the window's first
  batch from the linear init, on draws the benchmark makes and hands to both
  sides, the reference in float64:

  - the window's own round solver (:meth:`program.System.round_solver`, the
    factory the window drives, on the same model) at :data:`STEPS` Adam
    steps: ``best_gap``, the score (under the reference) of each row's pick
    below the reference's best, the worst row; and its verdicts against the
    reference metric;
  - the round solver's step body (``make_resumable_solver``, which the round
    solver runs; it alone gives the ELBO and Adam's state) for the window's
    first :data:`STEPS` steps, on the window's own schedule: each step's ELBO
    (``elbo_gap``), the first gradient from the optimizer's first moment
    (``grad_gap``) and the parameters' change after the steps
    (``change_gap``), each row by its worst step or leaf, and each number the
    :data:`QUANTILE` of the rows, so that a fault in more than 1 % of the rows
    shows;
- **the window's answers** (:func:`answer_numbers`): every round of a sample
  of the window's batches (drawn from the seed) judged again by the reference
  metric, and each batch's bookkeeping (which problems each round re-attacked,
  which restart each kept) replayed by the reference engine.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness.traffic import seed_of
from benchmark.reference import engine as ref_engine
from benchmark.reference import metric as ref_metric
from benchmark.reference import model as ref

STEPS = 3
# the rows' quantile compared: a sphere centre on a cell face falls in either
# cell at float32's rounding and moves a few rows by a cell's difference
QUANTILE = 0.99
BLOCK = 64  # rows a block of the reference


def draws(gen: torch.Generator, B: int, S: int, L: int, nb: int, Mc: int, device) -> ref.Draws:
    """One pathwise draw's numbers in float32: Student-t(5) by Bailey's polar
    method, uniform phases on [0, 2π), standard normal weights and
    perturbations."""
    f = dict(dtype=torch.float32, device=device, generator=gen)
    u = 1.0 - torch.rand((B, L, nb), **f)
    v = torch.rand((B, L, nb), **f)
    t = torch.sqrt(5.0 * (u ** (-2.0 / 5.0) - 1.0)) * torch.cos(ref.TWO_PI * v)
    return ref.Draws(t, ref.TWO_PI * torch.rand((B, L, nb), **f), torch.randn((B, S, L, nb), **f),
                     torch.randn((B, S, L, Mc), **f))


def row_leaf_gaps(prog: Dict[str, torch.Tensor], refv: Dict[str, torch.Tensor], ref_grad: Dict) -> torch.Tensor:
    """Each row's worst leaf: the gap between the program's norm of the row's
    leaf and the reference's, against the reference's norm of that leaf or of
    the row's median leaf, whichever is larger; a leaf whose reference
    gradient in the row is under a thousandth of the row's median leaf's is
    left out. ``[B]``."""
    rows = lambda x: x.to(ref.F64).reshape(x.shape[0], -1)
    norm = lambda d: torch.stack([rows(d[k]).norm(dim=1) for k in ref.LEAVES], dim=1)
    gn, rn, pn = norm(ref_grad), norm(refv), norm(prog)                       # [B, leaves]
    keep = gn >= 1e-3 * gn.median(dim=1, keepdim=True).values
    denom = torch.maximum(rn, rn.median(dim=1, keepdim=True).values).clamp(min=1e-300)
    return torch.where(keep, (pn - rn).abs() / denom, torch.zeros_like(rn)).amax(dim=1)


def _quantiles(x: torch.Tensor) -> List[float]:
    q = torch.tensor([0.5, 0.9, 0.99, 1.0], dtype=ref.F64, device=x.device)
    return [float(v) for v in torch.quantile(x.to(ref.F64), q)]


def _reference_steps(pb: ref.Problem, train: Dict, s64, g64, X, steps: List[ref.Draws]):
    """The reference's Adam steps from the linear init: ``(params, initial
    params, ELBO [B, steps], first gradient)``."""
    p = ref.init_linear(pb, s64, g64)
    p_init = {k: v.clone() for k, v in p.items()}
    adam = ref.Adam(train, p)
    vals, grad1 = [], None
    for d in steps:
        v, g = ref.elbo_and_grad(pb, p, s64, g64, X, d, BLOCK)
        grad1 = g if grad1 is None else grad1
        vals.append(v)
        p = adam.step(p, g)
    return p, p_init, torch.stack(vals, dim=1), grad1


def model_numbers(system, pb: ref.Problem, starts: np.ndarray, goals: np.ndarray, seed: int,
                  mine: slice = slice(None)) -> Dict[str, float]:
    """The model comparison on ``starts``/``goals`` (the window's first
    batch, every rank's rows), this process judging the rows ``mine``; see
    the module's docstring."""
    from vgpmp_torch.engine import solver
    from vgpmp_torch.gp.pathwise import PathNoise

    model, cfg, dev = system.model, system.train, system.device
    B, L, S = len(starts), pb.L, int(system.pp["num_samples"])
    nb, Mc = int(system.pp.get("num_bases", 1024)), int(system.pp["num_inducing"]) + 2
    gen = torch.Generator(device=dev).manual_seed(seed_of(seed, 0, 2))
    steps = [draws(gen, B, S, L, nb, Mc, dev) for _ in range(STEPS)]
    post = draws(gen, B, cfg.num_posterior_samples, L, nb, Mc, dev)
    pn = lambda d, rows=slice(None): PathNoise(*(x[rows] for x in d))
    p0 = solver.init_slots(model, starts, goals, system.pp, ["linear"] * B)

    # the window's round solver, STEPS steps on the whole batch
    cfg_r = dataclasses.replace(cfg, num_steps=STEPS)
    best, reps = system.round_solver(cfg_r)(p0, starts, goals,
                                            noise=solver.SolveNoise([pn(d) for d in steps], pn(post)))
    best = best[mine].detach()
    reps = {f: getattr(reps, f)[mine] for f in ("executed", "success", "min_clearance")}

    # its step body on this process's rows, the window's first STEPS steps
    s, g = starts[mine], goals[mine]
    init_state, train_chunk, _ = solver.make_resumable_solver(model, cfg)
    p0 = p0.map(lambda x: x[mine])
    st1, h1, _ = train_chunk(init_state(p0), s, g, noise=solver.SolveNoise([pn(steps[0], mine)], None), n=1)
    g1 = {k: getattr(st1.mu, k).detach() / (1.0 - cfg.beta1) for k in ref.LEAVES}
    st3, h23, _ = train_chunk(st1, s, g, noise=solver.SolveNoise([pn(d, mine) for d in steps[1:]], None),
                              n=STEPS - 1)
    elbo_p = torch.cat([h1, h23], dim=1).detach().to(ref.F64)
    change_p = {k: (getattr(st3.params, k) - getattr(p0, k)).detach() for k in ref.LEAVES}
    del st1, st3, p0
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, in float64, on the same draws
    s64, g64 = (torch.as_tensor(x, dtype=ref.F64, device=dev) for x in (s, g))
    X = torch.linspace(0.0, 1.0, int(system.pp["time_spacing_X"]), dtype=ref.F64, device=dev)
    Xnew = torch.linspace(0.0, 1.0, int(system.pp["time_spacing_Xnew"]), dtype=ref.F64, device=dev)
    ref_draws = [ref.Draws(*(x[mine] for x in d)) for d in steps]
    train = lambda c: dict(pb.pp, **{k: getattr(c, k) for k in ("beta1", "beta2", "num_steps", "warmup_steps",
                                                               "lr_peak", "learning_rate")}, adam_eps=1e-8)
    p, p_init, elbo_r, grad1 = _reference_steps(pb, train(cfg), s64, g64, X, ref_draws)
    change_r = {k: p[k] - p_init[k] for k in ref.LEAVES}
    p, *_ = _reference_steps(pb, train(cfg_r), s64, g64, X, ref_draws)
    best_r, sigma = ref.best_samples(pb, p, s64, g64, Xnew, ref.Draws(*(x[mine] for x in post)), BLOCK)
    n = len(s)
    with torch.no_grad():
        picked = torch.cat([ref.log_prob(pb, best[i:i + BLOCK].to(ref.F64), sigma[i:i + BLOCK]).sum(-1)
                            for i in range(0, n, BLOCK)])
    rows = {"elbo": ((elbo_p - elbo_r).abs() / elbo_r.abs().clamp(min=1.0)).amax(dim=1),
            "grad": row_leaf_gaps(g1, grad1, grad1),
            "change": row_leaf_gaps(change_p, change_r, grad1),
            "best": torch.clamp(best_r - picked, min=0.0) / best_r.abs().clamp(min=1.0)}
    q = lambda x: float(torch.quantile(x, QUANTILE))
    return {
        "elbo_gap": q(rows["elbo"]),
        "grad_gap": q(rows["grad"]),
        "change_gap": q(rows["change"]),
        "best_gap": float(rows["best"].max()),
        "_verdicts": verdict_counts(pb, best, s, g, reps, dev),
        "_quantiles": {k: _quantiles(v) for k, v in rows.items()},
    }


def verdict_counts(pb: ref.Problem, best, starts, goals, reps: Dict, device) -> Dict[str, int]:
    """Rows whose verdicts (executed, success) differ from the reference
    metric's where a probe decides them, or whose worst clearance differs by
    more than :data:`ref_metric.DECISIVE_M`; and rows no probe decides."""
    best = torch.as_tensor(best, device=device)
    as64 = lambda x: torch.as_tensor(np.asarray(x), dtype=best.dtype, device=device)
    j = ref_metric.judge(pb, best, as64(starts), as64(goals))
    get = lambda k: torch.as_tensor(np.asarray(reps[k]) if not torch.is_tensor(reps[k]) else reps[k],
                                    device=device)
    mc_p = get("min_clearance").to(ref.F64)
    mc_r = j["min_clearance"]
    both_nan = torch.isnan(mc_p) & torch.isnan(mc_r)
    mc_bad = ~both_nan & ~((mc_p - mc_r).abs() <= ref_metric.DECISIVE_M)
    decided = ~j["undecided"]
    verdict_bad = decided & ((get("executed").bool() != j["executed"]) | (get("success").bool() != j["success"]))
    return {"rows": int(best.shape[0]), "mismatch": int((verdict_bad | mc_bad).sum()),
            "undecided": int(j["undecided"].sum())}


def answer_numbers(system, pb: ref.Problem, records: List[Dict], max_rounds: int) -> Dict[str, int]:
    """The window's answers in the sampled batches ``records`` (see
    :meth:`program.System.run_batch`): every round's verdicts against the
    reference metric, and the engine's bookkeeping replayed."""
    out = {"rows": 0, "mismatch": 0, "undecided": 0, "choice_mismatch": 0}
    for rec in records:
        rounds = []
        for r in rec["rounds"]:
            reps = {f: getattr(r["reps"], f) for f in ("executed", "success", "min_clearance")}
            v = verdict_counts(pb, r["best"], r["starts"], r["goals"], reps, system.device)
            for k in ("rows", "mismatch", "undecided"):
                out[k] += v[k]
            rounds.append({"starts": r["starts"], "goals": r["goals"],
                           "best": r["best"].detach().cpu().numpy(),
                           **{f: reps[f].detach().cpu().numpy() for f in reps}})
        answer = {"best": rec["best"], **{f: np.asarray(v) for f, v in rec["reps"].items()}}
        rp = ref_engine.replay(rec["starts"], rec["goals"], rounds, max_rounds, system.round_sizes,
                               system.dp, answer)
        out["choice_mismatch"] += rp["slots"] + rp["answers"] + rp["rounds"]
    return out


def sample_batches(n: int, seed: int, count: int = 2) -> List[int]:
    """``count`` of the window's ``n`` batches, drawn from the seed."""
    rng = np.random.default_rng(seed_of(seed, 0, 3))
    return sorted(rng.choice(n, size=min(n, count), replace=False).tolist())


def judge_all(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """Each number beside its limit; a number passes at or below its limit
    (a NaN never passes)."""
    out = {}
    for k, v in numbers.items():
        lim = float(limits[k])
        out[k] = {"value": v, "limit": lim, "ok": bool(v <= lim) and not math.isnan(v)}
    return out
