"""The system under test, as the benchmark drives it: ``vgpmp_torch``'s
planning session for a cell's configuration, its round solver (sharded over
the ranks of a four-card cell), the warm-up of the cell's bucket shapes, and
one batch of traffic through ``solve_adaptive``.

Nothing else in the benchmark imports the program.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import traffic as traffic_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "vgpmp_tpu")
EXTRA_ROUNDS = 2  # rounds after one a restart init, as the program's own bench runs it


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


class System:
    """One process's share of a cell: the session on ``device``, its round
    solver and the cell's traffic. ``mesh`` is the rank mesh of a sharded
    cell (None on one card). ``overrides`` go onto the configuration's
    planner parameters (a control or a test's small budget)."""

    def __init__(self, cell: Dict, device, mesh=None, overrides: Optional[Dict] = None):
        from vgpmp_torch import _build
        from vgpmp_torch.engine import solver
        from vgpmp_torch.session import PlanningSession

        self.cell, self.device, self.mesh = cell, torch.device(device), mesh
        self.times: Dict[str, float] = {}
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            _build.build()
        self.times["extension_s"] = time.perf_counter() - t0
        cfg, tr = cell["config"], cell["traffic"]
        pp = dict(cfg["planner_params"], **(overrides or {}))
        t0 = time.perf_counter()
        sess = PlanningSession(cfg["robot"], cfg["problemset"], dtype=torch.float32, sdf_mode="packed",
                               use_tuned=True, overrides=pp, device=self.device)
        if sess.planner_params != pp:
            raise RuntimeError(f"the session runs {sess.planner_params}, not the configuration's {pp}")
        want = cfg["train"]
        got = {k: getattr(sess.train_config, k) for k in ("beta1", "beta2", "num_posterior_samples")}
        if any(got[k] != want[k] for k in got):
            raise RuntimeError(f"the session trains with {got}, the configuration states {want}")
        self.sess, self.model, self.pp = sess, sess.model, pp
        self.train = dataclasses.replace(sess.train_config, ee_uncertainty=False)
        self.inits = tuple(pp["q_mu_inits"])
        self.max_rounds = len(self.inits) + EXTRA_ROUNDS
        self.rows = int(tr["rows"])
        self.round_sizes = tuple(int(c) for c in tr["round_sizes"])
        self.solve = self.round_solver(sess.train_config)
        self.starts, self.goals = traffic_mod.queries(sess.states)
        self.times["session_s"] = time.perf_counter() - t0

    def round_solver(self, train):
        """The window's round solver on this process's model, with the
        training configuration ``train``: ``make_round_solver``, or on a rank
        mesh ``make_sharded_round_solver``."""
        from vgpmp_torch.engine import solver

        if self.mesh is None:
            return solver.make_round_solver(self.model, train)
        from vgpmp_torch.parallel.sharded import make_sharded_round_solver

        return make_sharded_round_solver(self.model, train, self.mesh)

    @property
    def dp(self) -> int:
        return 1 if self.mesh is None else self.mesh.dp

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm_up(self) -> None:
        """Every shape the cell's traffic runs, once: at each bucket size (this
        rank's share of it) two Adam steps, the extraction and the metric, the
        restarts' clearance probes and, on a sharded cell, the collectives."""
        from vgpmp_torch.engine import solver
        from vgpmp_torch.engine.validator import execute_and_validate

        t0 = time.perf_counter()
        init_state, train_chunk, extract = solver.make_resumable_solver(self.model, self.train)
        gen = torch.Generator(device=self.device).manual_seed(0)
        for C in sorted(set(self.round_sizes)):
            n = -(-min(C, self.rows) // self.dp) * self.dp // self.dp
            s, g = traffic_mod.batch(self.starts, self.goals, n, 0)
            p = solver.init_slots(self.model, s, g, self.pp, ["linear"] * n)
            st, _, _ = train_chunk(init_state(p), s, g, gen, n=2)
            res = extract(st, s, g, gen)
            as_t = lambda x: torch.as_tensor(x, dtype=self.model.dtype, device=self.device)
            execute_and_validate(self.model.collision, res.best, as_t(s), as_t(g),
                                 self.model.limits_low, self.model.limits_high)
            solver.restart_waypoints(self.model, s, g, "frand0")
            solver.worst_violation_configs(self.model.collision, res.best.detach().cpu().numpy())
            if self.mesh is not None:
                from vgpmp_torch.parallel.sharded import gather_rows

                gather_rows(res.best, self.mesh)
                gather_rows(torch.ones(n, dtype=torch.bool, device=self.device), self.mesh)
            del st, res
        self.sync()
        self.times["warm_up_s"] = time.perf_counter() - t0

    def run_batch(self, k: int, seed: int, sink: Optional[list] = None) -> Dict:
        """Batch ``k`` of a run seeded ``seed`` through ``solve_adaptive``
        (:func:`traffic.pool_batch`). With ``sink``
        each round's inputs and outputs are kept (references, no copies), and
        the batch's own record is appended to it last."""
        from vgpmp_torch.engine import solver

        tr = self.cell["traffic"]
        j, batch_seed = traffic_mod.pool_batch(seed, k, int(tr["pool"]))
        starts, goals = traffic_mod.batch(self.starts, self.goals, self.rows, j)
        rounds: List[Dict] = []
        inner = self.solve

        def solve(params, s, g, generator=None, noise=None):
            best, reps = inner(params, s, g, generator, noise)
            rounds.append({"starts": np.asarray(s), "goals": np.asarray(g), "best": best, "reps": reps})
            return best, reps

        solve.dp_size = getattr(inner, "dp_size", 1)
        best, reps, info = solver.solve_adaptive(
            self.model, self.train, starts, goals, self.pp, inits=self.inits, max_rounds=self.max_rounds,
            seed=batch_seed, solve=solve, round_sizes=self.round_sizes)
        if sink is not None:
            sink.append({"k": k, "starts": starts, "goals": goals, "best": best,
                         "reps": {f: getattr(reps, f) for f in ("executed", "success", "min_clearance")},
                         "rounds": rounds})
        failed = int((~np.isfinite(best).reshape(len(best), -1).all(axis=1)).sum())
        return {"rows": len(starts), "executed": int(np.sum(reps.executed)), "failed": failed,
                "rounds": int(info["rounds"]), "spent": int(info["spent"])}


def init_ranks(rank: int, world: int, port: int, device, backend: str):
    """Join the cell's ranks over ``tcp://localhost:<port>`` and return this
    rank's mesh (dp over every rank)."""
    from vgpmp_torch.parallel import mesh as mesh_mod

    mesh_mod.init_distributed(f"localhost:{port}", world, rank, backend=backend, device=device)
    return mesh_mod.make_mesh(1, device=device)


def launch_counts() -> Dict[str, int]:
    """The program's own launch counters of K1 and K2."""
    from vgpmp_torch.likelihoods import collision as col
    from vgpmp_torch.ops import linalg as la

    return {"k1": int(col.k1_loglik.launches),
            "k2": int(sum(f.launches for f in (la.k2_chol, la.k2_trsm, la.k2_factor_solve,
                                               la.k2_factor_solve_bwd)))}


def stage_calls(system: System, starts: np.ndarray, goals: np.ndarray, seed: int) -> Dict:
    """Two stages of the step as calls through the program's public entries,
    on the cell's round-0 shapes (``starts``/``goals``, this rank's rows):

    - ``k1``: the collision likelihood and its d/dq
      (``model.collision.log_prob``, then autograd) at configurations
      ``q [B, S, N, L]`` along each query's straight line with Gaussian noise
      of 0.15 rad, within the joint box, at the problemset's σ;
    - ``rff``: the pathwise draw and evaluation
      (``gp.pathwise.draw_and_eval_paths``) at the linear initial state, on
      the conditioned Gram and cross-covariance of the training grid.
    """
    from vgpmp_torch.engine import solver
    from vgpmp_torch.gp import conditioned, pathwise
    from vgpmp_torch.models import vgpmp as planner
    from vgpmp_torch.ops.kernels import KERNELS

    model, dev, pp = system.model, system.device, system.pp
    B, S, N = len(starts), int(pp["num_samples"]), int(pp["time_spacing_X"])
    gen = torch.Generator(device=dev).manual_seed(seed)
    s, g = (torch.as_tensor(x, dtype=model.dtype, device=dev) for x in (starts, goals))
    frac = torch.linspace(0, 1, N, dtype=model.dtype, device=dev)[None, None, :, None]
    q = s[:, None, None] + (g - s)[:, None, None] * frac
    q = q + 0.15 * torch.randn((B, S, N, q.shape[-1]), generator=gen, dtype=model.dtype, device=dev)
    q = torch.minimum(torch.maximum(q, model.limits_low), model.limits_high).contiguous()
    sigma = torch.full((B, model.collision.fk.sphere_radii.shape[0]), float(pp["sigma_obs"]),
                       dtype=model.dtype, device=dev)

    def k1():
        qq = q.detach().requires_grad_(True)
        return torch.autograd.grad(model.collision.log_prob(qq, sigma).sum(), qq)[0]

    c = planner.constrain(solver.init_slots(model, starts, goals, pp, ["linear"] * B), model.variance_lower)
    X = torch.linspace(0.0, 1.0, N, dtype=model.dtype, device=dev)
    kern = KERNELS[model.kernel]
    kuu = conditioned.kuu(kern, model.ny, c["Z"], c["lengthscales"], c["variance"], jitter=model.jitter,
                          solve_dtype=model.solve_dtype)
    kuf = conditioned.kuf(kern, model.ny, c["Z"], X, c["lengthscales"], c["variance"],
                          solve_dtype=model.solve_dtype)
    q_mu_full = torch.cat([planner.query_latent(model, s, g), c["q_mu"]], dim=-2)

    def rff():
        return pathwise.draw_and_eval_paths(model.ny, c["Z"], c["lengthscales"], c["variance"], kuu, kuf, X,
                                            q_mu_full, c["q_sqrt"], model.num_samples, model.num_bases,
                                            jitter=model.jitter, generator=gen)

    return {"k1": k1, "rff": rff, "q": q, "sigma": sigma}
