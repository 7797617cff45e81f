"""One rank of the gloo world that ``tests/test_torch_parallel.py`` starts on
the CPU (not a test module).

    python tests/_torch_parallel_worker.py DIR RANK WORLD PORT

reads ``DIR/spec.npz`` (inputs and injected draws, written by the test),
joins the world over a TCP rendezvous on ``127.0.0.1:PORT``, runs every
scenario in one order on every rank, and writes ``DIR/rank<RANK>.npz``. It
imports no JAX.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from _torch_support import torch_planner_model  # noqa: E402
from vgpmp_torch.convert import params_from_numpy  # noqa: E402
from vgpmp_torch.engine import solver  # noqa: E402
from vgpmp_torch.gp.pathwise import PathNoise  # noqa: E402
from vgpmp_torch.models import vgpmp as planner  # noqa: E402
from vgpmp_torch.parallel import init_distributed, make_mesh, make_sharded_round_solver, make_sharded_solver  # noqa: E402

CFG = solver.TrainConfig(num_steps=6, learning_rate=0.05, time_spacing_X=8, time_spacing_Xnew=10,
                         num_posterior_samples=4)
PLANNER_PARAMS = {"lengthscales": [1.5] * 7, "variance": 0.2, "sigma_obs": 0.005, "alpha": 100.0}


def noise_from(spec, prefix):
    """A ``SolveNoise`` stored under ``prefix`` (``<prefix>_step<i>_<field>``)."""
    path = lambda key: PathNoise(*(torch.as_tensor(spec[f"{prefix}_{key}_{f}"]) for f in PathNoise._fields))
    return solver.SolveNoise([path(f"step{i}") for i in range(CFG.num_steps)], path("post"))


def mesh_record(mesh):
    return np.array([mesh.dp, mesh.sp, mesh.dp_index, mesh.sp_index, *mesh.dp_ranks, -1, *mesh.sp_ranks])


def nccl_rules():
    """Make every ``all_reduce`` and ``broadcast`` refuse what NCCL refuses and
    gloo takes: a non-contiguous tensor."""
    import torch.distributed as dist

    for name in ("all_reduce", "broadcast"):
        def checked(tensor, *args, _fn=getattr(dist, name), _name=name, **kw):
            if not tensor.is_contiguous():
                raise ValueError(f"{_name} of a non-contiguous tensor (NCCL refuses it)")
            return _fn(tensor, *args, **kw)

        setattr(dist, name, checked)


def main():
    out_dir, rank, world, port = Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    nccl_rules()
    spec = np.load(out_dir / "spec.npz")
    init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo", device="cpu")
    model = torch_planner_model(num_samples=2, num_bases=32, num_inducing=4, jitter=1e-9)
    starts, goals, mask = spec["starts"], spec["goals"], spec["mask"]
    p0 = params_from_numpy({k: spec[f"p0_{k}"] for k in planner.PlannerParams.names()})
    out = {}

    # dp = 4: the generator path, JAX's injected draws, the adaptive engine
    dp4 = make_mesh(1, device="cpu")
    out["mesh_dp4"] = mesh_record(dp4)
    solve = make_sharded_solver(model, CFG, dp4)
    for name, kw in (("gen", dict(generator=torch.Generator().manual_seed(7))),
                     ("jax", dict(noise=noise_from(spec, "dp")))):
        res, metrics = solve(p0, starts, goals, mask=mask, **kw)
        for f in ("best", "mean", "elbo_history", "failed", "best_score", "ee_uncertainty"):
            out[f"{name}_{f}"] = getattr(res, f).numpy()
        for k, v in metrics.items():
            out[f"{name}_metric_{k}"] = v.numpy()

    round_solve = make_sharded_round_solver(model, CFG, dp4)
    sizes = []

    def counted(params, s, g, generator):
        sizes.append(len(s))
        return round_solve(params, s, g, generator)

    counted.dp_size = round_solve.dp_size
    best, reps, info = solver.solve_adaptive(model, CFG, starts, goals, PLANNER_PARAMS,
                                             inits=("linear", "zeros", "rand0", "frand1"),
                                             max_rounds=4, seed=3, solve=counted, round_sizes=(8, 3))
    out["adaptive_best"] = best
    out.update({f"adaptive_rep_{k}": v for k, v in reps._asdict().items() if v is not None})
    out["adaptive_info"] = np.array(json.dumps({**info, "sizes": sizes}))

    # dp = 2 x sp = 2: JAX's per-shard draws, the generator path, the gradient probe
    sp2 = make_mesh(2, device="cpu")
    out["mesh_sp2"] = mesh_record(sp2)
    solve = make_sharded_solver(model, CFG, sp2)
    lik_means = []
    sample_mean = planner.sample_mean

    def recording(x, group):
        y = sample_mean(x, group)
        lik_means.append(y.detach().clone())
        return y

    planner.sample_mean = recording
    try:
        res, _ = solve(p0.map(lambda x: x[:4]), starts[:4], goals[:4],
                       noise=noise_from(spec, f"sp{sp2.sp_index}"))
    finally:
        planner.sample_mean = sample_mean
    out["sp_best"], out["sp_elbo_history"] = res.best.numpy(), res.elbo_history.numpy()
    out["sp_lik_means"] = torch.stack(lik_means).numpy()
    res, _ = solve(p0.map(lambda x: x[:4]), starts[:4], goals[:4], generator=torch.Generator().manual_seed(5))
    out["spgen_best"], out["spgen_elbo_history"] = res.best.numpy(), res.elbo_history.numpy()

    w = torch.as_tensor(spec["probe_w"]).requires_grad_(True)
    x = torch.as_tensor(spec["probe_x"][sp2.sp_index])
    value = planner.sample_mean(torch.sin(x @ w).mean()[None], sp2.sp_group)
    (grad,) = torch.autograd.grad(value.sum(), [w])
    out["probe_value"], out["probe_grad"] = value.detach().numpy(), grad.numpy()

    # best-sample selection over sample groups of 2 (the dp rows of sp2) and of 4
    for name, mesh in (("sel2", sp2), ("sel4", make_mesh(4, device="cpu"))):
        k = mesh.sp_index
        out[name] = planner.select_best(torch.as_tensor(spec["sel_scores"][k]),
                                        torch.as_tensor(spec["sel_samples"][k]), mesh.sp_group).numpy()
    np.savez(out_dir / f"rank{rank}.npz", **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
