#!/usr/bin/env python3
"""The GP "Gram leg" piece by piece on the card (the port's
``tools/gram_bench.py``), with its roofline arithmetic against the H100's
published peaks.

    python tools/gram_bench_torch.py [--batch 36] [--reps 20] [--json-out PATH] [--device cpu]

At the bench's shapes (franka/industrial: L 7, M 10, Mc 12, N 50, S 20,
1024 bases, ``--batch`` problems), on the JAX tool's seeded inputs:

1. the Gram build and Cholesky (``gp/conditioned.py:cholesky_kuu``) in
   float64 (``gram_chol_f64``) and in float32 with jitter 1e-6
   (``gram_chol_f32``; ``k2_chol`` in either dtype on the card);
2. the Student-t spectral draw: Bailey's polar method
   (``gp/pathwise.py:student_t``) beside ``torch.distributions.StudentT``'s
   gamma-based sampler;
3. the whole pathwise draw and evaluation (``draw_paths``,
   ``conditioned.kuf``, ``eval_paths``; ``k2_trsm`` on the card);
4. the RFF features and prior evaluation alone;
5. the conditioned prior KL (``gp/kl.py:prior_kl``; ``k2_trsm``).

Each piece is timed by :func:`vgpmp_torch.timing.time_stages`: stream ms
(CUDA events) and device ms (profiler) per call. The JAX tool's round-4
formulation is not ported: no session of either package runs the round-4
draw.

Writes the JAX tool's keys (stream ms) plus ``device_ms``, ``launches``,
``kernels`` and ``card`` to ``--json-out``, by default
``chiprun_out/gram_bench_torch.json``. Runs on the CUDA device and raises
without one unless given ``--device cpu`` (host ms, no device fields).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

L, M, C = 7, 10, 2
MC = M + C
N, S, BR = 50, 20, 1024
DF = 5.0
# H100 SXM published peaks (NVIDIA data sheet): float32 outside the tensor
# cores, HBM3 bytes/s
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# a cosine on the special-function units: 16 a clock per SM against 128
# float32 lanes, so one costs 8 float32 issue slots
COS_FLOPS = 8


def inputs(batch: int, device) -> dict:
    """The JAX tool's inputs from ``default_rng(0)``, float32 on ``device``."""
    r = np.random.default_rng(0)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return {
        "ny": f32([0.0, 1.0]),
        "Z": f32(np.linspace(0.1, 0.9, M)[:, None].repeat(L, 1)).expand(batch, M, L),
        "ls": f32(r.uniform(0.3, 2.0, (batch, L))),
        "s2": f32(r.uniform(0.2, 0.6, (batch, L))),
        "q_mu_full": f32(r.normal(size=(batch, MC, L)) * 0.5),
        "q_sqrt": f32(np.tril(0.05 * r.normal(size=(batch, L, M, M))) + np.eye(M)),
        "X": torch.linspace(0.0, 1.0, N, dtype=torch.float32, device=device),
    }


def gram_chol_f64(inp: dict) -> torch.Tensor:
    """Piece 1: ``chol(Kuu)`` ``[B, L, Mc, Mc]`` built and factored in float64."""
    from vgpmp_torch.gp import conditioned
    from vgpmp_torch.ops.kernels import matern52

    return conditioned.cholesky_kuu(matern52, inp["ny"], inp["Z"], inp["ls"], inp["s2"], jitter=1e-9,
                                    solve_dtype=torch.float64)[1]


def gram_chol_f32(inp: dict) -> torch.Tensor:
    """Piece 1, float32: ``chol(Kuu)`` built and factored in float32 with
    jitter 1e-6, as the JAX tool's ``gram_chol_f32`` (no escalation)."""
    from vgpmp_torch.gp import conditioned
    from vgpmp_torch.ops.kernels import matern52

    return conditioned.cholesky_kuu(matern52, inp["ny"], inp["Z"], inp["ls"], inp["s2"], jitter=1e-6)[1]


def kl_leg(inp: dict, chol: torch.Tensor) -> torch.Tensor:
    """Piece 5: the conditioned prior KL per problem, ``[B]`` float64."""
    from vgpmp_torch.gp import kl

    qm, f64 = inp["q_mu_full"], torch.float64
    return kl.prior_kl(chol @ chol.mT, chol, qm[:, C:].to(f64), inp["q_sqrt"].to(f64),
                       qm[:, :C].to(f64))


def pieces(inp: dict, device) -> dict:
    """Each piece as a call on inputs it holds."""
    from vgpmp_torch.gp import conditioned, pathwise
    from vgpmp_torch.ops import rff
    from vgpmp_torch.ops.kernels import matern52

    B = inp["ls"].shape[0]
    gen = torch.Generator(device=device).manual_seed(0)
    chol = gram_chol_f64(inp)
    df = torch.tensor(DF, dtype=torch.float32, device=device)

    def draw_eval():
        st = pathwise.draw_paths(inp["ny"], inp["Z"], inp["ls"], inp["s2"], chol, inp["q_mu_full"],
                                 inp["q_sqrt"], S, BR, jitter=1e-9, generator=gen)
        kuf = conditioned.kuf(matern52, inp["ny"], inp["Z"], inp["X"], inp["ls"], inp["s2"],
                              solve_dtype=torch.float64)
        return pathwise.eval_paths(st, kuf, inp["X"])

    def rff_only():
        t = pathwise.student_t(DF, (B, L, BR), torch.float32, device, gen)
        omega = t / inp["ls"][..., None]
        phase = pathwise.TWO_PI * torch.rand((B, L, BR), generator=gen, device=device)
        w = torch.randn((B, S, L, BR), generator=gen, device=device)
        scale = torch.sqrt(2.0 * inp["s2"][..., None] / BR)
        return rff.prior_paths(inp["X"].expand(B, L, N), omega, phase, scale, w)

    return {
        "gram_chol_f64": lambda: gram_chol_f64(inp),
        "gram_chol_f32": lambda: gram_chol_f32(inp),
        "student_t_bailey": lambda: pathwise.student_t(DF, (B, L, BR), torch.float32, device, gen),
        "student_t_gamma": lambda: torch.distributions.StudentT(df).sample((B, L, BR)),
        "draw_eval_r5": draw_eval,
        "rff_eval": rff_only,
        "kl": lambda: kl_leg(inp, chol),
    }


def roofline(batch: int, rff_device_ms) -> dict:
    """The RFF prior evaluation's least time on an H100: cos features
    ``[B, L, N, bases]`` and the ``[B, S, L, N] x [bases]`` contraction
    against float32 outside the tensor cores, and its operands (the
    frequencies, phases and weights read once, the prior paths written once)
    against HBM."""
    cos_evals = batch * L * N * BR
    mac_flops = 2 * batch * S * L * N * BR
    nbytes = 4 * (2 * batch * L * BR + batch * S * L * BR + batch * S * L * N)
    t_ops = (mac_flops + COS_FLOPS * cos_evals) / F32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    return {"rff_cos_evals": cos_evals, "rff_mac_flops": mac_flops, "rff_bytes": nbytes,
            "rff_flops_bound_ms": t_ops, "rff_bytes_bound_ms": t_bytes, "rff_bound_ms": bound,
            "rff_bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "rff_share_of_bound": None if rff_device_ms is None else bound / rff_device_ms,
            "peaks": {"f32_flops": F32_FLOPS, "hbm_bytes_per_s": HBM_BYTES_PER_S,
                      "cos_flops": COS_FLOPS},
            "note": "H100 SXM peaks (float32 outside the tensor cores, HBM3); a cosine counts "
                    f"{COS_FLOPS} float32 operations; the measured piece also draws its frequencies, "
                    "phases and weights, which the bound counts as read once"}


def run(batch: int = 36, reps: int = 20, device=None) -> dict:
    """Time every piece; returns the record ``main`` writes."""
    from vgpmp_torch import _build, resolve_device
    from vgpmp_torch.ops import linalg as la
    from vgpmp_torch.timing import card, time_stages

    device = resolve_device(device)
    if device.type == "cuda":
        _build.build()
    inp = inputs(batch, device)
    for c in (la.k2_chol, la.k2_trsm):
        c.launches, c.launches_by = 0, {}
    times = time_stages(pieces(inp, device), reps, device)
    out = {"device": str(device), "card": card(device),
           "shapes": dict(batch=batch, L=L, M=M, Mc=MC, N=N, S=S, B_rff=BR), "reps": reps}
    for name, t in times.items():
        out[f"{name}_ms"] = t["stream_ms"]
        dev_ms = "not measured" if t["device_ms"] is None else f"{t['device_ms']:.4f} ms device"
        print(f"{name:<18s} {t['stream_ms']:9.4f} ms {'stream' if device.type == 'cuda' else 'host'}, "
              f"{dev_ms}", flush=True)
    out["device_ms"] = {k: t["device_ms"] for k, t in times.items()}
    out["launches"] = {k: t["launches"] for k, t in times.items()}
    out["kernels"] = {k: t["kernels"] for k, t in times.items()}
    out["kernel_launches"] = {c.__name__: c.launches for c in (la.k2_chol, la.k2_trsm)}
    out["kernel_launches_by_dtype"] = {c.__name__: dict(c.launches_by) for c in (la.k2_chol, la.k2_trsm)}
    out["roofline"] = roofline(batch, out["device_ms"]["rff_eval"])
    print(f"roofline: RFF prior evaluation bound {out['roofline']['rff_bound_ms']:.4f} ms "
          f"({out['roofline']['rff_bound_by']})", flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=36)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json-out", default=str(ROOT / "chiprun_out" / "gram_bench_torch.json"))
    ap.add_argument("--device", default=None, help="'cpu' for the plain path; default: CUDA")
    args = ap.parse_args(argv)
    out = run(args.batch, args.reps, args.device)
    path = Path(args.json_out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print("wrote", path)
    return out


if __name__ == "__main__":
    main()
