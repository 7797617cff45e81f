"""The pathwise draw and evaluation of one solve step: random Fourier
features of the prior at the inducing inputs and the time grid, their
contraction with the basis weights, the update's contraction, and the
float64 factorisation and solve that share the conditioned Gram."""

from __future__ import annotations

from benchmark.harness import peaks
from benchmark.work import k2


def work(B: int, S: int, L: int, N: int, nb: int, Mc: int) -> dict:
    """Operations and bytes of ``B`` rows, ``S`` samples, ``L`` latents, a
    grid of ``N``, ``nb`` bases and ``Mc`` inducing inputs:

    - cosines: B L (N + Mc) nb, at :data:`peaks.COS_FLOPS` each;
    - the prior's contractions Φ w at the grid and the inducing inputs:
      2 B S L (N + Mc) nb;
    - the update's contraction Aᵀ a: 2 B S L Mc N;
    - float64: one fused factorisation and solve per (row, latent) of the
      Mc x Mc Gram with S + N + 1 right-hand sides (:func:`k2.work`);
    - bytes: the samples written once (float32), the factor and the solves'
      operands as :func:`k2.work` counts them (float64). The weights are
      random numbers a kernel can make where it uses them, so they are not
      counted as moved.
    """
    cos = B * L * (N + Mc) * nb
    f32 = peaks.COS_FLOPS * cos + 2 * B * S * L * (N + Mc) * nb + 2 * B * S * L * Mc * N
    values, ops = k2.work("pair", Mc, S + N + 1)
    f64 = B * L * ops
    nbytes = 4 * B * S * N * L + 8 * B * L * values
    t = max(f32 / peaks.F32_FLOPS + f64 / peaks.F64_TC_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)
    return {"f32_flops": f32, "f64_flops": f64, "bytes": nbytes, "least_s": t}
