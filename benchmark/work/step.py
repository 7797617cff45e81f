"""One Adam step of the batched solve: the ELBO's forward, its backward and
the update, counted from the cell's shapes; the least time of the step is
each term at its dtype's peak."""

from __future__ import annotations

from benchmark.harness import peaks
from benchmark.work import k2, rff


def least_s(B: int, S: int, L: int, N: int, nb: int, M: int, P: int, active_share: float = 0.0) -> float:
    """Seconds an H100 needs at least for one step of ``B`` rows:

    - forward: :func:`rff.work`'s operations; the Gram (~20 operations an
      entry of B L Mc²) in float64; the collision stage's FK and hinge
      (B S N (60 L + 30 P));
    - backward: the prior contraction's gradient with respect to the features
      (2 B S L (N + Mc) nb) and the features' own (a sine, B L (N + Mc) nb),
      the torques of the hinge-active pairs (16 L each, ``active_share`` of
      B S N P), and the fused pair's backward in float64 (:func:`k2.work`);
    - the update: ~12 operations a parameter (B (M L + L M² + 2 L)).
    """
    Mc = M + 2
    f = rff.work(B, S, L, N, nb, Mc)
    f32 = f["f32_flops"]
    f32 += B * S * N * (60 * L + 30 * P) + active_share * B * S * N * P * 16 * L
    f32 += 2 * B * S * L * (N + Mc) * nb + peaks.COS_FLOPS * B * L * (N + Mc) * nb
    f32 += 12 * B * (M * L + L * M * M + 2 * L)
    f64 = f["f64_flops"] + 20 * B * L * Mc * Mc + B * L * k2.work("bwd", Mc, S + N + 1)[1]
    return f32 / peaks.F32_FLOPS + f64 / peaks.F64_TC_FLOPS
