"""K2's work on one matrix: what each entry must move and compute."""

from __future__ import annotations


def work(entry: str, n: int, k: int = 0):
    """``(values, operations)`` of one ``n x n`` matrix with ``k`` right-hand
    sides. ``entry``: ``chol``; ``trsm``; ``pair``, the factorisation and the
    solve fused; ``bwd``, the pair's backward. A triangular input is read as
    its lower triangle, a dense one once, every output written once.

    - chol: n³/3 operations; reads tri(n), writes n².
    - trsm: n² k; reads tri(n) and n k, writes n k.
    - pair: n³/3 + n² k; reads n², writes n² and n k (tri + n² + 2nk values).
    - bwd: one substitution of k columns, the lower half of dB Xᵀ, the lower
      half of Lᵀ G and the congruence L⁻ᵀ Φ L⁻¹: 2n²k + 4n³/3; reads L, dL
      (triangles), X and dX, writes dK and dB (2 tri + n² + 3nk values).
    """
    tri, sq, nk = n * (n + 1) // 2, n * n, n * k
    ops = {"chol": n ** 3 / 3, "trsm": n * n * k, "pair": n ** 3 / 3 + n * n * k,
           "bwd": 2 * n * n * k + 4 * n ** 3 / 3}[entry]
    values = {"chol": tri + sq, "trsm": tri + 2 * nk, "pair": tri + sq + 2 * nk,
              "bwd": 2 * tri + sq + 3 * nk}[entry]
    return values, ops
