"""K2's block design (``vgpmp_torch/csrc/k2_linalg.cuh``, n > 32) on the CPU:
the kernel's own source, and its blocked order against JAX.

The kernel's source is compiled here by g++ against ``tests/k2_cpu/``, a
stub of what it takes from CUDA (a block as 256 threads; the inline PTX
rewritten into the stub's copy and float64 product), and held to the port's
plain versions in both dtypes, and on the real Grams, as the card tests hold
the card's build.

A numpy emulation of the kernel's blocked order is held to JAX's unrolled
functions: panels of 32 rows, the last one padded with the identity; a
diagonal tile factored by the warp design's column steps (the reciprocal
square root of each pivot kept); the tiles below it, and every diagonal tile
of a solve, by substitution multiplying by the reciprocals of the diagonal
(a solve's diagonal tile in sub-blocks of 8 rows); everything else a product
(the matrix unit's work). The backward follows the kernel's phases: G summed
over column tiles of the kernel's width, Phi by block rows, Y = L^-T Phi by
block columns, and the lower triangle of Z = L^-T Y^T, each block column from
its own block row down; dK = 2 Z below the diagonal. The panel, the
sub-block and the column tile are read from the kernel's source and build.
Random SPD matrices at n = 33, 40, 64, 100 and 128 (ragged and full last
panels), and the real conditioned Grams of a franka/industrial session at
Mc = 40 (condition ~8e9).
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import mc40_grams
from vgpmp_torch.ops import linalg as la
from vgpmp_tpu.ops import linalg as jla

CSRC = Path(__file__).resolve().parents[1] / "vgpmp_torch" / "csrc"
STUB = Path(__file__).resolve().parent / "k2_cpu"
HEADER = (CSRC / "k2_linalg.cuh").read_text()


def _header_int(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", HEADER).group(1))


PANEL = _header_int("PANEL")
SUB = _header_int("SUB")  # rows of a diagonal tile's sub-block in a solve
SIZES = [33, 40, 64, 100, 128]


def _cpu_source(text):
    """``k2_linalg.cuh`` for the stub: its PTX as the stub's calls (the copy
    to shared memory a plain copy, its waits nothing, the product
    ``k2_cpu_mma``), a function's ``__shared__`` array a static one, and the
    warp design's ``<<<>>>`` dropped (compiled, never run here)."""
    seen = []

    def asm(m):
        body = m.group(0)
        seen.append("copy" if "cp.async.ca" in body else "mma" if "mma.sync" in body else "other")
        return {"copy": "*dst = *src;", "mma": "k2_cpu_mma(c, a, b);"}.get(seen[-1], ";")

    text = re.sub(r"asm(\s+volatile)?\s*\(.*?\);", asm, text, flags=re.S)
    assert seen.count("copy") == 2 and seen.count("mma") == 1, f"the header's PTX changed: {seen}"
    text = re.sub(r"<<<[^>]*>>>", "", text)
    return re.sub(r"(?<!extern )__shared__", "static", text)


class K2Cpu:
    """The kernel's four entries on contiguous CPU tensors, and its choices."""

    def __init__(self, lib):
        self.lib = lib
        P, I64, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for tag in ("f64", "f32"):
            for name, args in (("chol", [P, P, I64, I]), ("trsm", [P, P, P, I64, I, I, I]),
                               ("pair", [P, P, P, P, I64, I, I]), ("bwd", [P, P, P, P, P, P, I64, I, I])):
                getattr(lib, f"{name}_{tag}").argtypes = args

    def _call(self, name, ins, outs, *dims):
        tag = "f64" if ins[0].dtype == torch.float64 else "f32"
        ins = [x.contiguous() for x in ins]
        rc = getattr(self.lib, f"{name}_{tag}")(*(x.data_ptr() for x in ins + outs), *dims)
        assert rc == 0, f"{name}: cudaError {rc}"
        return outs

    def chol(self, K):
        return self._call("chol", [K], [torch.empty_like(K)], K.shape[0], K.shape[-1])[0]

    def trsm(self, L, B, upper_t):
        return self._call("trsm", [L, B], [torch.empty_like(B)], L.shape[0], L.shape[-1], B.shape[-1],
                          int(upper_t))[0]

    def pair(self, K, B):
        return self._call("pair", [K, B], [torch.empty_like(K), torch.empty_like(B)], K.shape[0],
                          K.shape[-1], B.shape[-1])

    def bwd(self, L, X, gL, gX):
        return self._call("bwd", [L, X, gL, gX], [torch.empty_like(L), torch.empty_like(X)], L.shape[0],
                          L.shape[-1], X.shape[-1])

    def bwd_tile(self, nb, k):
        """The backward's column tile in float64 (``blk_bwd_ct``)."""
        return self.lib.bwd_tile_f64(nb, k)


@pytest.fixture(scope="module")
def k2cpu(tmp_path_factory):
    """The kernel's source built for the CPU (g++, C++20, threads)."""
    d = tmp_path_factory.mktemp("k2_cpu")
    (d / "k2_linalg.cuh").write_text(_cpu_source(HEADER))
    launch = (CSRC / "launch.cuh").read_text()
    call = "kernel<<<grid, block, smem, st>>>(args...);"
    assert call in launch
    (d / "launch.cuh").write_text(launch.replace(call, "k2_cpu_launch(kernel, grid, block, smem, args...);"))
    shutil.copy(CSRC / "kernels.h", d)
    so = d / "k2_cpu.so"
    cmd = ["g++", "-std=c++20", "-O2", "-pthread", "-shared", "-fPIC", "-w", f"-I{d}", f"-I{STUB}",
           str(STUB / "k2_cpu.cpp"), "-o", str(so)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-4000:]
    lib = K2Cpu(ctypes.CDLL(str(so)))
    assert (lib.lib.panel_rows(), lib.lib.sub_rows()) == (PANEL, SUB)
    return lib


def _pad(A, np_, eye):
    """``A [T, r, c]`` in the top left of ``[T, np_, np_ or c]``, the rest the
    identity's (eye) or zero."""
    T, r, c = A.shape
    out = np.zeros((T, np_, np_ if eye else c))
    if eye:
        out[:] = np.eye(np_)
    out[:, :r, :c] = A
    return out


def blocked_chol(K):
    """The factor and the reciprocals of its diagonal, in the kernel's order."""
    T, n, _ = K.shape
    nb = -(-n // PANEL)
    A = _pad(K, nb * PANEL, True)
    L = np.zeros_like(A)
    r = np.zeros((T, nb * PANEL))
    for p in range(nb):
        s = slice(p * PANEL, (p + 1) * PANEL)
        D = A[:, s, s].copy()  # lane l holds row l
        for j in range(PANEL):
            rj = 1.0 / np.sqrt(D[:, j, j])
            col = D[:, :, j] * rj[:, None]  # on lane j: d * r
            col[:, :j] = 0.0
            D[:, :, j] = col
            D[:, :, j + 1:] -= col[:, :, None] * col[:, None, j + 1:]
            r[:, p * PANEL + j] = rj
        L[:, s, s] = D
        below = slice((p + 1) * PANEL, nb * PANEL)
        X = A[:, below, s].copy()  # a thread a row: x D^T = a
        for c in range(PANEL):
            xc = X[:, :, c] * r[:, p * PANEL + c, None]
            X[:, :, c] = xc
            X[:, :, c + 1:] -= xc[:, :, None] * D[:, None, c + 1:, c]
        L[:, below, s] = X
        A[:, below, below] -= X @ np.swapaxes(X, 1, 2)
    return L[:, :n, :n], r


def _tile_solve(D, ri, XI, upper_t):
    """A diagonal tile's solve in place: sub-blocks of SUB rows, each by
    substitution with the reciprocals, then a product for the tile's
    sub-blocks still to solve."""
    ns = PANEL // SUB
    sub = lambda b: slice(b * SUB, (b + 1) * SUB)
    for s in range(ns):
        b = ns - 1 - s if upper_t else s
        Db, Xb, rb = D[:, sub(b), sub(b)], XI[:, sub(b)], ri[:, sub(b)]
        for i in (range(SUB - 1, -1, -1) if upper_t else range(SUB)):
            xi = Xb[:, i] * rb[:, i, None]
            Xb[:, i] = xi
            if upper_t:
                Xb[:, :i] -= Db[:, i, :i, None] * xi[:, None]
            else:
                Xb[:, i + 1:] -= Db[:, i + 1:, i, None] * xi[:, None]
        for b1 in (range(b) if upper_t else range(b + 1, ns)):
            A = np.swapaxes(D[:, sub(b), sub(b1)], 1, 2) if upper_t else D[:, sub(b1), sub(b)]
            XI[:, sub(b1)] -= A @ Xb


def _solve_padded(Lp, r, X, upper_t, j0=0):
    """The kernel's block-row solve in place on the padded ``X [T, np, k]``,
    block rows ``j0 ..``: a diagonal tile by :func:`_tile_solve`, then a
    product for the block rows still to solve."""
    nb = Lp.shape[-1] // PANEL
    blk = lambda i: slice(i * PANEL, (i + 1) * PANEL)
    for s in range(j0, nb):
        I = nb - 1 - (s - j0) if upper_t else s
        XI = X[:, blk(I)]
        _tile_solve(Lp[:, blk(I), blk(I)], r[:, blk(I)], XI, upper_t)
        for J in (range(j0, I) if upper_t else range(I + 1, nb)):
            A = np.swapaxes(Lp[:, blk(I), blk(J)], 1, 2) if upper_t else Lp[:, blk(J), blk(I)]
            X[:, blk(J)] -= A @ XI
    return X


def _padded_factor(L):
    """The padded factor and the reciprocals a lone solve computes."""
    nb = -(-L.shape[-1] // PANEL)
    Lp = _pad(L, nb * PANEL, True)
    return Lp, 1.0 / np.diagonal(Lp, axis1=1, axis2=2)


def blocked_solve(L, B, upper_t):
    """``L^-1 B`` or ``L^-T B`` as the lone solve computes it."""
    Lp, r = _padded_factor(L)
    n = L.shape[-1]
    return _solve_padded(Lp, r, _pad(B, Lp.shape[-1], False), upper_t)[:, :n]


def blocked_pair(K, B):
    """The fused pair: the factor, then the forward substitution with its
    reciprocals."""
    L, r = blocked_chol(K)
    n = K.shape[-1]
    Lp = _pad(L, r.shape[-1], True)
    return L, _solve_padded(Lp, r, _pad(B, Lp.shape[-1], False), False)[:, :n]


def blocked_pair_bwd(L, X, gL, gX, tile):
    """The backward of the fused pair in the kernel's phases: ``(dK, dB)``;
    ``tile(nb, k)`` the kernel's column tile."""
    T, n, k = X.shape
    Lp, r = _padded_factor(L)
    np_ = Lp.shape[-1]
    nb = np_ // PANEL
    blk = lambda i: slice(i * PANEL, (i + 1) * PANEL)
    G = np.zeros((T, np_, np_))
    G[:, :n, :n] = np.tril(gL)
    dB = _solve_padded(Lp, r, _pad(gX, np_, False), True)
    Xp = _pad(X, np_, False)
    ct = tile(nb, k)
    for c0 in range(0, k, ct):
        G -= np.tril(dB[:, :, c0:c0 + ct] @ np.swapaxes(Xp[:, :, c0:c0 + ct], 1, 2))
    Phi = np.zeros_like(G)
    for I in range(nb):  # block rows in order: row I reads G's rows I ..
        for J in range(I + 1):
            acc = np.zeros((T, PANEL, PANEL))
            for Kb in range(I, nb):
                acc -= np.swapaxes(Lp[:, blk(Kb), blk(I)], 1, 2) @ G[:, blk(Kb), blk(J)]
            Phi[:, blk(I), blk(J)] = -0.5 * acc
    Phi = np.tril(Phi)
    Phi = Phi + np.swapaxes(np.tril(Phi, -1), 1, 2)
    Y = np.zeros_like(Phi)
    for C in range(nb):
        Y[:, :, blk(C)] = _solve_padded(Lp, r, Phi[:, :, blk(C)].copy(), True)
    Yt = np.swapaxes(Y, 1, 2)
    Z = np.zeros_like(Y)
    for J in range(nb):
        Z[:, J * PANEL:, blk(J)] = _solve_rows(Lp, r, Yt[:, :, blk(J)], J)
    dK = 2.0 * np.tril(Z, -1) + np.einsum("tii->ti", Z)[:, :, None] * np.eye(np_)
    return dK[:, :n, :n], dB[:, :n]


def _solve_rows(Lp, r, Ycol, J):
    """Block column J of Z below block row J: the transposed solve of Y^T's
    block column from block row J down (the rows above it are never read)."""
    X = np.zeros_like(Ycol)
    X[:, J * PANEL:] = Ycol[:, J * PANEL:]
    return _solve_padded(Lp, r, X, True, j0=J)[:, J * PANEL:]


def jax_pair_bwd(K, B, gL, gX):
    """JAX's gradient of the unrolled pair ``(chol(K), L^-1 B)``."""
    f = lambda K_, B_: (jla.cholesky_unrolled(K_), jla.solve_lower_unrolled(jla.cholesky_unrolled(K_), B_))
    _, vjp = jax.vjp(f, jnp.asarray(K), jnp.asarray(B))
    return tuple(np.asarray(g) for g in vjp((jnp.asarray(gL), jnp.asarray(gX))))


def jax_pair_bwd_closed(L, X, gL, gX):
    """The same gradient in closed form from JAX's unrolled solves, as the
    port's ``factor_solve_bwd_plain`` writes it (jax.vjp of the unrolled pair
    compiles each of its n steps' slices: 45 s at n = 128 on the CPU, where
    this takes 2 s; the two agree to 1e-15 there)."""
    L, X, gL, gX = map(jnp.asarray, (L, X, gL, gX))
    tr = lambda a: jnp.swapaxes(a, 1, 2)
    gB = jla.solve_upper_T_unrolled(L, gX)
    P = tr(L) @ (jnp.tril(gL) - jnp.tril(gB @ tr(X)))
    phi = 0.5 * (jnp.tril(P) + tr(jnp.tril(P, -1)))
    S = tr(jla.solve_upper_T_unrolled(L, tr(jla.solve_upper_T_unrolled(L, phi))))
    dK = jnp.tril(S + tr(S)) - jnp.einsum("tii->ti", S)[..., None] * jnp.eye(S.shape[-1])
    return np.asarray(dK), np.asarray(gB)


def _inputs(n, T=3, k=71):
    rng = np.random.default_rng(n)
    G = rng.normal(size=(T, n, n))
    K = G @ np.swapaxes(G, 1, 2) + n * np.eye(n)
    return K, rng.normal(size=(T, n, k)), rng.normal(size=(T, n, n))


def close(got, want, tol):
    """``got`` within ``tol`` of ``want``'s largest entry."""
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.fixture(scope="module")
def real_grams():
    """Twelve of the 252 real Mc = 40 Grams (they repeat across the rows at
    the tuned init) and right-hand sides of a training step's 71 columns."""
    K = mc40_grams()[:12].numpy()
    rng = np.random.default_rng(40)
    return K, rng.normal(size=(12, 40, 71)), rng.normal(size=(12, 40, 40))


@pytest.mark.parametrize("n", SIZES)
def test_blocked_factor_matches_jax(n):
    """The blocked factor, on well-conditioned SPD matrices, within 1e-12 of
    the largest entry of JAX's (float64 rounding in another order)."""
    K, _, _ = _inputs(n)
    L, r = blocked_chol(K)
    Lj = np.asarray(jla.cholesky_unrolled(jnp.asarray(K)))
    close(L, Lj, 1e-12)
    close(r[:, :n], 1.0 / np.diagonal(Lj, axis1=1, axis2=2), 1e-12)
    # the padding factors to the identity and never reaches the matrix
    assert np.array_equal(np.triu(L, 1), np.zeros_like(L))


@pytest.mark.parametrize("n", SIZES)
def test_blocked_solves_match_jax(n):
    """Both blocked solves, and the fused pair's, within 1e-12 of JAX's
    unrolled substitutions (the same factor; well-conditioned)."""
    K, B, _ = _inputs(n)
    Lj = np.asarray(jla.cholesky_unrolled(jnp.asarray(K)))
    close(blocked_solve(Lj, B, False), np.asarray(jla.solve_lower_unrolled(jnp.asarray(Lj), jnp.asarray(B))),
          1e-12)
    close(blocked_solve(Lj, B, True), np.asarray(jla.solve_upper_T_unrolled(jnp.asarray(Lj), jnp.asarray(B))),
          1e-12)
    L, X = blocked_pair(K, B)
    close(X, np.asarray(jla.solve_lower_unrolled(jnp.asarray(Lj), jnp.asarray(B))), 1e-12)


@pytest.mark.parametrize("n", SIZES)
def test_blocked_pair_backward_matches_jax(n, k2cpu):
    """The blocked backward of the fused pair (dK folded onto the lower
    triangle, dB) within 1e-11 of the largest entry of JAX's, in closed form
    from its unrolled solves (well-conditioned; float64 rounding in another
    order). At n = 40, the real-Gram test holds it to ``jax.vjp`` itself."""
    K, B, gL = _inputs(n)
    gX = np.random.default_rng(n + 1).normal(size=B.shape)
    Lj = np.asarray(jla.cholesky_unrolled(jnp.asarray(K)))
    Xj = np.asarray(jla.solve_lower_unrolled(jnp.asarray(Lj), jnp.asarray(B)))
    dK, dB = blocked_pair_bwd(Lj, Xj, gL, gX, k2cpu.bwd_tile)
    dKj, dBj = jax_pair_bwd_closed(Lj, Xj, gL, gX)
    close(dB, dBj, 1e-11)
    close(dK, dKj, 1e-11)


def test_blocked_order_on_real_grams_matches_jax(real_grams):
    """The real Mc = 40 Grams (condition ~8e9): the blocked factor within
    1e-9 of the largest entry of JAX's (rounding in another order, amplified
    by the square root of the condition); both solves with JAX's factor
    within 1e-9; the pair's X = L^-1 B with its own factor within 1e-6 (its
    factor's difference multiplied by the factor's condition, ~1e5)."""
    K, B, _ = real_grams
    Lj = np.asarray(jla.cholesky_unrolled(jnp.asarray(K)))
    L, _ = blocked_chol(K)
    close(L, Lj, 1e-9)
    jb = lambda fn, L_: np.asarray(fn(jnp.asarray(L_), jnp.asarray(B)))
    close(blocked_solve(Lj, B, False), jb(jla.solve_lower_unrolled, Lj), 1e-9)
    close(blocked_solve(Lj, B, True), jb(jla.solve_upper_T_unrolled, Lj), 1e-9)
    close(blocked_pair(K, B)[1], jb(jla.solve_lower_unrolled, Lj), 1e-6)


def test_blocked_backward_on_real_grams_matches_jax(real_grams, k2cpu):
    """The blocked backward on the real Mc = 40 Grams against ``jax.vjp``
    through JAX's unrolled pair, from JAX's own factor and solution: dB
    within 1e-9 of its largest entry; dK within 1e-6 (L^-T applied four
    times, the closed form against autodiff of the unrolled steps on a Gram
    of condition ~8e9)."""
    K, B, gL = real_grams
    gX = np.random.default_rng(41).normal(size=B.shape)
    Lj = np.asarray(jla.cholesky_unrolled(jnp.asarray(K)))
    Xj = np.asarray(jla.solve_lower_unrolled(jnp.asarray(Lj), jnp.asarray(B)))
    dK, dB = blocked_pair_bwd(Lj, Xj, gL, gX, k2cpu.bwd_tile)
    dKj, dBj = jax_pair_bwd(K, B, gL, gX)
    close(dB, dBj, 1e-9)
    close(dK, dKj, 1e-6)


def _random_case(n, dtype, T=3, k=71):
    """T random SPD matrices, the middle one made non-SPD (its last pivot
    negative), right-hand sides and cotangents, in ``dtype``."""
    K, B, gL = (torch.as_tensor(a, dtype=dtype) for a in _inputs(n, T, k))
    K[T // 2, -1, -1] = -1.0
    return K, B, gL


@pytest.mark.parametrize("n", SIZES)
def test_kernel_source_on_cpu_matches_plain(n, k2cpu):
    """The kernel's source, built for the CPU, against the port's plain
    versions at k = 71 (ragged against the 16-column units), in float64 to
    1e-12 of the largest entry (well-conditioned; rounding in another
    order) and in float32 to 1e-4, as the card tests hold the card's build.
    The non-SPD matrix is NaN in the factor and the pair, and no other."""
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        K, B, gL = _random_case(n, dtype)
        ok = torch.ones(K.shape[0], dtype=torch.bool)
        ok[K.shape[0] // 2] = False
        L = k2cpu.chol(K)
        L_p = la.cholesky_unrolled(K)
        assert torch.isnan(L[~ok]).any() and torch.isfinite(L[ok]).all()
        close(L[ok].numpy(), L_p[ok].numpy(), tol)
        Ls = L_p[ok].contiguous()
        for upper_t, plain in ((False, la.solve_lower_unrolled), (True, la.solve_upper_T_unrolled)):
            close(k2cpu.trsm(Ls, B[ok], upper_t).numpy(), plain(Ls, B[ok]).numpy(), tol)
        Lf, Xf = k2cpu.pair(K, B)
        Lq, Xq = la.factor_solve_plain(K, B)
        assert torch.isnan(Xf[~ok]).any() and torch.isfinite(Xf[ok]).all()
        close(Lf[ok].numpy(), Lq[ok].numpy(), tol)
        close(Xf[ok].numpy(), Xq[ok].numpy(), tol)
        args = [x[ok].contiguous() for x in (Lq, Xq, gL, B)]
        for got, want in zip(k2cpu.bwd(*args), la.factor_solve_bwd_plain(*args)):
            close(got.numpy(), want.numpy(), 10 * tol)


def test_kernel_source_on_cpu_on_real_grams(real_grams, k2cpu):
    """The kernel's source on the real Mc = 40 Grams against the plain
    versions, at the card test's tolerances and for its reasons
    (``test_k2_block_design_on_real_grams_on_card``): the factor, the solves
    and the backward to 1e-9 of the largest entry, the pair's X to 1e-6."""
    K, B, gL = (torch.as_tensor(a) for a in real_grams)
    L_p = la.cholesky_unrolled(K)
    L = k2cpu.chol(K)
    close(L.numpy(), L_p.numpy(), 1e-9)
    for upper_t, plain in ((False, la.solve_lower_unrolled), (True, la.solve_upper_T_unrolled)):
        close(k2cpu.trsm(L_p, B, upper_t).numpy(), plain(L_p, B).numpy(), 1e-9)
    Lf, Xf = k2cpu.pair(K, B)
    Lq, Xq = la.factor_solve_plain(K, B)
    close(Lf.numpy(), Lq.numpy(), 1e-9)
    close(Xf.numpy(), Xq.numpy(), 1e-6)
    gX = torch.as_tensor(np.random.default_rng(41).normal(size=B.shape))
    gK, gB = k2cpu.bwd(Lq, Xq, gL, gX)
    gK_p, gB_p = la.factor_solve_bwd_plain(Lq, Xq, gL, gX)
    close(gK.numpy(), gK_p.numpy(), 1e-9)
    close(gB.numpy(), gB_p.numpy(), 1e-9)
    assert torch.isfinite(gK).all() and torch.isfinite(Xf).all()
