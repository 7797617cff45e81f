"""K2's streamed design (``vgpmp_torch/csrc/k2_linalg.cuh``, n > 128) on the
CPU: the kernel's own source, built by g++ against the threaded CUDA stub in
``tests/k2_cpu/`` as ``test_torch_k2_blocked.py`` builds it (the header's PTX
rewritten into the stub's copy and float64 product), and held to the port's
plain versions, as the card tests hold the card's build.

Above n = 128 a matrix's lower tiles live in device memory (scratch the
caller allocates, ``k2_scratch_values`` a matrix), and each operand tile is
copied into shared memory as a step needs it. All four entries, both dtypes:
n = 129 (one row in the last panel), 160 (a whole last panel) and 200 (a
ragged one), a non-SPD matrix whose NaN must stay in its own matrix, the
lone solve's and the pair's 128-column tiles (k = 251), and the real
conditioned Grams of a franka/industrial session at Mc = 160 (condition
~3e10). The stub runs every float64 product as a warp exchange, so the
float64 cases keep T = 2 (one SPD matrix and the non-SPD one).
"""

import ctypes

import numpy as np
import pytest
import torch

from _torch_support import real_grams
from test_torch_k2_blocked import close, k2cpu  # noqa: F401  (k2cpu: the stub's build, a fixture)
from vgpmp_torch.ops import linalg as la

ENTRIES = {"chol": 0, "trsm": 1, "pair": 2, "bwd": 3}  # csrc/kernels.h:K2Entry


class Streamed:
    """The stub build's entries with the scratch the streamed design takes
    (the lone solve takes none)."""

    def __init__(self, lib):
        self.lib = lib
        P, I64, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for tag in ("f64", "f32"):
            for name, args in (("schol", [P, P, I64, I, P]), ("trsm", [P, P, P, I64, I, I, I]),
                               ("spair", [P, P, P, P, I64, I, I, P]),
                               ("sbwd", [P, P, P, P, P, P, I64, I, I, P])):
                getattr(lib, f"{name}_{tag}").argtypes = args
            getattr(lib, f"scratch_{tag}").argtypes = [I, I]
            getattr(lib, f"scratch_{tag}").restype = I64

    def _call(self, name, ins, outs, *dims, scratch=True):
        tag = "f64" if ins[0].dtype == torch.float64 else "f32"
        ins = [x.contiguous() for x in ins]
        if name == "trsm":
            return getattr(self.lib, f"trsm_{tag}")(*(x.data_ptr() for x in ins + outs), *dims), outs
        T, n = ins[0].shape[0], ins[0].shape[-1]
        per = getattr(self.lib, f"scratch_{tag}")(ENTRIES[name], n)
        # NaN-filled, so that a tile read before it is written shows
        w = torch.full((T * per,), float("nan"), dtype=ins[0].dtype) if scratch and per else None
        rc = getattr(self.lib, f"s{name}_{tag}")(*(x.data_ptr() for x in ins + outs), *dims,
                                                 None if w is None else w.data_ptr())
        return rc, outs

    def run(self, name, ins, outs, *dims):
        rc, outs = self._call(name, ins, outs, *dims)
        assert rc == 0, f"{name}: cudaError {rc}"
        return outs

    def chol(self, K):
        return self.run("chol", [K], [torch.empty_like(K)], K.shape[0], K.shape[-1])[0]

    def trsm(self, L, B, upper_t):
        return self.run("trsm", [L, B], [torch.empty_like(B)], L.shape[0], L.shape[-1], B.shape[-1],
                        int(upper_t))[0]

    def pair(self, K, B):
        return self.run("pair", [K, B], [torch.empty_like(K), torch.empty_like(B)], K.shape[0],
                        K.shape[-1], B.shape[-1])

    def bwd(self, L, X, gL, gX):
        return self.run("bwd", [L, X, gL, gX], [torch.empty_like(L), torch.empty_like(X)], L.shape[0],
                        L.shape[-1], X.shape[-1])


@pytest.fixture(scope="module")
def k2s(k2cpu):  # noqa: F811
    return Streamed(k2cpu.lib)


def _case(n, T, k, dtype, seed):
    """T random SPD matrices (the one at T // 2 made non-SPD: its last pivot
    negative), right-hand sides and two cotangents, in ``dtype``."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(T, n, n))
    K = torch.as_tensor(G @ np.swapaxes(G, 1, 2) + n * np.eye(n), dtype=dtype)
    K[T // 2, -1, -1] = -1.0
    B, gL, gX = (torch.as_tensor(rng.normal(size=s), dtype=dtype) for s in ((T, n, k), (T, n, n), (T, n, k)))
    return K, B, gL, gX


def _check_all(k2s, K, B, gL, gX, tol, bad):
    """Every entry against the plain versions (relative to the largest
    reference entry; the backward at 10 tol); the matrix ``bad`` NaN in the
    factor and the pair, and no other."""
    ok = torch.ones(K.shape[0], dtype=torch.bool)
    ok[bad] = False
    L = k2s.chol(K)
    L_p = la.cholesky_unrolled(K)
    assert torch.isnan(L[bad]).any() and torch.isfinite(L[ok]).all()
    close(L[ok].numpy(), L_p[ok].numpy(), tol)
    Ls, Bs = L_p[ok].contiguous(), B[ok].contiguous()
    for upper_t, plain in ((False, la.solve_lower_unrolled), (True, la.solve_upper_T_unrolled)):
        close(k2s.trsm(Ls, Bs, upper_t).numpy(), plain(Ls, Bs).numpy(), tol)
    Lf, Xf = k2s.pair(K, B)
    Lq, Xq = la.factor_solve_plain(K, B)
    assert torch.isnan(Lf[bad]).any() and torch.isnan(Xf[bad]).any()
    assert torch.isfinite(Lf[ok]).all() and torch.isfinite(Xf[ok]).all()
    close(Lf[ok].numpy(), Lq[ok].numpy(), tol)
    close(Xf[ok].numpy(), Xq[ok].numpy(), tol)
    args = [x[ok].contiguous() for x in (Lq, Xq, gL, gX)]
    for got, want in zip(k2s.bwd(*args), la.factor_solve_bwd_plain(*args)):
        close(got.numpy(), want.numpy(), 10 * tol)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n,k", [(129, 71), (160, 71), (200, 33)])
def test_streamed_entries_match_plain(k2s, n, k, dtype):
    """The four entries at n = 129, 160 and 200 against the plain versions,
    float64 to 1e-12 of the largest entry (well-conditioned; rounding in
    another order) and float32 to 1e-4, as the block design's CPU test holds
    its own; k = 71 (a training step's columns) and 33 (ragged against the
    backward's 32-column chunks). A non-positive pivot gives NaN in its own
    matrix only."""
    T, tol = (2, 1e-12) if dtype == torch.float64 else (3, 1e-4)
    _check_all(k2s, *_case(n, T, k, dtype, seed=n + k), tol, bad=T // 2)


@pytest.mark.parametrize("k", [1, 251])
def test_streamed_column_tiles_match_plain(k2s, k):
    """One column, and 251 (the extraction's): the lone solve's grid of two
    128-column tiles, and the pair's and the backward's two passes, in
    float32 at n = 160 to 1e-4."""
    _check_all(k2s, *_case(160, 3, k, torch.float32, seed=k), 1e-4, bad=1)


def test_streamed_on_real_grams(k2s):
    """Two real Mc = 160 Grams (condition ~3e10) against the plain
    versions in float64, relative to the largest reference entry: the factor
    to 1e-9 (rounding in another order, amplified by the square root of the
    condition), the solves and the backward, given the same factor, to 1e-9,
    the pair's X, whose own factor differs by that much, to 1e-6 (the solve
    multiplies it by the factor's condition), as the block design's tests
    hold the Mc = 40 Grams."""
    K = real_grams(158)[[0, 126]].contiguous()  # two queries (a query's 7 joints share one)
    rng = np.random.default_rng(160)
    B, gL, gX = (torch.as_tensor(rng.normal(size=s)) for s in ((2, 160, 71), (2, 160, 160), (2, 160, 71)))
    L_p = la.cholesky_unrolled(K)
    close(k2s.chol(K).numpy(), L_p.numpy(), 1e-9)
    for upper_t, plain in ((False, la.solve_lower_unrolled), (True, la.solve_upper_T_unrolled)):
        close(k2s.trsm(L_p, B, upper_t).numpy(), plain(L_p, B).numpy(), 1e-9)
    Lf, Xf = k2s.pair(K, B)
    Lq, Xq = la.factor_solve_plain(K, B)
    close(Lf.numpy(), Lq.numpy(), 1e-9)
    close(Xf.numpy(), Xq.numpy(), 1e-6)
    gK, gB = k2s.bwd(Lq, Xq, gL, gX)
    gK_p, gB_p = la.factor_solve_bwd_plain(Lq, Xq, gL, gX)
    close(gK.numpy(), gK_p.numpy(), 1e-9)
    close(gB.numpy(), gB_p.numpy(), 1e-9)


def test_streamed_refuses_without_scratch(k2s):
    """Above n = 128 the factorisation, the pair and the backward refuse to
    launch without their scratch (cudaErrorInvalidValue); the lone solve
    takes none at any n; at n = 128 the block design takes none."""
    for n, want in ((129, 1), (128, 0)):
        K, B, gL, gX = _case(n, 1, 3, torch.float32, seed=0)
        outs = lambda *xs: [torch.empty_like(x) for x in xs]
        assert k2s._call("chol", [K], outs(K), 1, n, scratch=False)[0] == want
        assert k2s._call("pair", [K, B], outs(K, B), 1, n, 3, scratch=False)[0] == want
        assert k2s._call("bwd", [K, B, gL, gX], outs(K, B), 1, n, 3, scratch=False)[0] == want
        assert k2s._call("trsm", [K, B], outs(B), 1, n, 3, 0, scratch=False)[0] == 0
    assert k2s.lib.scratch_f64(ENTRIES["trsm"], 512) == 0 and k2s.lib.scratch_f64(ENTRIES["bwd"], 128) == 0
    nb, tile = 5, 32 * 36  # n = 160: five panels, tiles of 32 rows at a stride of 36
    assert k2s.lib.scratch_f64(ENTRIES["chol"], 160) == nb * (nb + 1) // 2 * tile
    assert k2s.lib.scratch_f32(ENTRIES["bwd"], 160) == (nb * (nb + 1) + nb) * tile
