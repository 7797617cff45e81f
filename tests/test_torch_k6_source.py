"""K6's source (``vgpmp_torch/csrc/k6_rff.cuh``) on the CPU, forward and
backward, held to the port's plain chain with autograd
(``vgpmp_torch.ops.rff.prior_paths_plain``) and to the JAX package's
(``vgpmp_tpu.gp.pathwise._rff_features``, the scale and the ``einsum``) with
``jax.grad``.

The header is compiled here by g++ against ``tests/k2_cpu/`` (a stub of what
the kernels take from CUDA: a block as its threads, ``__syncthreads`` a
barrier, a warp's shuffle through an exchange buffer, the special-function
unit's sine and cosine as ``std::sin``/``std::cos``) and called through
``ctypes`` (``k2_cpu/k6_cpu.cpp``) as ``vgpmp_torch.ops.rff.prior_paths``
calls it on the card: the inducing inputs ``[ny; Z]`` (with ``ny`` twice in
front where derivative rows are on, ``gp/velocity.py``), which take a
gradient, and the time grid appended, which takes none. The draws are the
JAX package's own (``_torch_support.jax_path_noise``: Student-t(5)
frequencies over lengthscales down to 0.04, so that |ω| passes 50 in every
case); the cases cover float32 and float64, S = 7, 20 and 150 (one, three
and nineteen sample chunks), grids of 50, 70 and 150 points and Mc = 12, 26
and 40 (tail tiles of the forward's 32-point lanes and of the backward's
staged points), derivative rows on and off, and 1 000 to 1 100 bases (tail
tiles of the forward's 128-basis tiles; more bases than a backward block
takes at once).

Tolerances, as a share of the reference's largest magnitude, for the
forward and each gradient: float32 1e-5 against the float64 chain (the
argument ωx + φ carries a float32 rounding of |ωx| up to ~200, about 1e-5 of
a feature, which the plain float32 chain carries too, and sums of 1 000
terms run in another order; the readings were 0.5-3e-6); float64 1e-12
(readings 1-4e-15). Both references are computed in float64 (JAX with x64
on), and the plain chain also in float32, whose own error the kernel's may
exceed by at most a factor of four plus 2e-6.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_support import jax_path_noise
from vgpmp_tpu.gp import pathwise as jp
from vgpmp_torch.ops import rff

CSRC = Path(__file__).resolve().parents[1] / "vgpmp_torch" / "csrc"
STUB = Path(__file__).resolve().parent / "k2_cpu"
C = 2  # the query rows ny
# (name, dtype, S, N, Mc, derivative rows, bases)
CASES = [
    ("wam_f32", np.float32, 7, 70, 26, False, 1024),
    ("franka_f32", np.float32, 20, 50, 12, False, 1000),
    ("velocity_f32", np.float32, 20, 50, 12, True, 1024),
    ("extraction_f32", np.float32, 150, 150, 26, False, 1024),
    ("velocity_mc40_f32", np.float32, 7, 150, 40, True, 1100),
    ("wam_f64", np.float64, 7, 70, 26, False, 1024),
    ("velocity_f64", np.float64, 20, 70, 40, True, 1024),
    ("extraction_f64", np.float64, 150, 50, 12, False, 1000),
]
TOL = {np.float32: 1e-5, np.float64: 1e-12}


@pytest.fixture(scope="module")
def k6cpu(tmp_path_factory):
    """The kernel's source built for the CPU (g++, C++20, threads)."""
    d = tmp_path_factory.mktemp("k6_cpu")
    launch = (CSRC / "launch.cuh").read_text()
    call = "kernel<<<grid, block, smem, st>>>(args...);"
    assert call in launch
    (d / "launch.cuh").write_text(launch.replace(call, "k2_cpu_launch(kernel, grid, block, smem, args...);"))
    for f in ("k6_rff.cuh", "kernels.h"):
        shutil.copy(CSRC / f, d)
    so = d / "k6_cpu.so"
    cmd = ["g++", "-std=c++20", "-O2", "-pthread", "-shared", "-fPIC", "-w", f"-I{d}", f"-I{STUB}",
           str(STUB / "k6_cpu.cpp"), "-o", str(so)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    P = ctypes.c_void_p
    for tag in ("f32", "f64"):
        getattr(lib, f"k6_{tag}").argtypes = [P] * 8
        getattr(lib, f"k6_bwd_{tag}").argtypes = [P] * 11 + [ctypes.c_int]
    return lib


def k6_run(lib, xg, xn, omega, phase, scale, w, flags, g):
    """The CPU build of K6 as ``ops.rff.prior_paths`` launches it: ``xg [P,
    Mc]`` (the gradient's points) and ``xn [P, N]``, ``omega``/``phase [P,
    nb]``, ``scale [P]``, ``w [R, S, L, nb]``, ``flags [Mc + N]`` uint8 or None,
    ``g [R, S, L, Mc + N]`` -> ``(out, d omega, d scale, d x [P, Mc])``."""
    tag = "f32" if xg.dtype == torch.float32 else "f64"
    x = torch.cat([xg, xn], dim=-1).contiguous()
    (R, S, L, nb), A = w.shape, x.shape[-1]
    dims = torch.tensor([R, L, A, nb, S], dtype=torch.int64)
    fl = flags.data_ptr() if flags is not None else None
    args = [t.data_ptr() for t in (x, omega, phase, scale, w)] + [fl, dims.data_ptr()]
    out = torch.full((R, S, L, A), float("nan"), dtype=x.dtype)
    assert getattr(lib, f"k6_{tag}")(*args, out.data_ptr()) == 0
    n_dx = xg.shape[-1]
    d_omega, d_scale = torch.full_like(omega, float("nan")), torch.full_like(scale, float("nan"))
    d_x = torch.full((R * L, n_dx), float("nan"), dtype=x.dtype)
    assert getattr(lib, f"k6_bwd_{tag}")(*args, g.contiguous().data_ptr(), d_omega.data_ptr(),
                                         d_scale.data_ptr(), d_x.data_ptr(), n_dx) == 0
    return out, d_omega, d_scale, d_x


def inputs(dtype, S, N, Mc, deriv, nb, R=2, L=3, seed=0):
    """The points, the JAX package's draws for R rows, lengthscales down to
    0.04 and variances in [0.5, 2], and an upstream gradient, as numpy float64
    (rounded to ``dtype`` first)."""
    rng = np.random.default_rng(seed)
    keys = jax.random.split(jax.random.PRNGKey(seed), R)
    noise = jax_path_noise(keys, L, Mc, S, nb, dtype=np.float64)
    ny = np.array([0.0, 1.0])
    M = Mc - (2 * C if deriv else C)
    Z = np.sort(rng.uniform(0.05, 0.95, (R, L, M)), axis=-1)
    zy = np.concatenate([np.broadcast_to(ny, (R, L, C))] * (2 if deriv else 1) + [Z], axis=-1)
    X = np.broadcast_to(np.linspace(0.0, 1.0, N), (R, L, N))
    ls = rng.uniform(0.04, 0.3, (R, L))
    var = rng.uniform(0.5, 2.0, (R, L))
    cast = lambda a: np.asarray(a, dtype=dtype).astype(np.float64)  # noqa: E731
    d = {"xg": cast(zy), "xn": cast(X), "omega": cast(noise.t.numpy() / ls[..., None]),
         "phase": cast(noise.phase.numpy()), "scale": cast(np.sqrt(2.0 * var / nb)),
         "w": cast(noise.w.numpy()), "g": cast(rng.normal(size=(R, S, L, Mc + N)))}
    d["mask"] = np.arange(Mc + N) < (C if deriv else 0)
    return d


def plain_ref(d, dtype):
    """The port's plain chain with autograd, in ``dtype``: (out, d omega,
    d scale, d x of the inducing inputs)."""
    t = {k: torch.as_tensor(v, dtype=dtype) for k, v in d.items() if k != "mask"}
    xg, om, sc = (t[k].clone().requires_grad_(True) for k in ("xg", "omega", "scale"))
    mask = torch.as_tensor(d["mask"]) if d["mask"].any() else None
    out = rff.prior_paths_plain(torch.cat([xg, t["xn"]], dim=-1), om, t["phase"], sc[..., None], t["w"], mask)
    (out * t["g"]).sum().backward()
    return [v.detach().double().numpy() for v in (out, om.grad, sc.grad, xg.grad)]


def jax_ref(d):
    """The JAX package's chain and ``jax.grad``, float64, one row at a time."""
    mask = jnp.asarray(d["mask"]) if d["mask"].any() else None

    def f(xg, om, sc, xn, ph, w):
        x = jnp.concatenate([xg, xn], axis=-1)
        phi = jp._rff_features(x, om, ph, mask) * sc[:, None, None]
        return jnp.einsum("lab,slb->sla", phi, w)

    def loss(xg, om, sc, xn, ph, w, g):
        return jnp.sum(f(xg, om, sc, xn, ph, w) * g)

    args = [jnp.asarray(d[k]) for k in ("xg", "omega", "scale", "xn", "phase", "w")]
    out = jax.vmap(f)(*args)
    grads = jax.vmap(jax.grad(loss, argnums=(0, 1, 2)))(*args, jnp.asarray(d["g"]))
    return [np.asarray(out), np.asarray(grads[1]), np.asarray(grads[2]), np.asarray(grads[0])]


def _err(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("name,dtype,S,N,Mc,deriv,nb", CASES, ids=[c[0] for c in CASES])
def test_k6_source_matches_plain_and_jax(k6cpu, name, dtype, S, N, Mc, deriv, nb):
    d = inputs(dtype, S, N, Mc, deriv, nb)
    assert np.abs(d["omega"]).max() > 50, "the case has no frequency above 50"
    tt = torch.float32 if dtype == np.float32 else torch.float64
    R, _, L, _ = d["w"].shape
    P = R * L
    t = {k: torch.as_tensor(v, dtype=tt) for k, v in d.items() if k != "mask"}
    flags = torch.as_tensor(d["mask"], dtype=torch.uint8) if deriv else None
    got = k6_run(k6cpu, t["xg"].reshape(P, -1), t["xn"].reshape(P, -1), t["omega"].reshape(P, nb),
                 t["phase"].reshape(P, nb), t["scale"].reshape(P), t["w"], flags, t["g"])
    got = [v.double().numpy().reshape(shape) for v, shape in
           zip(got, (d["w"].shape[:3] + (Mc + N,), d["omega"].shape, d["scale"].shape, d["xg"].shape))]
    names = ("out", "d_omega", "d_scale", "d_x")
    for g in got:
        assert np.isfinite(g).all()
    truth = plain_ref(d, torch.float64)
    for ref in (truth, jax_ref(d)):
        for n, g, want in zip(names, got, ref):
            assert _err(g, want) <= TOL[dtype], (name, n, _err(g, want))
    if dtype == np.float32:  # no worse than the plain float32 chain's own rounding, four times over
        for n, g, p, want in zip(names, got, plain_ref(d, torch.float32), truth):
            assert _err(g, want) <= 4 * _err(p, want) + 2e-6, (name, n, _err(g, want), _err(p, want))


def test_k6_source_is_deterministic(k6cpu):
    """The same inputs give the same bits (no atomics; sums in a fixed order)."""
    d = inputs(np.float32, 20, 50, 12, True, 1100, seed=3)
    t = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in d.items() if k != "mask"}
    P = 6
    args = (t["xg"].reshape(P, -1), t["xn"].reshape(P, -1), t["omega"].reshape(P, -1), t["phase"].reshape(P, -1),
            t["scale"].reshape(P), t["w"], torch.as_tensor(d["mask"], dtype=torch.uint8), t["g"])
    for a, b in zip(k6_run(k6cpu, *args), k6_run(k6cpu, *args)):
        assert torch.equal(a, b)
