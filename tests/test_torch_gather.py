"""The table gather's plain version (``vgpmp_torch/ops/gather.py``) against
``np.take``: exact, for 4-byte entries (what the Pallas kernel of
``tools/gather_bench.py`` gathers) and 8-byte rows (a packed SDF row). Kernel
K4 itself is held against this plain version on the card
(``tests/test_torch_kernels.py``)."""

import numpy as np
import pytest
import torch

from vgpmp_torch.ops import gather as tg


def _table(ncells, words):
    t = np.arange(ncells * words, dtype=np.int64).astype(np.uint32)
    t = (t * np.uint32(2654435761)).view(np.int32)  # all 32 bits in use, sign bit too
    return t.reshape(ncells, 2) if words == 2 else t


@pytest.mark.parametrize("words", [1, 2])
@pytest.mark.parametrize("idx_shape", [(1000,), (8, 128)])
def test_gather_plain_matches_numpy_take(words, idx_shape):
    ncells = 4099
    table = _table(ncells, words)
    idx = np.random.default_rng(words).integers(0, ncells, size=idx_shape, dtype=np.int32)
    idx.reshape(-1)[:4] = [0, ncells - 1, -7, ncells + 12]  # the ends, and two clamped
    want = np.take(table, idx, axis=0, mode="clip")
    got = tg.gather_plain(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.int32 and tuple(got.shape) == idx_shape + ((2,) if words == 2 else ())
    np.testing.assert_array_equal(got.numpy(), want)
    # on a CPU tensor the entry point takes the plain version
    np.testing.assert_array_equal(tg.gather(torch.from_numpy(table), torch.from_numpy(idx)).numpy(), want)


def test_gather_matches_the_jax_reference_function():
    """The function the Pallas kernel computes, ``jnp.take(table, idx, axis=0)``
    on in-range indices (the kernel body of ``bench_pallas``), run as plain JAX
    on the CPU."""
    import jax.numpy as jnp

    table = _table(2048, 1)
    idx = np.random.default_rng(3).integers(0, 2048, size=(16, 128), dtype=np.int32)
    want = np.asarray(jnp.take(jnp.asarray(table.view(np.uint32)), jnp.asarray(idx), axis=0))
    got = tg.gather(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want)


def test_k4_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tg.k4_gather(torch.zeros(8, dtype=torch.int32), torch.zeros(4, dtype=torch.int32))
