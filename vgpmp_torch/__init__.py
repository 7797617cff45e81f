"""vgpmp_torch: the PyTorch/CUDA port of the vGPMP planner.

Mirrors ``vgpmp_tpu``'s module layout. Entry points run on the CUDA device
unless the caller passes ``device="cpu"``; there the kernels' plain PyTorch
versions run instead, which is what the CPU tests hold against the JAX
package.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA device, raising when there is none (never a
    silent fall back to the CPU); anything else -> ``torch.device(device)``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "vgpmp_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' for the plain PyTorch path"
            )
        return torch.device("cuda")
    return torch.device(device)
