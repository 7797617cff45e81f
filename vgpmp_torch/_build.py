"""Build the port's CUDA kernels and load them as one PyTorch extension.

``csrc/k1_collision.cu`` and ``csrc/k2_linalg.cu`` hold the kernels and their
launch functions with no PyTorch headers; ``csrc/bindings.cpp`` checks the
tensors and calls them. ``torch.utils.cpp_extension.load`` compiles all three
for ``sm_90a`` with ninja (one compiler process per source, in parallel) into
``build/kernels/`` at the root of the checkout, and reuses what is there when
no source changed. The first call to :func:`load` builds; a process that
never touches a CUDA tensor never builds.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "load", "build"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "kernels"
SOURCES = ("bindings.cpp", "k1_collision.cu", "k2_linalg.cu")
# naming an arch here stops cpp_extension from adding its own
CUDA_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3")

_lock = threading.Lock()
_ext = None


def load():
    """The compiled extension module, built on first use."""
    global _ext
    with _lock:
        if _ext is None:
            from torch.utils import cpp_extension

            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _ext = cpp_extension.load(
                name="vgpmp_torch_kernels", sources=[str(CSRC / s) for s in SOURCES],
                extra_cflags=["-O3"], extra_cuda_cflags=list(CUDA_FLAGS),
                extra_include_paths=[str(CSRC)], build_directory=str(BUILD_DIR), verbose=False)
        return _ext


def build() -> float:
    """Load the extension, building what is missing; returns the wall seconds."""
    t0 = time.perf_counter()
    load()
    return time.perf_counter() - t0
