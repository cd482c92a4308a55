"""Build of the port's CUDA sources.

Each ``.cu`` file is compiled on first use for ``sm_90a`` by PyTorch's
extension loader (``torch.utils.cpp_extension.load``, which needs ``ninja``)
into a shared library with a plain C interface, in its own directory under
``build/kernels/`` at the root of the checkout, so that several sources can
build at once.  The loader rebuilds when a source changes.  No source
includes a PyTorch header, so a build takes seconds.  A failed build raises.
"""
from __future__ import annotations

import time
from pathlib import Path

BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17"]


def build(name: str, source: Path, flags=()) -> dict:
    """Compile ``source`` as library ``repro_torch_<name>`` (a no-op when it
    is already built), with ``flags`` added to ``CUDA_FLAGS``.  Returns
    ``{"path", "seconds"}``."""
    from torch.utils.cpp_extension import load
    build_dir = BUILD_ROOT / name
    build_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    path = load(name=f"repro_torch_{name}", sources=[str(source)],
                build_directory=str(build_dir),
                extra_cuda_cflags=CUDA_FLAGS + list(flags),
                is_python_module=False, verbose=False)
    return {"path": path, "seconds": time.perf_counter() - t0}
