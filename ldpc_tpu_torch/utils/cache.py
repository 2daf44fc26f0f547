"""The kernel build cache of the port.

Counterpart of ``ldpc_tpu/utils/cache.py``, which points JAX at a persistent
XLA compilation cache. The port's compiled artifacts are the ``nvcc``
libraries of ``ops/build.py``, keyed by a hash of their source, headers,
flags and defines, so the build directory is the cache: every process after
the first that finds a library there loads it instead of compiling it.

Call :func:`enable_compile_cache` before the first launch. The scripts call
it where the JAX scripts do; set ``LDPC_TPU_NO_COMPILE_CACHE=1`` for a cold
build (e.g. when measuring the build time itself).
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile

from ldpc_tpu_torch.ops import build


def enable_compile_cache(path: str | None = None) -> str | None:
    """Point the kernel builds at a persistent directory.

    ``path``, else ``$LDPC_TPU_COMPILE_CACHE``, else the default
    ``build/ldpc_tpu_torch/`` at the checkout's root. Returns the directory,
    or ``None`` when ``LDPC_TPU_NO_COMPILE_CACHE`` is set: the builds then go
    to a fresh temporary directory, removed when the process exits. Safe to
    call more than once."""
    if os.environ.get("LDPC_TPU_NO_COMPILE_CACHE"):
        cold = tempfile.mkdtemp(prefix="ldpc_tpu_torch_build_")
        atexit.register(shutil.rmtree, cold, ignore_errors=True)
        build.set_build_dir(cold)
        return None
    cache_dir = (path or os.environ.get("LDPC_TPU_COMPILE_CACHE")
                 or build.DEFAULT_BUILD_DIR)
    os.makedirs(cache_dir, exist_ok=True)
    return str(build.set_build_dir(cache_dir))
