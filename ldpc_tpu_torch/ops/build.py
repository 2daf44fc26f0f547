"""Build the CUDA sources with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/ldpc_tpu_torch/<name>-<hash>.so`` at the checkout's root (a
directory ``.gitignore`` lists); the hash covers the source and the flags,
so an edited source builds anew. Nothing is compiled when a module is
imported: the first launch builds, or :func:`build_all` does it up front
(one ``nvcc`` per source, all started together).

``-fmad=false`` keeps ``nvcc`` from contracting ``a*b+c`` into FMAs, so the
kernels round exactly as their plain PyTorch versions do, op by op.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "ldpc_tpu_torch"
SOURCES = ("mc_decoder",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, PyTorch's idea of it, or ``PATH``."""
    homes = [os.environ.get("CUDA_HOME")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME

        homes.append(CUDA_HOME)
    except ImportError:
        pass
    for home in homes:
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names=SOURCES, verbose: bool = False) -> dict[str, dict]:
    """Compile every source that has no current library, in parallel.

    Returns ``{name: {"seconds": t, "log": compiler output}}`` for the
    sources built now (``verbose`` adds ``-Xptxas -v``: registers, shared
    memory and spills per kernel). Raises with the compiler's output if a
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    built = {}
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
        built[name] = {"seconds": time.perf_counter() - t0, "log": log}
    return built


def load(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        build_all((name,))
        _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]


class Kernel:
    """One C launch function of a built library, with a launch count.

    ``kernel(*args)`` calls the function, which launches on the stream it is
    given and returns ``cudaGetLastError()``; a nonzero code raises.
    ``launches`` counts successful calls; the wrappers never call with an
    empty batch, so each is one launch."""

    def __init__(self, library: str, symbol: str, argtypes: list):
        self.library = library
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def _bind(self):
        if self._fn is None:
            lib = load(self.library)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = lib.cuda_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._err = fn, err
        return self._fn

    def __call__(self, *args) -> None:
        rc = self._bind()(*args)
        if rc != 0:
            raise RuntimeError(
                f"{self.symbol} failed: {self._err(rc).decode()} (cudaError {rc})"
            )
        self.launches += 1
