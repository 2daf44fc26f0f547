"""Build the CUDA sources with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/ldpc_tpu_torch/<name>-<hash>.so`` at the checkout's root (a
directory ``.gitignore`` lists); the hash covers the source, the flags and
the library's own ``-D`` defines, so an edited source builds anew and one
source can give several libraries (K5's schedule is baked in by defines).
Nothing is compiled when a module is imported: the first launch builds, or
:func:`build_all` does it up front (one ``nvcc`` per library, all started
together). A library is named by its source, or by ``(source, defines)``.

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
SOURCES = ("mc_decoder", "roofline")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false")

_LIBS: dict[tuple, ctypes.CDLL] = {}


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


def _spec(lib) -> tuple[str, tuple[str, ...]]:
    """``name`` or ``(name, defines)`` -> ``(name, defines)``."""
    return (lib, ()) if isinstance(lib, str) else (lib[0], tuple(lib[1]))


def library_label(lib) -> str:
    name, defines = _spec(lib)
    return f"{name}[{' '.join(defines)}]" if defines else name


def _flags(defines) -> list[str]:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def library_path(lib) -> Path:
    name, defines = _spec(lib)
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(defines)).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(libs=SOURCES, verbose: bool = False) -> dict[str, dict]:
    """Compile every library that is not built yet, in parallel.

    Returns ``{label: {"seconds": t, "log": compiler output}}`` for the
    libraries built now (``verbose`` adds ``-Xptxas -v``: registers, shared
    memory and spills per kernel). Raises with the compiler's output if a
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for lib in libs:
        name, defines = _spec(lib)
        out = library_path(lib)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(defines), *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[library_label(lib)] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            tmp, out, time.perf_counter())
    built = {}
    for label, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        os.replace(tmp, out)
        built[label] = {"seconds": time.perf_counter() - t0, "log": log}
    return built


def load(lib) -> ctypes.CDLL:
    key = _spec(lib)
    if key not in _LIBS:
        build_all((key,))
        _LIBS[key] = ctypes.CDLL(str(library_path(key)))
    return _LIBS[key]


class Kernel:
    """One C launch function of a built library, with a launch count.

    ``kernel(*args, defines=())`` calls the function in the library built
    from ``library`` with those defines; it launches on the stream it is
    given and returns ``cudaGetLastError()``; a nonzero code raises.
    ``launches`` counts successful calls over every such library; the
    wrappers never call with an empty batch, so each is one launch."""

    def __init__(self, library: str, symbol: str, argtypes: list):
        self.library = library
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fns: dict[tuple, tuple] = {}

    def _bind(self, defines: tuple):
        if defines not in self._fns:
            lib = load((self.library, defines))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = lib.cuda_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fns[defines] = (fn, err)
        return self._fns[defines]

    def __call__(self, *args, defines=()) -> None:
        fn, err = self._bind(tuple(defines))
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(
                f"{self.symbol} failed: {err(rc).decode()} (cudaError {rc})"
            )
        self.launches += 1
