"""Build the CUDA sources with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/ldpc_tpu_torch/<name>-<hash>.so`` at the checkout's root (a
directory ``.gitignore`` lists; ``utils.cache.enable_compile_cache`` moves
it through :func:`set_build_dir`): K1, K2 and K3 are one source each over the
shared decode body ``csrc/decode_group.cuh``, K6 (the QAM channel), K7
(a batch's counters) and K8 (the GF(2) encode) one each on their own. The
hash covers the source, the headers of ``csrc``, the flags and the
library's own ``-D`` defines, so an edited source or header builds anew and
one source can give several libraries (K5's schedule is baked in by
defines).
Nothing is compiled when a module is imported: the first launch builds, or
:func:`build_all` does it up front (one ``nvcc`` per library, all started
together). A library is named by its source, or by ``(source, defines)``.
Every build runs ``ptxas -v`` and keeps its output beside the library
(:func:`ptxas_log`, read by :func:`ptxas_report`: registers and spill bytes
per kernel).

``-fmad=false`` keeps ``nvcc`` from contracting ``a*b+c`` into FMAs, so the
kernels round exactly as their plain PyTorch versions do, op by op.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

from ldpc_tpu_torch.utils import timing

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
DEFAULT_BUILD_DIR = PKG_DIR.parent / "build" / "ldpc_tpu_torch"
BUILD_DIR = DEFAULT_BUILD_DIR
SOURCES = ("mc_decoder", "llr_decoder", "qc_decoder", "roofline",
           "qam_channel", "batch_counters", "gf2_encode")
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


def set_build_dir(path) -> Path:
    """Build and look up the libraries under ``path`` from now on (a library
    loaded already stays loaded). Returns the directory."""
    global BUILD_DIR
    BUILD_DIR = Path(path)
    return BUILD_DIR


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
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + headers
                            + " ".join(_flags(defines)).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def ptxas_log(lib) -> str:
    """The compiler output of a built library's build (``-Xptxas -v``)."""
    return library_path(lib).with_suffix(".log").read_text()


def build_all(libs=SOURCES) -> dict[str, dict]:
    """Compile every library that is not built yet, in parallel.

    Returns ``{label: {"seconds": t, "log": compiler output}}`` for the
    libraries built now; the output (with ``ptxas -v``: registers, shared
    memory and spills per kernel) is kept beside each library. Raises with
    the compiler's output if a build fails."""
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
        cmd = [nvcc, *_flags(defines), "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[library_label(lib)] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            tmp, out, time.perf_counter())
    built = {}
    for label, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        built[label] = {"seconds": time.perf_counter() - t0, "log": log}
    return built


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_BARS = re.compile(r"used (\d+) barriers")
_KERNEL = re.compile(r"([a-z][a-z_]*_kernel)I((?:L[a-z]\d+E)+)E")


def kernel_label(mangled: str) -> str:
    """``mc_decoder_kernel<8,768,1>`` from a mangled template kernel name
    (the name itself when it is not a template)."""
    m = _KERNEL.search(mangled)
    if m is None:
        return mangled
    args = re.findall(r"L[a-z](\d+)E", m.group(2))
    return f"{m.group(1)}<{','.join(args)}>"


def ptxas_report(log: str) -> dict[str, dict]:
    """Registers, barriers, stack frame and spill bytes per kernel from the
    output of a ``-Xptxas -v`` build: ``{label: {"registers", "barriers",
    "stack", "spill_stores", "spill_loads"}}``, labels as
    :func:`kernel_label` gives them."""
    out: dict[str, dict] = {}
    entry = props = None
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            entry = kernel_label(m.group(1))
            out.setdefault(entry, {})
        elif m := _PROPS.search(line):
            props = kernel_label(m.group(1))
        elif (m := _FRAME.search(line)) and props is not None:
            out.setdefault(props, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        elif (m := _REGS.search(line)) and entry is not None:
            out[entry]["registers"] = int(m.group(1))
            if b := _BARS.search(line):
                out[entry]["barriers"] = int(b.group(1))
    return out


def load(lib) -> ctypes.CDLL:
    """The loaded library, built first if it is not; the first load is a
    ``library.load`` span whose ``built`` says whether ``nvcc`` ran."""
    key = _spec(lib)
    if key not in _LIBS:
        with timing.span("library.load", library=library_label(key)) as span:
            span.attrs["built"] = bool(build_all((key,)))
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


def check_arg(t, name: str, dtype, shapes: tuple, device,
              none_ok: bool = False) -> None:
    """Raise ValueError unless tensor ``t`` has ``dtype`` (or one of a tuple
    of dtypes), one of ``shapes``, is contiguous and on ``device`` (or is
    None, where ``none_ok``): what a wrapper checks before it hands a kernel
    raw pointers."""
    if t is None:
        if none_ok:
            return
        raise ValueError(f"{name} is missing")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) not in shapes:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         + " or ".join(str(sh) for sh in shapes))
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
