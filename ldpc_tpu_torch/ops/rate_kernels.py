"""Instruction-rate probes (CUDA) and their plain PyTorch versions.

Replaces the two Pallas kernels of the JAX package's roofline accounting:

* ``ldpc_tpu/analysis/roofline.py:300`` ``_rate_kernel`` (chain bodies
  ``:312-329``, prng ``:332-347``, ``pallas_call`` ``:363``) by
  :class:`RateChain`: a dependent chain of ``depth`` bodies of one op class
  on an f32 tile;
* ``ldpc_tpu/analysis/roofline.py:525`` ``measure_mix_rate.build``
  (``pallas_call`` ``:544``) by :class:`MixChain`: ``streams`` independent
  chains that run a census op schedule, summed at the end.

Both kernels live in ``csrc/roofline.cu`` and are built with the decode
kernels' flags (``-fmad=false``, no fast math), so a rate prices the
instructions K1-K3 run: accurate ``tanhf``, ``logf``, IEEE ``/``,
``sqrtf``, ``cosf``, and FMUL + FADD where the source writes ``x * a + b``.
They are bound by instruction issue: the tile is read once and written once.
What one body costs on the card (SASS instructions of the hot loop over its
bodies, ``loop_instructions``) and which pipes they load (``pipe_counts``,
priced by ``pipe_bound`` at compute capability 9.0's rates) are printed by
``chip_smoke.py`` and kept in PERF.md.

Layout: one value per thread in a register. The tile is [R, C] with R a
multiple of 32; warp w holds rows 32*(w // C) .. +31 of column w % C, lane
r row r of that strip. A roll along axis 0 (``roll``: the tile rotated up
one row) is a store to a per-warp slot of shared memory, ``__syncwarp``, and
a load at ``(lane + 1) & 31``, the indexed shared-memory read the decode
kernels pay for a roll; two slots alternate, so one warp barrier per roll
suffices. With R = 32 that is the JAX chain's rotation of the whole tile;
with more rows, each 32-row strip rotates on its own.

Each wrapper takes its plain version for a tensor on the CPU and launches
the kernel for a CUDA tensor (it raises on what the kernel does not take;
there is no fallback). ``RATE_KERNEL.launches`` / ``MIX_KERNEL.launches``
count the launches.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from ldpc_tpu_torch.ops import build
from ldpc_tpu_torch.ops.build import Kernel
from ldpc_tpu_torch.ops.mc_kernels import philox4x32

# op codes, in csrc/roofline.cu's enum order
OPS = ("fma", "roll", "where", "tanh", "log", "div", "sqrt", "cossin", "prng")
UNROLL = 16  # bodies per loop trip of the K4 kernel
THREADS = 256  # K4's block; K5's full-occupancy block
ROWS = 32  # rows of a roll strip (one warp)
PRNG_KEY = (7, 11)  # Philox key of the prng chain (pltpu.prng_seed(7, 11))
U24 = float(2.0**-24)
MAX_SCHEDULE = 128  # K5 schedule ops the defines can carry (8 words of 16)

# census ops one body retires on the card under -fmad=false: the class op
# and its fma-class stabilizers (fma: FMUL + FADD; where: add, mul, and the
# compare+select; log: mul, add, log; prng: the word, shift, cast, mul, add)
OPS_PER_BODY = {"fma": 2, "roll": 1, "where": 3, "tanh": 2, "log": 3,
                "div": 2, "sqrt": 2, "cossin": 1, "prng": 5}

_P = ctypes.c_void_p
_I = ctypes.c_int

RATE_KERNEL = Kernel(
    "roofline", "rate_chain_launch",
    [_P, _P, _I, _I, _I, _I, _I,  # x y rows cols op trips threads
     _I, _P],  # device stream
)
MIX_KERNEL = Kernel(
    "roofline", "mix_launch",
    [_P, _P, _I, _I, _I, _I,  # x y rows cols n_iters threads
     _I, _P],  # device stream
)


def body(op: str, x: torch.Tensor) -> torch.Tensor:
    """One body of class ``op`` (``roofline.py:312-329``), op for op as the
    kernel runs it; ``roll`` rotates each 32-row strip up one row."""
    if op == "fma":
        return x * 0.9998779296875 + 0.0001220703125
    if op == "roll":
        R, C = x.shape
        return x.view(R // ROWS, ROWS, C).roll(-1, dims=1).reshape(R, C)
    if op == "where":
        return torch.where(x < 0.5, x + 0.25, x * 0.5)
    if op == "tanh":
        return torch.tanh(x) + 0.25
    if op == "log":
        return torch.log(x * 0.5 + 1.7)
    if op == "div":
        y = x + 2.0
        return torch.full_like(y, 3.0) / y  # IEEE divide, not 3 * (1 / y)
    if op == "sqrt":
        return torch.sqrt(x + 1.0)
    if op == "cossin":
        return torch.cos(x)
    raise ValueError(f"no chain body for op class {op!r}")


def thread_index(rows: int, cols: int, device) -> torch.Tensor:
    """int64 [rows, cols]: the global thread that holds each element."""
    r = torch.arange(rows, dtype=torch.int64, device=device).view(rows, 1)
    c = torch.arange(cols, dtype=torch.int64, device=device).view(1, cols)
    return ((r // ROWS) * cols + c) * ROWS + r % ROWS


def _check_tile(x: torch.Tensor, threads: int) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("the tile must be a contiguous f32 [R, C] tensor")
    R, C = x.shape
    if R < ROWS or R % ROWS or (R * C) % threads:
        raise ValueError(
            f"tile {tuple(x.shape)}: rows must be a multiple of {ROWS} and "
            f"the elements a multiple of the block's {threads} threads")


def _launch_args(x: torch.Tensor):
    dev = x.device
    return dev, torch.cuda.current_stream(dev).cuda_stream


class RateChain:
    """``chain(x)``: ``depth`` dependent bodies of class ``op`` on every
    element of the f32 tile ``x`` [R, C] (R a multiple of 32; on the card
    R * C a multiple of 256); returns a new tile.

    ``prng`` adds ``(w >> 8) * 2^-24`` for each 32-bit word ``w`` of
    Philox4x32-10 (the generator K1 draws its noise from), keyed by
    :data:`PRNG_KEY` with counter (thread, call, 0, 0); one call gives four
    words, so a body is one word."""

    def __init__(self, op: str, depth: int):
        if op not in OPS:
            raise ValueError(f"unknown op class {op!r}")
        if depth < 0 or depth % UNROLL:
            raise ValueError(f"depth {depth} must be a multiple of {UNROLL}")
        self.op, self.depth = op, int(depth)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu":
            return self.plain(x)
        if x.device.type != "cuda":
            raise ValueError(f"no kernel for device {x.device}")
        _check_tile(x, THREADS)
        y = torch.empty_like(x)
        with torch.cuda.device(x.device):
            dev, stream = _launch_args(x)
            RATE_KERNEL(x.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
                        OPS.index(self.op), self.depth // UNROLL, THREADS,
                        dev.index, stream)
        return y

    def plain(self, x: torch.Tensor) -> torch.Tensor:
        """The kernel's arithmetic in PyTorch, on any device."""
        if self.op != "prng":
            for _ in range(self.depth):
                x = body(self.op, x)
            return x
        g = thread_index(*x.shape, x.device)
        zero = torch.zeros_like(g)
        for call in range(self.depth // 4):
            for w in philox4x32(g, zero + call, zero, zero, *PRNG_KEY):
                x = x + (w >> 8).to(torch.int32).to(torch.float32) * U24
        return x


def mix_defines(schedule, streams: int) -> tuple[str, ...]:
    """The ``-D`` defines that bake a K5 schedule into ``csrc/roofline.cu``:
    ``MIX_STREAMS``, ``MIX_LEN`` and the op codes packed four bits each into
    64-bit words ``MIX_S0`` .. (no commas: ``nvcc`` splits ``-D`` at
    them)."""
    codes = [OPS.index(c) for c in schedule]
    if "prng" in schedule:
        # as the JAX mix body (roofline.py:506-523): a PRNG word has no
        # single-value chain body
        raise ValueError("the mix schedule has no body for 'prng'")
    if not 1 <= len(codes) <= MAX_SCHEDULE or not 1 <= streams <= 32:
        raise ValueError(f"schedule of {len(codes)} ops on {streams} streams: "
                         f"at most {MAX_SCHEDULE} ops and 32 streams")
    words = []
    for j in range(0, len(codes), 16):
        w = sum(c << (4 * i) for i, c in enumerate(codes[j:j + 16]))
        words.append(f"MIX_S{j // 16}=0x{w:016x}ULL")
    return (f"MIX_STREAMS={int(streams)}", f"MIX_LEN={len(codes)}", *words)


def build_mix_libraries(schedule, streams) -> dict:
    """Build the K5 library of each stream count, one ``nvcc`` each, all
    started together; returns ``build.build_all``'s report."""
    return build.build_all([("roofline", mix_defines(schedule, s))
                            for s in streams])


class MixChain:
    """``mix(x)``: the K5 probe. ``streams`` chains start from
    ``x * f32(1 + 0.001 s)``; each of ``depth`` passes applies the
    ``schedule`` (a list of op classes) in order, op ``i`` to stream
    ``i % streams``; the result is the streams' sum, left to right.

    On the card the block has ``threads`` threads (a multiple of 32, at most
    1024; the grid covers the tile, one element per thread) and ``depth``
    is even: the kernel runs two passes per loop trip, so every roll's
    shared-memory slot is known when it compiles."""

    def __init__(self, schedule, streams: int, depth: int,
                 threads: int = THREADS):
        self.schedule = list(schedule)
        self.defines = mix_defines(self.schedule, streams)
        self.streams, self.depth, self.threads = int(streams), int(depth), int(threads)
        if self.depth < 0:
            raise ValueError(f"depth {depth} must be >= 0")

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu":
            return self.plain(x)
        if x.device.type != "cuda":
            raise ValueError(f"no kernel for device {x.device}")
        if self.depth % 2 or not (32 <= self.threads <= 1024
                                  and self.threads % 32 == 0):
            raise ValueError(f"depth {self.depth} must be even and threads "
                             f"{self.threads} a multiple of 32 up to 1024")
        _check_tile(x, self.threads)
        y = torch.empty_like(x)
        with torch.cuda.device(x.device):
            dev, stream = _launch_args(x)
            MIX_KERNEL(x.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
                       self.depth, self.threads, dev.index, stream,
                       defines=self.defines)
        return y

    def plain(self, x: torch.Tensor) -> torch.Tensor:
        """The kernel's arithmetic in PyTorch, on any device."""
        xs = [x * float(np.float32(1.0 + 0.001 * s)) for s in range(self.streams)]
        for _ in range(self.depth):
            for i, op in enumerate(self.schedule):
                s = i % self.streams
                xs[s] = body(op, xs[s])
        acc = xs[0]
        for v in xs[1:]:
            acc = acc + v
        return acc

    def blocks_per_sm(self, device) -> int:
        """Blocks of ``threads`` the card keeps resident per SM (registers
        and shared memory permitting)."""
        lib = build.load(("roofline", self.defines))
        out = ctypes.c_int(0)
        rc = lib.mix_blocks_per_sm(ctypes.c_int(self.threads),
                                   ctypes.c_int(torch.device(device).index or 0),
                                   ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"mix_blocks_per_sm failed (cudaError {rc})")
        return out.value


# ---------------------------------------------------------------------------
# what a body costs: instructions of the hot loop in the built library
# ---------------------------------------------------------------------------

_SASS_LINE = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_SASS_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_SASS_BRA = re.compile(r"\bBRA\b(?:\.\w+)*\s+(?:[^,;]+,\s*)?(0x[0-9a-f]+)")


def hot_loops(sass: str) -> dict[str, list[str]]:
    """``{function: the instructions of its hot loop}`` from ``cuobjdump
    -sass`` text: the instructions (NOPs excluded) from the target of the
    function's widest conditional backward branch up to that branch; a
    function with no such branch is left out. Static: a branch's both sides
    count where the compiler keeps them inside the loop."""
    funcs: dict[str, list[tuple[int, str]]] = {}
    cur = None
    for line in sass.splitlines():
        m = _SASS_FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _SASS_LINE.match(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    out = {}
    for name, instrs in funcs.items():
        best = None
        for addr, text in instrs:
            b = _SASS_BRA.search(text)
            if b and text.startswith("@"):
                target = int(b.group(1), 16)
                if target < addr and (best is None
                                      or addr - target > best[1] - best[0]):
                    best = (target, addr)
        if best is not None:
            out[name] = [text for addr, text in instrs
                         if best[0] <= addr <= best[1]
                         and not text.startswith("NOP")]
    return out


def loop_instructions(sass: str) -> dict[str, int]:
    """``{function: instructions of its hot loop}`` (:func:`hot_loops`)."""
    return {name: len(body) for name, body in hot_loops(sass).items()}


# What each pipe retires per SM per clock on compute capability 9.0, in
# thread instructions (CUDA C++ Programming Guide, "Throughput of Native
# Arithmetic Instructions (Number of Results per Clock Cycle per
# Multiprocessor)"): 32-bit floating-point add, multiply, multiply-add 128;
# the reciprocal, reciprocal square root, base-2 logarithm and exponential,
# sine and cosine of the multi-function unit 16; 32-bit integer add,
# multiply, shift, compare, minimum, maximum and bitwise logic 64; "all
# other type conversions" 16. Shared memory serves 32 lanes (128 bytes) per
# clock. The table prices neither control flow nor the float compares and
# selects, which the FP32 pipe counts here; control and unknown opcodes are
# priced by issue alone.
PIPE_RATE = {"fp32": 128, "mufu": 16, "int": 64, "conv": 16, "shared": 32}
ISSUE_RATE = 4 * 32  # four schedulers issue one warp instruction each a clock
PIPE_OPCODES = {
    "fp32": ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FSET"),
    "mufu": ("MUFU",),
    "int": ("IMAD", "IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR",
            "ISETP", "SEL", "IMNMX", "IABS", "LEA", "PRMT", "MOV",
            "IMUL", "BMSK", "FLO", "POPC", "BREV", "PLOP3", "P2R", "R2P",
            "S2R", "CS2R", "S2UR", "VOTE", "SHFL", "UMOV", "UIADD3",
            "ULDC", "ULOP3", "USHF", "UIMAD", "ISCADD"),
    "conv": ("I2F", "F2I", "F2F", "I2I", "FRND", "I2FP", "F2IP"),
    "shared": ("LDS", "STS", "ATOMS", "LDSM"),
    "control": ("BRA", "BAR", "BSSY", "BSYNC", "WARPSYNC", "EXIT", "RET",
                "CALL", "JMP", "BREAK", "YIELD", "DEPBAR", "NANOSLEEP",
                "MEMBAR", "ERRBAR", "CCTL", "WARPGROUP"),
}
_PIPE_OF = {op: pipe for pipe, ops in PIPE_OPCODES.items() for op in ops}
PIPES = (*PIPE_OPCODES, "other")


def opcode(text: str) -> str:
    """The opcode of one SASS instruction, predicate and modifiers
    dropped: ``@!P0 BRA 0x10`` -> ``BRA``, ``MUFU.EX2 R1, R2`` -> ``MUFU``."""
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def pipe_counts(instructions) -> dict[str, int]:
    """Instructions of a hot loop by pipe (:data:`PIPE_OPCODES`); an opcode
    of no listed pipe counts under ``other``, never dropped."""
    counts = dict.fromkeys(PIPES, 0)
    for text in instructions:
        counts[_PIPE_OF.get(opcode(text), "other")] += 1
    return counts


def pipe_bound(counts: dict[str, float], units: float,
               issue_peak: float) -> tuple[float, str, dict[str, float]]:
    """The least time (s) of ``units`` repetitions of a loop body of
    ``counts`` instructions by pipe, on a card whose issue peak is
    ``issue_peak`` thread instructions a second (SMs x 128 x clock): the
    larger of the issue term (every instruction at 128 a clock per SM) and
    each pipe's term (its instructions at its :data:`PIPE_RATE`). Returns
    ``(seconds, the term that sets it, every term)``."""
    total = sum(counts.values())
    terms = {"issue": units * total / issue_peak}
    for pipe, rate in PIPE_RATE.items():
        terms[pipe] = units * counts.get(pipe, 0) * (ISSUE_RATE / rate) \
            / issue_peak
    by = max(terms, key=terms.get)
    return terms[by], by, terms


def library_hot_loops(lib) -> dict[str, list[str]]:
    """:func:`hot_loops` of a built library (``cuobjdump`` from the toolkit
    that holds ``nvcc``)."""
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.library_path(lib))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    return hot_loops(sass)


def instructions_per_body(loops: dict[str, list[str]]) -> dict[str, float]:
    """K4's hot-loop instructions per body, by op class, from
    :func:`hot_loops` (the loop runs :data:`UNROLL` bodies; its counter and
    branch are spread over them)."""
    return {op: len(loops[f"rate_chain_{op}"]) / UNROLL for op in OPS
            if f"rate_chain_{op}" in loops}
