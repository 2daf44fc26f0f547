"""Fused Monte-Carlo kernels (CUDA) and their plain PyTorch versions.

Replaces the two Pallas kernels of the JAX package's main path:

* ``ldpc_tpu/ops/mc_pallas.py:142`` ``make_mc_decoder`` (kernel body
  ``:295-376``, ``pallas_call`` ``:378``) by :class:`MCDecoder`: modulation,
  noise, channel LLRs, the QC decode loop and the info-bit error counts in one
  kernel, optionally emitting the channel LLRs for phase 2;
* ``ldpc_tpu/ops/mc_pallas.py:494`` ``make_llr_decoder`` (kernel body
  ``:561-601``, ``pallas_call`` ``:603``) by :class:`LLRDecoder`: the same
  decode and counts from given LLRs with a per-lane pre-done mask.

Both kernels live in ``csrc/mc_decoder.cu`` and share one ``__device__``
decode loop (``decode_group``), the counterpart of
``spa_pallas.make_decode_loop``, with the standalone QC decoder K3
(``qc_kernels.py``). What bounds them on the card: instruction issue on a
chain of dependent layer steps per codeword (a gather along Z, SPA's tanh /
log / division combine, a scatter, a barrier); the card's memory traffic is
small (the codeword bits in, five counter rows out, the LLRs when emitted).
Their design, point by point (the source's note has the detail, ``PERF.md``
the time each point bought):

1. per-codeword progress: a block is one barrier group, one codeword over
   whole warps (or up to 8 codewords sharing a warp where rows x Z < 32),
   that leaves once its codewords pass the syndrome check; the block plan
   (:func:`fused_plan`) is decided once, here: at the bench code a block is
   one codeword of 96 threads, 8 resident per SM;
2. no spills at DMAX=8: a 768-thread launch bound (80 registers) and a
   leave-one-out combine that holds 2 x DMAX values;
3. precomputed gathers: :func:`gather_offsets`, staged in shared memory;
4. lane-fastest device-memory loads and stores, so a warp reads adjacent
   codewords of one row.

The posteriors L and extrinsics E of a block's codewords stay in shared
memory for the whole decode (no device-memory traffic per iteration).

Each wrapper takes its plain version for a tensor on the CPU and launches
the kernel for a CUDA tensor (it raises on what the kernel does not take;
there is no fallback). ``MC_KERNEL.launches`` / ``LLR_KERNEL.launches``
count the launches.

Noise: ``raw`` words in the injected layout of the JAX kernel's
``noise_source='input'`` ([draws, n, B] uint32, :data:`DRAWS_PER_BIT`), or a
counter-based Philox4x32-10 keyed by two words the caller derives from
(seed, point, batch). Philox fills the same layout (:func:`philox_raw`), and
both go through one Box-Muller with the 48-bit radial uniform
(``mc_pallas.py:82-120``; magnitude cap 8.24 sigma).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from ldpc_tpu_torch.models.qc import QCLayout
from ldpc_tpu_torch.ops.build import Kernel
from ldpc_tpu_torch.ops.channel import CONSTS_ORDER
from ldpc_tpu_torch.ops.decode_loop import (
    DecodeLoop,
    QCTables,
    build_tables,
    normalize_variant,
)

TWO_PI = 2.0 * math.pi
_U24 = float(2.0**-24)
_HALF_U24 = float(2.0**-25)
_U48 = float(2.0**-48)
_HALF_U48 = float(2.0**-49)
_ONE_MINUS_U24 = float(1.0 - 2.0**-24)  # largest f32 strictly below 1
_M32 = 0xFFFFFFFF

# raw-plane slots per bit in the injected layout, by channel mode: each
# normal pair takes three planes (radial hi, radial lo, angle), mode 2 adds
# the jam uniform (``mc_pallas.py:123-130``)
DRAWS_PER_BIT = {1: 3, 2: 7, 3: 6}

_VARIANT_CODE = {"spa": 0, "minsum": 1, "normalized_minsum": 2,
                 "offset_minsum": 3}
_DMAX_TEMPLATES = (8, 16, 32)  # kernel instantiations by max row degree
_SMEM_LIMIT = 225 * 1024  # dynamic shared memory a block may use (H100)


# ---------------------------------------------------------------- noise ----

def _words(raw: torch.Tensor) -> torch.Tensor:
    """uint32 / int32 words -> int64 in [0, 2^32)."""
    return raw.to(torch.int64) & _M32


def uniform01(w: torch.Tensor) -> torch.Tensor:
    """word -> f32 uniform in (0, 1) with a 24-bit mantissa."""
    return (w >> 8).to(torch.int32).to(torch.float32) * _U24 + _HALF_U24


def uniform01_48(hi_w: torch.Tensor, lo_w: torch.Tensor) -> torch.Tensor:
    """Two words -> f32 uniform in (0, 1) with 48-bit depth (min 2^-49)."""
    hi = (hi_w >> 8).to(torch.int32).to(torch.float32)
    lo = (lo_w >> 8).to(torch.int32).to(torch.float32)
    return torch.clamp_max(hi * _U24 + (lo * _U48 + _HALF_U48), _ONE_MINUS_U24)


def box_muller2(raw1, raw1_lo, raw2):
    """Two independent standard normals (cos, sin) from three words."""
    u1 = uniform01_48(_words(raw1), _words(raw1_lo))
    u2 = uniform01(_words(raw2))
    r = torch.sqrt(-2.0 * torch.log(u1))
    ang = TWO_PI * u2
    return r * torch.cos(ang), r * torch.sin(ang)


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit halves of ``a * m`` for ``a`` in [0, 2^32), exact in
    int64 (the product is split at 16 bits)."""
    t_lo = (a & 0xFFFF) * m
    t_hi = (a >> 16) * m
    s = ((t_hi & 0xFFFF) << 16) + t_lo
    return ((t_hi >> 16) + (s >> 32)) & _M32, s & _M32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors of 32-bit words."""
    for r in range(10):
        if r:
            k0 = (k0 + 0x9E3779B9) & _M32
            k1 = (k1 + 0xBB67AE85) & _M32
        hi0, lo0 = _mulhilo(c0, 0xD2511F53)
        hi1, lo1 = _mulhilo(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_raw(key: tuple[int, int], n: int, Z: int, B: int, mode: int,
               device) -> torch.Tensor:
    """The Philox source's words in the injected layout, int64 [draws, n, B].

    Column pair p (base columns 2p, 2p+1), row z and lane b draw
    ``philox(counter=(b, p*Z + z, call, 0), key)``. Call 0 gives planes
    0-2 of column 2p (and, in mode 2, the jam word of column 2p); call 1
    (modes 2/3) planes 3-5 of column 2p and the jam word of column 2p+1.
    The kernel draws the same words in place."""
    nb = n // Z
    P = (nb + 1) // 2
    k0, k1 = int(key[0]) & _M32, int(key[1]) & _M32
    b = torch.arange(B, dtype=torch.int64, device=device).view(1, 1, B)
    pz = torch.arange(P * Z, dtype=torch.int64, device=device).view(P, Z, 1)
    c0 = b.expand(P, Z, B)
    c1 = pz.expand(P, Z, B)
    zero = torch.zeros((P, Z, B), dtype=torch.int64, device=device)
    raw = torch.zeros((DRAWS_PER_BIT[mode], nb, Z, B), dtype=torch.int64,
                      device=device)
    x = philox4x32(c0, c1, zero, zero, k0, k1)
    for d in range(3):
        raw[d, 0::2] = x[d]
    if mode != 1:
        y = philox4x32(c0, c1, zero + 1, zero, k0, k1)
        for d in range(3):
            raw[3 + d, 0::2] = y[d]
        if mode == 2:
            raw[6, 0::2] = x[3]
            raw[6, 1::2] = y[3][: nb // 2]
    return raw.view(DRAWS_PER_BIT[mode], n, B)


def channel_llr_reference(wT: torch.Tensor, raw: torch.Tensor,
                          consts: torch.Tensor, mode: int, modulation: int,
                          Z: int) -> torch.Tensor:
    """Plain version of the kernel's bits -> LLR transform (channel sign
    convention, before the negation into log(p0/p1)); counterpart of
    ``mc_pallas.channel_llr_reference``. Adjacent base columns share one
    Box-Muller draw (cos to the even column, sin to the odd one, both from
    the even column's planes); mode 2's jam uniform reads plane 6 of its own
    column."""
    amp = 1.0 if modulation == 1 else 0.7
    n, B = wT.shape
    nb = n // Z
    c = {name: consts[i] for i, name in enumerate(CONSTS_ORDER)}
    sym = (2.0 * wT.to(torch.float32) - 1.0) * amp
    rw = raw.view(raw.shape[0], nb, Z, B)
    ev = slice(0, nb, 2)

    def normals(d0):
        a, b = box_muller2(rw[d0, ev], rw[d0 + 1, ev], rw[d0 + 2, ev])
        z = torch.empty((nb, Z, B), dtype=torch.float32, device=wT.device)
        z[0::2] = a
        z[1::2] = b[: nb // 2]
        return z.view(n, B)

    zA = normals(0)
    if mode == 1:
        return c["llr_scale"] * (sym + c["noise1_std"] * zA)
    zB = normals(3)
    n1 = c["sigma1"] * zA
    n2 = c["sigma2"] * zB
    if mode == 2:
        jam = uniform01(_words(raw[6])) < c["p"]
        return torch.where(jam, (sym + n1 + n2) * c["l_c2"],
                           (sym + n1) * c["l_c1"])
    return ((sym + n1 + n2) * c["p"] + (sym + n1) * (1.0 - c["p"])) * c["l_c3"]


# -------------------------------------------------------------- kernels ----

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32

# decode-loop arguments shared by the three decode kernels (see
# csrc/mc_decoder.cu): :func:`loop_args`
LOOP_ARGS = [_P,  # tables
             _I, _I, _I, _I, _I, _I, _I, _I,  # n Z nb mb e_slots ngroups R B
             _I, _I, _I, _F, _F,  # max_it check_every variant alpha beta
             _I, _I,  # dmax has_dup
             _I, _I, _I, _I]  # the FusedPlan: cpg tpg Ls smem

MC_KERNEL = Kernel(
    "mc_decoder", "mc_decoder_launch",
    [_P, _P, _P,  # w, raw, consts
     _P, _P, _P, _P, _P, _P]  # err ok conv norm iters llr_out
    + LOOP_ARGS
    + [_I, _F, _I, _U, _U, _I,  # mode amp noise_input key0 key1 skip
       _I, _P],  # device stream
)
LLR_KERNEL = Kernel(
    "mc_decoder", "llr_decoder_launch",
    [_P, _P, _P,  # llr, w, done0
     _P, _P, _P, _P, _P]  # err ok conv norm iters
    + LOOP_ARGS
    + [_I, _P],  # device stream
)


def kernel_dmax(tables: QCTables) -> int:
    for d in _DMAX_TEMPLATES:
        if tables.dmax <= d:
            return d
    raise ValueError(
        f"row degree {tables.dmax} exceeds the kernel's largest "
        f"instantiation ({_DMAX_TEMPLATES[-1]})"
    )


def table_len(tables: QCTables, flood: bool = False) -> int:
    """Ints of the schedule tables the kernels stage in shared memory before
    the gather offsets (a flooding schedule has no layer groups and adds the
    column tables)."""
    qc = tables.qc
    if flood:
        return (qc.mb + 1) + 4 * tables.e_slots + qc.mb + (qc.nb + 1)
    ng = len(tables.groups)
    return (qc.mb + 1) + 2 * tables.e_slots + ng * tables.R + ng + qc.mb


def gather_offsets(tables: QCTables) -> np.ndarray:
    """uint16 [e_slots, Z]: the L offset ``slot_col * Z + (z + shift) % Z``
    that check row ``z`` of each flattened edge slot reads and writes (slot
    ``row_off[bi] + j`` is slot ``j`` of base row ``bi``; a layer group's
    rows are its slots' rows). The kernels stage it in shared memory, so an
    edge costs one table load instead of two plus a multiply and a wrap; the
    syndrome check reads it too."""
    qc = tables.qc
    if qc.n > np.iinfo(np.uint16).max:
        raise ValueError(f"n={qc.n} does not fit the uint16 gather offsets")
    z = np.arange(qc.Z, dtype=np.int64)
    col = tables.slot_col.astype(np.int64)[:, None]
    shift = tables.slot_shift.astype(np.int64)[:, None]
    return (col * qc.Z + (z[None, :] + shift) % qc.Z).astype(np.uint16)


def gather_words(tables: QCTables) -> int:
    """Ints the gather offsets take in the table (two uint16 per int)."""
    return (tables.e_slots * tables.qc.Z + 1) // 2


def kernel_table(tables: QCTables, info_pos, flood: bool = False) -> np.ndarray:
    """int32 table the kernels read, in ``csrc/mc_decoder.cu``'s order: row
    offsets, slot columns and shifts, layer groups (padded with -1) and their
    multi-diagonal flags (none under flooding), multi-diagonal rows, the
    column tables (flooding only), the gather offsets
    (:func:`gather_offsets` packed two to an int, low half first), then the
    info mask [n] (read from device memory, not staged)."""
    t = tables
    info_mask = np.zeros(t.qc.n, np.int32)
    info_mask[np.asarray(info_pos, np.int64)] = 1
    parts = [t.row_off, t.slot_col, t.slot_shift]
    if flood:
        parts += [t.row_dup, *t.column_slots()]
    else:
        groups = np.full((len(t.groups), t.R), -1, np.int32)
        for g, rows in enumerate(t.groups):
            groups[g, :len(rows)] = rows
        grp_dup = np.asarray(
            [int(any(t.row_dup[bi] for bi in rows)) for rows in t.groups],
            np.int32)
        parts += [groups.ravel(), grp_dup, t.row_dup]
    g = gather_offsets(t).ravel()
    g = np.concatenate([g, np.zeros(g.size % 2, np.uint16)])
    parts.append(g.astype("<u2").view("<i4"))
    return np.concatenate(parts + [info_mask]).astype(np.int32)


MAX_THREADS = 768  # csrc/mc_decoder.cu: the decode kernels' launch bound


@dataclass(frozen=True)
class FusedPlan:
    """The block of the decode kernels (K1, K2, K3). The wrappers pass it to
    the kernels' entry points, which only validate it (``bad_plan`` in
    ``csrc/mc_decoder.cu``: a shared memory size that differs from the
    layout's is refused).

    A block is one barrier group of ``lanes`` codewords and ``threads``
    threads (a multiple of 32): one codeword's ``rows x Z`` threads padded
    to whole warps, or, where ``rows x Z < 32``, up to ``32 // (rows x Z)``
    codewords (a power of two, at most 8) sharing one warp. ``rows`` is the
    layer group's rows (layered) or 2 check rows per step (flooding, where
    the code has them). ``l_stride`` is a codeword's L row in shared memory
    (n, padded where lanes > 1 so that the lanes of a lane-fastest warp
    start in different banks); ``smem`` the block's dynamic shared
    memory."""

    lanes: int
    rows: int
    row_threads: int  # rows x Z: the threads of one codeword's step
    threads: int
    l_stride: int
    flood: bool
    smem: int

    @property
    def padding_threads(self) -> int:
        """Threads of the block that hold no (row, z) of a codeword."""
        return self.threads - self.lanes * self.row_threads

    def launch_args(self) -> list:
        """The plan as the entry points take it: cpg, tpg, Ls, smem."""
        return [self.lanes, self.threads, self.l_stride, self.smem]


def fused_smem_bytes(tables: QCTables, lanes: int, l_stride: int,
                     flood: bool = False) -> int:
    """Dynamic shared memory of a block: L [lanes][l_stride], E
    [lanes][e_slots * Z], the multi-diagonal deltas [lanes][R * DMAX * Z]
    (layered only), then the schedule tables with the gather offsets. (The
    flooding schedule's channel LLRs stay in device memory: the source's
    note has the bytes.)"""
    qc = tables.qc
    per_lane = l_stride + tables.e_slots * qc.Z
    if tables.has_dup and not flood:
        per_lane += tables.R * kernel_dmax(tables) * qc.Z
    return 4 * (lanes * per_lane + table_len(tables, flood)
                + gather_words(tables))


def fused_plan(tables: QCTables, flood: bool = False) -> FusedPlan:
    """The decode kernels' block: one barrier group, one codeword where a
    step fills a warp (``rows x Z >= 32``: 96 threads at the bench code),
    else the codewords that share one warp. A block then holds its SM only
    while its codewords decode, so a converged codeword frees its place for
    the next block at once (``PERF.md``: the block-plan ladder). A layered
    step runs its layer group's rows; a flooding step 2 check rows where the
    code has them (``mb >= 2`` and ``2 x Z`` within the launch bound).
    Raises, with the bytes, when the block exceeds the launch bound or the
    shared memory of a block."""
    qc = tables.qc
    Z = qc.Z
    if flood:
        R = 2 if qc.mb >= 2 and 2 * Z <= MAX_THREADS else 1
    else:
        R = tables.R
    RZ = R * Z
    lanes = 1
    while 2 * lanes * RZ <= 32 and 2 * lanes <= 8:
        lanes *= 2
    threads = 32 if RZ < 32 else -(-RZ // 32) * 32
    stride = qc.n if lanes == 1 else qc.n + (32 // lanes - qc.n) % 32
    plan = FusedPlan(lanes=lanes, rows=R, row_threads=RZ, threads=threads,
                     l_stride=stride, flood=bool(flood),
                     smem=fused_smem_bytes(tables, lanes, stride, flood))
    if plan.threads > MAX_THREADS or plan.smem > _SMEM_LIMIT:
        raise ValueError(
            f"code n={qc.n}, Z={Z} does not fit one block of the "
            f"{'flooding' if flood else 'layered'} decode kernels: "
            f"{lanes} codeword(s) need {plan.threads} threads (at most "
            f"{MAX_THREADS}) and {plan.smem} bytes of shared memory (at most "
            f"{_SMEM_LIMIT})")
    return plan


def loop_args(tables: QCTables, plan: FusedPlan, tab: torch.Tensor, B: int,
              max_iterations: int, check_every: int, variant: str,
              alpha: float, beta: float) -> list:
    """The decode-loop arguments of an entry point (:data:`LOOP_ARGS`)."""
    qc = tables.qc
    ngroups = 0 if plan.flood else len(tables.groups)
    has_dup = 0 if plan.flood else int(tables.has_dup)
    return [tab.data_ptr(), qc.n, qc.Z, qc.nb, qc.mb, tables.e_slots,
            ngroups, plan.rows, B, max_iterations, check_every,
            _VARIANT_CODE[variant], alpha, beta, kernel_dmax(tables), has_dup,
            *plan.launch_args()]


# kernel kinds of csrc/mc_decoder.cu's decoder_occupancy
K_MC, K_LLR, K_QC = 0, 1, 2


def blocks_per_sm(kind: int, tables: QCTables, plan: FusedPlan, device,
                  norm: bool = False) -> int:
    """Resident blocks per SM of K1 (``kind`` :data:`K_MC`), K2
    (:data:`K_LLR`) or K3 (:data:`K_QC`; the plan's schedule, ``norm``: the
    flip metric compiled in) at ``plan``'s launch shape on the card
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    from ldpc_tpu_torch.ops.build import load

    fn = load("mc_decoder").decoder_occupancy
    fn.argtypes = [_I, _I, _I, _I, _I, _I, ctypes.POINTER(_I)]
    fn.restype = _I
    blocks = _I(0)
    with torch.cuda.device(device):
        rc = fn(kind, kernel_dmax(tables), int(plan.flood), int(norm),
                plan.threads, plan.smem, ctypes.byref(blocks))
    if rc:
        raise RuntimeError(f"decoder_occupancy failed (cudaError {rc})")
    return blocks.value


class _FusedBase:
    """What both decoders share: the schedule, its device tables, the plain
    decode loop and the error count."""

    def __init__(self, qc: QCLayout, info_pos, max_iterations: int,
                 variant: str, *, alpha: float, beta: float, schedule: str,
                 layer_groups, check_every: int):
        if schedule != "layered":
            raise NotImplementedError(
                f"schedule {schedule!r}: the port's fused kernels run the "
                "layered schedule only; flooding is still to be ported "
                "(ROADMAP.md)"
            )
        self.qc = qc
        self.variant = normalize_variant(variant)
        self.tables = build_tables(qc, layer_groups)
        self.max_iterations = int(max_iterations)
        self.alpha, self.beta = float(alpha), float(beta)
        self.check_every = int(check_every)
        if self.check_every < 1 or self.max_iterations % self.check_every:
            raise ValueError(
                f"check_every={check_every} must divide "
                f"max_iterations={max_iterations}"
            )
        self.info_pos = np.asarray(info_pos, np.int64)
        self.plan = fused_plan(self.tables)
        self.lanes = self.plan.lanes
        self._per_device: dict = {}

    def blocks_per_sm(self, device) -> int:
        """Resident blocks per SM of this decoder's kernel at its launch
        shape (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
        return blocks_per_sm(K_LLR if isinstance(self, LLRDecoder) else K_MC,
                             self.tables, self.plan, device)

    def _dev(self, device: torch.device):
        """(plain decode loop, info index, kernel tables) for one device."""
        key = str(device)
        if key not in self._per_device:
            loop = DecodeLoop(self.tables, self.max_iterations, self.variant,
                              alpha=self.alpha, beta=self.beta,
                              check_every=self.check_every, lanes=self.lanes,
                              device=device)
            self._per_device[key] = (
                loop,
                torch.as_tensor(self.info_pos, device=device),
                torch.as_tensor(kernel_table(self.tables, self.info_pos),
                                device=device),
            )
        return self._per_device[key]

    def _count_errors(self, L: torch.Tensor, wT: torch.Tensor) -> torch.Tensor:
        _, info, _ = self._dev(L.device)
        est = L.index_select(0, info) < 0
        x = wT.index_select(0, info) != 0
        return (est != x).sum(dim=0).to(torch.int32)

    def _loop_args(self, tab: torch.Tensor, B: int) -> list:
        return loop_args(self.tables, self.plan, tab, B, self.max_iterations,
                         self.check_every, self.variant, self.alpha,
                         self.beta)

    @staticmethod
    def _check(name: str, x: torch.Tensor, dtype, shape, device) -> None:
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        if x.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
            raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    @staticmethod
    def _outputs(B: int, device):
        return (torch.empty(B, dtype=torch.int32, device=device),
                torch.empty(B, dtype=torch.bool, device=device),
                torch.empty(B, dtype=torch.int32, device=device),
                torch.empty(B, dtype=torch.float32, device=device),
                torch.empty(B, dtype=torch.int32, device=device))


class MCDecoder(_FusedBase):
    """``mc_step(wT, consts, seeds=None, raw=None, skip=0)``.

    ``wT``: f32 [n, B] transmitted code bits (0/1), codewords on the minor
    axis. ``consts``: f32 [8] from ``ChannelParams.consts``. Noise comes from
    ``raw`` (uint32 or int32 [draws, n, B] words in the injected layout)
    when given, else from Philox keyed by ``seeds`` (two 32-bit ints).
    ``skip`` nonzero pre-marks every lane done.

    Returns ``(err, ok, conv, norm, iters)``: int32 / bool / int32 / f32 /
    int32 [B]; ``err`` counts info-bit mismatches in every frame (callers
    apply the failed-frames rule); ``conv`` is the check iteration of
    convergence or -1; ``norm`` is zeros (the metric is K3's only);
    ``iters`` is the trip count of the lane's block (the largest of its
    codewords', its own at one codeword per block). ``emit_llr`` appends
    the channel LLRs, f32 [n, B] in the log(p0/p1) domain.
    """

    def __init__(self, qc: QCLayout, info_pos, max_iterations: int,
                 variant: str = "spa", *, mode: int = 1, modulation: int = 1,
                 alpha: float = 0.75, beta: float = 0.15,
                 schedule: str = "layered", emit_llr: bool = False,
                 layer_groups=None, check_every: int = 1):
        if mode not in DRAWS_PER_BIT:
            raise ValueError(f"Unknown channel mode: {mode}")
        if modulation not in (1, 2):
            raise ValueError("MC kernel supports modulation 1 (BPSK) / 2 (QPSK proxy)")
        super().__init__(qc, info_pos, max_iterations, variant, alpha=alpha,
                         beta=beta, schedule=schedule,
                         layer_groups=layer_groups, check_every=check_every)
        self.mode, self.modulation = mode, modulation
        self.amp = 1.0 if modulation == 1 else 0.7
        self.emit_llr = emit_llr

    def __call__(self, wT, consts, seeds=None, raw=None, skip=0):
        if wT.device.type == "cpu":
            return self.plain(wT, consts, seeds=seeds, raw=raw, skip=skip)
        if wT.device.type != "cuda":
            raise ValueError(f"no kernel for device {wT.device}")
        return self._launch(wT, consts, seeds, raw, skip)

    def plain(self, wT, consts, seeds=None, raw=None, skip=0):
        """The kernel's arithmetic in PyTorch, on any device."""
        n, B = wT.shape
        dev = wT.device
        loop, _, _ = self._dev(dev)
        if raw is None:
            if seeds is None:
                raise ValueError("pass raw words or Philox seeds")
            raw = philox_raw(seeds, n, self.qc.Z, B, self.mode, dev)
        L = -channel_llr_reference(wT, raw, consts, self.mode,
                                   self.modulation, self.qc.Z)
        llr = L.clone() if self.emit_llr else None
        done0 = torch.full((B,), bool(skip), dtype=torch.bool, device=dev)
        done, conv, iters = loop.run(L, done0)
        out = (self._count_errors(L, wT), done, conv,
               torch.zeros(B, dtype=torch.float32, device=dev), iters)
        return out + (llr,) if self.emit_llr else out

    def _launch(self, wT, consts, seeds, raw, skip):
        dev = wT.device
        n, B = self.qc.n, wT.shape[1]
        self._check("wT", wT, torch.float32, (n, B), dev)
        self._check("consts", consts, torch.float32, (8,), dev)
        if raw is not None:
            self._check("raw", raw, (torch.uint32, torch.int32),
                        (DRAWS_PER_BIT[self.mode], n, B), dev)
            key = (0, 0)
        elif seeds is None:
            raise ValueError("pass raw words or Philox seeds")
        else:
            key = (int(seeds[0]) & _M32, int(seeds[1]) & _M32)
        _, _, tab = self._dev(dev)
        outs = self._outputs(B, dev)
        llr = (torch.empty((n, B), dtype=torch.float32, device=dev)
               if self.emit_llr else None)
        if B == 0:  # nothing to launch
            return outs + (llr,) if self.emit_llr else outs
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            MC_KERNEL(
                wT.data_ptr(), None if raw is None else raw.data_ptr(),
                consts.data_ptr(), *(o.data_ptr() for o in outs),
                None if llr is None else llr.data_ptr(),
                *self._loop_args(tab, B),
                self.mode, self.amp, int(raw is not None), key[0], key[1],
                int(bool(skip)), dev.index, stream,
            )
        return outs + (llr,) if self.emit_llr else outs


class LLRDecoder(_FusedBase):
    """``llr_step(llrT, wT, done0) -> (err, ok, conv, norm, iters)``.

    Phase 2 of two-phase dispatch: ``llrT`` f32 [n, B] channel LLRs in the
    log(p0/p1) domain (as :class:`MCDecoder` emits them), ``wT`` f32 [n, B]
    transmitted bits in the same lane order, ``done0`` f32 [B] with 1.0
    pre-marking a lane done: its LLRs are not read and its outputs are
    placeholders (ok, conv -1, no errors). Outputs as for
    :class:`MCDecoder`; a block whose codewords are all pre-done only writes
    its placeholders.
    """

    def __init__(self, qc: QCLayout, info_pos, max_iterations: int,
                 variant: str = "spa", *, alpha: float = 0.75,
                 beta: float = 0.15, schedule: str = "layered",
                 layer_groups=None, check_every: int = 1):
        super().__init__(qc, info_pos, max_iterations, variant, alpha=alpha,
                         beta=beta, schedule=schedule,
                         layer_groups=layer_groups, check_every=check_every)

    def __call__(self, llrT, wT, done0):
        if llrT.device.type == "cpu":
            return self.plain(llrT, wT, done0)
        if llrT.device.type != "cuda":
            raise ValueError(f"no kernel for device {llrT.device}")
        return self._launch(llrT, wT, done0)

    def plain(self, llrT, wT, done0):
        """The kernel's arithmetic in PyTorch, on any device."""
        B = llrT.shape[1]
        loop, _, _ = self._dev(llrT.device)
        L = llrT.to(torch.float32).clone()
        pre = done0 > 0.5
        done, conv, iters = loop.run(L, pre)
        err = torch.where(pre, 0, self._count_errors(L, wT)).to(torch.int32)
        return (err, done, conv,
                torch.zeros(B, dtype=torch.float32, device=llrT.device), iters)

    def _launch(self, llrT, wT, done0):
        dev = llrT.device
        n, B = self.qc.n, llrT.shape[1]
        self._check("llrT", llrT, torch.float32, (n, B), dev)
        self._check("wT", wT, torch.float32, (n, B), dev)
        self._check("done0", done0, torch.float32, (B,), dev)
        _, _, tab = self._dev(dev)
        outs = self._outputs(B, dev)
        if B == 0:  # nothing to launch
            return outs
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            LLR_KERNEL(
                llrT.data_ptr(), wT.data_ptr(), done0.data_ptr(),
                *(o.data_ptr() for o in outs), *self._loop_args(tab, B),
                dev.index, stream,
            )
        return outs
