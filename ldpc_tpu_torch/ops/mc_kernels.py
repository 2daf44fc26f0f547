"""Fused Monte-Carlo kernels (CUDA) and their plain PyTorch versions.

Replaces the two Pallas kernels of the JAX package's main path:

* ``ldpc_tpu/ops/mc_pallas.py:142`` ``make_mc_decoder`` (kernel body
  ``:295-376``, ``pallas_call`` ``:378``) by :class:`MCDecoder`: modulation,
  noise, channel LLRs, the QC decode loop and the info-bit error counts in one
  kernel, optionally emitting the channel LLRs for phase 2;
* ``ldpc_tpu/ops/mc_pallas.py:494`` ``make_llr_decoder`` (kernel body
  ``:561-601``, ``pallas_call`` ``:603``) by :class:`LLRDecoder`: the same
  decode and counts from given LLRs with a per-lane pre-done mask.

The kernels live in ``csrc/mc_decoder.cu`` and ``csrc/llr_decoder.cu`` and
share one ``__device__`` decode loop (``decode_group`` in
``csrc/decode_group.cuh``), the counterpart of
``spa_pallas.make_decode_loop``, with the standalone QC decoder K3
(``qc_kernels.py``): the layered or the flooding schedule, a scalar or
scheduled alpha, f32 or int8 extrinsics, with or without the flip metric
(:class:`DecodeConfig`). What bounds them on the card: instruction issue on a
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
memory for the whole decode; a flooding decode restarts every sweep from the
channel LLRs, which K1 and K2 write once into an internal [B, n] row in device
memory.

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
    check_msg_store,
    normalize_variant,
    resolve_alpha_schedule,
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
               device, b0: int = 0) -> torch.Tensor:
    """The Philox source's words in the injected layout, int64 [draws, n, B].

    Column pair p (base columns 2p, 2p+1), row z and lane b draw
    ``philox(counter=(b0 + b, p*Z + z, call, 0), key)``: lanes
    ``[b0, b0 + B)`` of a batch, so a shard of a batch draws what the whole
    batch draws there. Call 0 gives planes
    0-2 of column 2p (and, in mode 2, the jam word of column 2p); call 1
    (modes 2/3) planes 3-5 of column 2p and the jam word of column 2p+1.
    The kernel draws the same words in place."""
    nb = n // Z
    P = (nb + 1) // 2
    k0, k1 = int(key[0]) & _M32, int(key[1]) & _M32
    b = (torch.arange(B, dtype=torch.int64, device=device).view(1, 1, B)
         + int(b0)) & _M32
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
# csrc/decode_group.cuh make_loop): :func:`loop_args`
LOOP_ARGS = [_P,  # tables
             _I, _I, _I, _I, _I, _I, _I, _I,  # n Z nb mb e_slots ngroups R B
             _I, _I, _I, _F, _F,  # max_it check_every variant alpha beta
             _P, _P, _I, _I,  # the alpha schedule: atab acls aT aD
             _I, _I,  # track_norm k
             _I, _I,  # flood int8
             _I, _I,  # dmax has_dup
             _I, _I, _I, _I]  # the FusedPlan: cpg tpg Ls smem

MC_KERNEL = Kernel(
    "mc_decoder", "mc_decoder_launch",
    [_P, _P, _P,  # w, raw, consts
     _P, _P, _P, _P, _P, _P,  # err ok conv norm iters llr_out
     _P, _P]  # xbuf prior
    + LOOP_ARGS
    + [_I, _F, _I, _U, _U, _U, _I,  # mode amp noise_input key0 key1 b0 skip
       _I, _P],  # device stream
)
LLR_KERNEL = Kernel(
    "llr_decoder", "llr_decoder_launch",
    [_P, _P, _P,  # llr, w, done0
     _P, _P, _P, _P, _P,  # err ok conv norm iters
     _P, _P]  # xbuf prior
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
    """int32 table the kernels read, in ``csrc/decode_group.cuh``'s order: row
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


MAX_THREADS = 768  # csrc/decode_group.cuh: the decode kernels' launch bound


@dataclass(frozen=True)
class FusedPlan:
    """The block of the decode kernels (K1, K2, K3). The wrappers pass it to
    the kernels' entry points, which only validate it (``bad_plan`` in
    ``csrc/decode_group.cuh``: a shared memory size that differs from the
    layout's is refused).

    A block is one barrier group of ``lanes`` codewords and ``threads``
    threads (a multiple of 32): one codeword's ``rows x Z`` threads padded
    to whole warps, or, where ``rows x Z < 32``, up to ``32 // (rows x Z)``
    codewords (a power of two, at most 8) sharing one warp. ``rows`` is the
    layer group's rows (layered) or 2 check rows per step (flooding, where
    the code has them). ``l_stride`` is a codeword's L row in shared memory
    (n, padded where lanes > 1 so that the lanes of a lane-fastest warp
    start in different banks); ``int8``: E stored as int8; ``smem`` the
    block's dynamic shared memory."""

    lanes: int
    rows: int
    row_threads: int  # rows x Z: the threads of one codeword's step
    threads: int
    l_stride: int
    flood: bool
    smem: int
    int8: bool = False

    @property
    def padding_threads(self) -> int:
        """Threads of the block that hold no (row, z) of a codeword."""
        return self.threads - self.lanes * self.row_threads

    def store_args(self) -> list:
        """The schedule and store as the entry points take them: flood,
        int8."""
        return [int(self.flood), int(self.int8)]

    def launch_args(self) -> list:
        """The plan as the entry points take it: cpg, tpg, Ls, smem."""
        return [self.lanes, self.threads, self.l_stride, self.smem]


def fused_smem_bytes(tables: QCTables, lanes: int, l_stride: int,
                     flood: bool = False, int8: bool = False) -> int:
    """Dynamic shared memory of a block: L [lanes][l_stride], E [lanes][e_slots
    * Z] (f32, or int8 and then padded to 16 bytes), the multi-diagonal
    deltas [lanes][R * DMAX * Z] (layered only), the schedule tables with the
    gather offsets."""
    qc = tables.qc
    e = lanes * tables.e_slots * qc.Z
    head = 4 * lanes * l_stride + (e if int8 else 4 * e)
    if int8:
        head = -(-head // 16) * 16
    if tables.has_dup and not flood:
        head += 4 * lanes * tables.R * kernel_dmax(tables) * qc.Z
    return head + 4 * (table_len(tables, flood) + gather_words(tables))


def block_layout(tables: QCTables, flood: bool = False,
                 int8: bool = False) -> FusedPlan:
    """The decode kernels' block (:func:`fused_plan`) before its limits are
    checked: one barrier group, one codeword where a step fills a warp
    (``rows x Z >= 32``: 96 threads at the bench code), else the codewords
    that share one warp. A block then holds its SM only while its codewords
    decode, so a converged codeword frees its place for the next block at
    once (``PERF.md``: the block-plan ladder). A layered step runs its layer
    group's rows; a flooding step 2 check rows where the code has them
    (``mb >= 2`` and ``2 x Z`` within the launch bound). ``int8`` sets the E
    store (:class:`FusedPlan`)."""
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
    return FusedPlan(lanes=lanes, rows=R, row_threads=RZ, threads=threads,
                     l_stride=stride, flood=bool(flood),
                     smem=fused_smem_bytes(tables, lanes, stride, flood, int8),
                     int8=bool(int8))


def plan_fits(plan: FusedPlan) -> bool:
    """Whether a block is within the launch bound and the shared memory a
    block may use."""
    return plan.threads <= MAX_THREADS and plan.smem <= _SMEM_LIMIT


def fused_plan(tables: QCTables, flood: bool = False,
               int8: bool = False) -> FusedPlan:
    """The decode kernels' block (:func:`block_layout`). Raises, with the
    bytes, when the block exceeds the launch bound or the shared memory of
    a block."""
    plan = block_layout(tables, flood, int8)
    if not plan_fits(plan):
        qc = tables.qc
        raise ValueError(
            f"code n={qc.n}, Z={qc.Z} does not fit one block of the "
            f"{'flooding' if flood else 'layered'} decode kernels: "
            f"{plan.lanes} codeword(s) need {plan.threads} threads (at most "
            f"{MAX_THREADS}) and {plan.smem} bytes of shared memory (at most "
            f"{_SMEM_LIMIT})")
    return plan


def loop_args(tables: QCTables, plan: FusedPlan, tab: torch.Tensor, B: int,
              max_iterations: int, check_every: int, variant: str,
              alpha: float, beta: float, *, sched=None,
              track_norm: bool = False, k: int = 0) -> list:
    """The decode-loop arguments of an entry point (:data:`LOOP_ARGS`).
    ``sched``: an alpha schedule's device tables ``(f32 [T * D], int32
    [mb] row classes, T, D)``, or None for the scalar ``alpha``; ``k``: the
    info positions the flip metric divides by (``track_norm``)."""
    qc = tables.qc
    ngroups = 0 if plan.flood else len(tables.groups)
    has_dup = 0 if plan.flood else int(tables.has_dup)
    atab, acls, T, D = sched if sched is not None else (None, None, 0, 0)
    return [tab.data_ptr(), qc.n, qc.Z, qc.nb, qc.mb, tables.e_slots,
            ngroups, plan.rows, B, max_iterations, check_every,
            _VARIANT_CODE[variant], alpha, beta,
            None if atab is None else atab.data_ptr(),
            None if acls is None else acls.data_ptr(), T, D,
            int(track_norm), int(k), *plan.store_args(),
            kernel_dmax(tables), has_dup, *plan.launch_args()]


# kernel kinds: the library of each decode kernel
K_MC, K_LLR, K_QC = 0, 1, 2
LIBRARY = {K_MC: "mc_decoder", K_LLR: "llr_decoder", K_QC: "qc_decoder"}


def blocks_per_sm(kind: int, tables: QCTables, plan: FusedPlan, device,
                  norm: bool = False) -> int:
    """Resident blocks per SM of K1 (``kind`` :data:`K_MC`), K2
    (:data:`K_LLR`) or K3 (:data:`K_QC`) at ``plan``'s launch shape and
    stores on the card (``norm``: the flip metric compiled in;
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    from ldpc_tpu_torch.ops.build import load

    fn = load(LIBRARY[kind]).decoder_occupancy
    fn.argtypes = [_I, _I, _I, _I, _I, _I, ctypes.POINTER(_I)]
    fn.restype = _I
    blocks = _I(0)
    with torch.cuda.device(device):
        rc = fn(kernel_dmax(tables), int(plan.flood), int(norm),
                int(plan.int8), plan.threads, plan.smem, ctypes.byref(blocks))
    if rc:
        raise RuntimeError(f"decoder_occupancy failed (cudaError {rc})")
    return blocks.value


class DecodeConfig:
    """What the three decode kernels share: the schedule, its tables and
    plan, the alpha schedule, the E store and the flip metric, with the JAX
    kernels' refusals (``spa_pallas.make_decode_loop``), and each device's
    plain decode loop and kernel tables."""

    kind = K_QC

    def __init__(self, qc: QCLayout, info_pos, max_iterations: int,
                 variant: str, *, alpha, beta: float, schedule: str,
                 layer_groups, check_every: int, track_norm: bool,
                 msg_store: str):
        if schedule not in ("flooding", "layered"):
            raise ValueError(f"Unknown schedule: {schedule!r}")
        if layer_groups is not None and schedule != "layered":
            raise ValueError("layer_groups requires schedule='layered'")
        self.qc = qc
        self.variant = normalize_variant(variant)
        self.schedule = schedule
        self.flood = schedule == "flooding"
        self.tables = build_tables(qc, layer_groups)
        self.max_iterations = int(max_iterations)
        self.check_every = int(check_every)
        if self.check_every < 1 or self.max_iterations % self.check_every:
            raise ValueError(
                f"check_every={check_every} must divide "
                f"max_iterations={max_iterations}"
            )
        if track_norm and self.check_every > 1:
            raise ValueError(
                "check_every > 1 requires track_norm=False: the "
                "normalized-LLR flip metric is defined per iteration")
        check_msg_store(msg_store, self.variant)
        arr, cls = resolve_alpha_schedule(alpha, self.variant,
                                          self.tables.degrees)
        self.alpha = alpha if arr is None else arr
        self._sched = None if arr is None else (
            np.asarray(arr, np.float32).reshape(arr.shape[0], -1),
            np.zeros(qc.mb, np.int32) if cls is None
            else np.asarray(cls, np.int32))
        self.beta = float(beta)
        self.track_norm = bool(track_norm)
        self.msg_store = msg_store
        self.info_pos = np.asarray(info_pos, np.int64)
        self.plan = fused_plan(self.tables, self.flood, msg_store == "int8")
        self.lanes = self.plan.lanes
        self._per_device: dict = {}

    def blocks_per_sm(self, device) -> int:
        """Resident blocks per SM of this decoder's kernel at its launch
        shape (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
        return blocks_per_sm(self.kind, self.tables, self.plan, device,
                             norm=self.track_norm)

    def _dev(self, device: torch.device):
        """(plain decode loop, info index, kernel tables, alpha schedule's
        device tables or None) for one device."""
        device = torch.device(device)
        key = str(device)
        if key not in self._per_device:
            loop = DecodeLoop(self.tables, self.max_iterations, self.variant,
                              alpha=self.alpha, beta=self.beta,
                              check_every=self.check_every, lanes=self.lanes,
                              device=device, schedule=self.schedule,
                              track_norm=self.track_norm,
                              info_pos=self.info_pos, msg_store=self.msg_store)
            sched = None
            if self._sched is not None:
                vals, cls = self._sched
                sched = (torch.as_tensor(vals.ravel(), device=device),
                         torch.as_tensor(cls, device=device), *vals.shape)
            self._per_device[key] = (
                loop,
                torch.as_tensor(self.info_pos, device=device),
                torch.as_tensor(kernel_table(self.tables, self.info_pos,
                                             self.flood), device=device),
                sched,
            )
        return self._per_device[key]

    def _loop_args(self, device, B: int) -> list:
        _, _, tab, sched = self._dev(device)
        alpha = 1.0 if self._sched is not None else float(self.alpha)
        return loop_args(self.tables, self.plan, tab, B,
                         self.max_iterations, self.check_every, self.variant,
                         alpha, self.beta, sched=sched,
                         track_norm=self.track_norm, k=self.info_pos.size)

    def _buffers(self, B: int, device):
        """The kernel's internal [B, n] rows: the channel LLRs of a flooding
        decode (K1 / K2; K3 reads its input), and the flip metric's previous
        posteriors."""
        n = self.qc.n
        xbuf = (torch.empty((B, n), dtype=torch.float32, device=device)
                if self.kind != K_QC and self.flood else None)
        prior = (torch.empty((B, n), dtype=torch.float32, device=device)
                 if self.track_norm else None)
        return xbuf, prior


class _FusedBase(DecodeConfig):
    """What both fused decoders share beyond :class:`DecodeConfig`: the
    error count and the argument checks."""

    def _count_errors(self, L: torch.Tensor, wT: torch.Tensor) -> torch.Tensor:
        _, info, _, _ = self._dev(L.device)
        est = L.index_select(0, info) < 0
        x = wT.index_select(0, info) != 0
        return (est != x).sum(dim=0).to(torch.int32)

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

    @staticmethod
    def _ptr(x):
        return None if x is None else x.data_ptr()


class MCDecoder(_FusedBase):
    """``mc_step(wT, consts, seeds=None, raw=None, skip=0, b0=0)``.

    ``wT``: f32 [n, B] transmitted code bits (0/1), codewords on the minor
    axis. ``consts``: f32 [8] from ``ChannelParams.consts``. Noise comes from
    ``raw`` (uint32 or int32 [draws, n, B] words in the injected layout)
    when given, else from Philox keyed by ``seeds`` (two 32-bit ints), with
    ``b0`` added to each lane's codeword counter (a shard ``[b0, b0 + B)``
    of a batch draws the whole batch's noise there). ``skip`` nonzero
    pre-marks every lane done.

    Returns ``(err, ok, conv, norm, iters)``: int32 / bool / int32 / f32 /
    int32 [B]; ``err`` counts info-bit mismatches in every frame (callers
    apply the failed-frames rule); ``conv`` is the check iteration of
    convergence or -1; ``norm`` is the normalized-LLR flip metric with
    ``track_norm``, else zeros; ``iters`` is the trip count of the lane's
    block (the largest of its codewords', its own at one codeword per
    block). ``emit_llr`` appends the channel LLRs, f32 [n, B] in the
    log(p0/p1) domain. Layered or flooding, scalar or scheduled alpha, f32
    or int8 E, as :class:`DecodeConfig` takes them.
    """

    kind = K_MC

    def __init__(self, qc: QCLayout, info_pos, max_iterations: int,
                 variant: str = "spa", *, mode: int = 1, modulation: int = 1,
                 alpha=0.75, beta: float = 0.15,
                 schedule: str = "layered", emit_llr: bool = False,
                 layer_groups=None, check_every: int = 1,
                 track_norm: bool = False, msg_store: str = "f32"):
        if mode not in DRAWS_PER_BIT:
            raise ValueError(f"Unknown channel mode: {mode}")
        if modulation not in (1, 2):
            raise ValueError("MC kernel supports modulation 1 (BPSK) / 2 (QPSK proxy)")
        super().__init__(qc, info_pos, max_iterations, variant, alpha=alpha,
                         beta=beta, schedule=schedule,
                         layer_groups=layer_groups, check_every=check_every,
                         track_norm=track_norm, msg_store=msg_store)
        self.mode, self.modulation = mode, modulation
        self.amp = 1.0 if modulation == 1 else 0.7
        self.emit_llr = emit_llr

    def __call__(self, wT, consts, seeds=None, raw=None, skip=0, b0=0):
        if wT.device.type == "cpu":
            return self.plain(wT, consts, seeds=seeds, raw=raw, skip=skip,
                              b0=b0)
        if wT.device.type != "cuda":
            raise ValueError(f"no kernel for device {wT.device}")
        return self._launch(wT, consts, seeds, raw, skip, b0)

    def plain(self, wT, consts, seeds=None, raw=None, skip=0, b0=0):
        """The kernel's arithmetic in PyTorch, on any device."""
        n, B = wT.shape
        dev = wT.device
        loop = self._dev(dev)[0]
        if raw is None:
            if seeds is None:
                raise ValueError("pass raw words or Philox seeds")
            raw = philox_raw(seeds, n, self.qc.Z, B, self.mode, dev, b0)
        L = -channel_llr_reference(wT, raw, consts, self.mode,
                                   self.modulation, self.qc.Z)
        llr = L.clone() if self.emit_llr else None
        done0 = torch.full((B,), bool(skip), dtype=torch.bool, device=dev)
        done, conv, iters, norm = loop.decode(L, done0)
        out = (self._count_errors(L, wT), done, conv, norm, iters)
        return out + (llr,) if self.emit_llr else out

    def _launch(self, wT, consts, seeds, raw, skip, b0):
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
        outs = self._outputs(B, dev)
        llr = (torch.empty((n, B), dtype=torch.float32, device=dev)
               if self.emit_llr else None)
        if B == 0:  # nothing to launch
            return outs + (llr,) if self.emit_llr else outs
        args = self._loop_args(dev, B)
        xbuf, prior = self._buffers(B, dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            MC_KERNEL(
                wT.data_ptr(), self._ptr(raw), consts.data_ptr(),
                *(o.data_ptr() for o in outs), self._ptr(llr),
                self._ptr(xbuf), self._ptr(prior), *args,
                self.mode, self.amp, int(raw is not None), key[0], key[1],
                int(b0) & _M32, int(bool(skip)), dev.index, stream,
            )
        return outs + (llr,) if self.emit_llr else outs


class LLRDecoder(_FusedBase):
    """``llr_step(llrT, wT, done0) -> (err, ok, conv, norm, iters)``.

    Phase 2 of two-phase dispatch: ``llrT`` f32 [n, B] channel LLRs in the
    log(p0/p1) domain (as :class:`MCDecoder` emits them), ``wT`` f32 [n, B]
    transmitted bits in the same lane order, ``done0`` f32 [B] with 1.0
    pre-marking a lane done: its LLRs are not read and its outputs are
    placeholders (ok, conv -1, no errors, norm 0). Outputs as for
    :class:`MCDecoder`; a block whose codewords are all pre-done only writes
    its placeholders.
    """

    kind = K_LLR

    def __init__(self, qc: QCLayout, info_pos, max_iterations: int,
                 variant: str = "spa", *, alpha=0.75,
                 beta: float = 0.15, schedule: str = "layered",
                 layer_groups=None, check_every: int = 1,
                 track_norm: bool = False, msg_store: str = "f32"):
        super().__init__(qc, info_pos, max_iterations, variant, alpha=alpha,
                         beta=beta, schedule=schedule,
                         layer_groups=layer_groups, check_every=check_every,
                         track_norm=track_norm, msg_store=msg_store)

    def __call__(self, llrT, wT, done0):
        if llrT.device.type == "cpu":
            return self.plain(llrT, wT, done0)
        if llrT.device.type != "cuda":
            raise ValueError(f"no kernel for device {llrT.device}")
        return self._launch(llrT, wT, done0)

    def plain(self, llrT, wT, done0):
        """The kernel's arithmetic in PyTorch, on any device."""
        loop = self._dev(llrT.device)[0]
        L = llrT.to(torch.float32).clone()
        pre = done0 > 0.5
        done, conv, iters, norm = loop.decode(L, pre)
        err = torch.where(pre, 0, self._count_errors(L, wT)).to(torch.int32)
        return err, done, conv, norm, iters

    def _launch(self, llrT, wT, done0):
        dev = llrT.device
        n, B = self.qc.n, llrT.shape[1]
        self._check("llrT", llrT, torch.float32, (n, B), dev)
        self._check("wT", wT, torch.float32, (n, B), dev)
        self._check("done0", done0, torch.float32, (B,), dev)
        outs = self._outputs(B, dev)
        if B == 0:  # nothing to launch
            return outs
        args = self._loop_args(dev, B)
        xbuf, prior = self._buffers(B, dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            LLR_KERNEL(
                llrT.data_ptr(), wT.data_ptr(), done0.data_ptr(),
                *(o.data_ptr() for o in outs), self._ptr(xbuf),
                self._ptr(prior), *args, dev.index, stream,
            )
        return outs
