"""BER / FER / convergence accounting with the reference's conventions.

Counterpart of ``ldpc_tpu/ops/metrics.py:24-141``:
  * FER counts frames whose decode result != OK.
  * BER counts erroneous info bits only for failed frames unless ``exact``
    (:func:`failed_frame_errors`, which :func:`block_stats` and the fused
    path's step both apply).
  * average convergence iterations average over converged frames only.

A batch's counters: :func:`batch_counters` reduces one rank's per-frame
stats to ``int32[8]`` in the :data:`SLOTS` layout and :func:`add_packed`
adds them into a run's float64 totals. On the card each is one launch of K7
(``csrc/batch_counters.cu``: ``BATCH_COUNTERS`` and ``ADD_COUNTERS`` count
them), in place of the few dozen operators of :func:`reduce_block_stats`,
:func:`pack_counters` and the add; on the CPU they are those operators. The
integer slots are equal on both; K7 sums the flip metric in float64 in a
fixed order and rounds it to f32 once, so its norm slot differs from the f32
``sum`` of the plain version only by rounding, and is the same from launch
to launch. A CUDA tensor launches the kernel or raises: there is no
fallback.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ldpc_tpu_torch.ops.build import Kernel, check_arg

# the slots of a batch's packed counters (the JAX package's order): int32
# counts, the decode's iterations, then the f32 norm sum as its bit pattern
SLOTS = ("blocks", "ok_blocks", "error_bits", "fer_frames", "conv_iters_sum",
         "conv_count", "iters", "norm_llr_sum")
_NORM = SLOTS.index("norm_llr_sum")

_P, _I = ctypes.c_void_p, ctypes.c_int
BATCH_COUNTERS = Kernel(
    "batch_counters", "batch_counters_launch",
    [_P, _P, _P, _P, _P, _P,  # err, ok, conv, norm, iters, out
     _I, _I, _I, _I, _P],  # frames, valid frames, iters' length, device, stream
)
ADD_COUNTERS = Kernel(
    "batch_counters", "add_counters_launch",
    [_P, _P, _I, _I, _I, _P],  # totals, packed, rows, row width, device, stream
)
# the dtypes of BlockStats' fields, as K7 reads them
_STAT_DTYPES = (torch.int32, torch.bool, torch.int32, torch.float32)


class BlockCounters(NamedTuple):
    """Summable per-batch counters (int32 / float32 scalar tensors; numpy
    scalars from :func:`unpack_counters`)."""

    blocks: torch.Tensor
    ok_blocks: torch.Tensor
    error_bits: torch.Tensor
    fer_frames: torch.Tensor
    norm_llr_sum: torch.Tensor
    conv_iters_sum: torch.Tensor
    conv_count: torch.Tensor

    def __add__(self, other: "BlockCounters") -> "BlockCounters":
        return BlockCounters(*(a + b for a, b in zip(self, other)))


class BlockStats(NamedTuple):
    """Per-codeword metric tensors (all [B])."""

    error_bits: torch.Tensor  # int32
    ok: torch.Tensor  # bool
    conv_iter: torch.Tensor  # int32
    norm_llr: torch.Tensor  # f32


def failed_frame_errors(errors: torch.Tensor, ok: torch.Tensor,
                        exact: bool) -> torch.Tensor:
    """Per-frame bit errors as the BER counts them: the reference counts a
    frame's errors only when its decode failed (main.py:134), ``exact``
    every frame's."""
    return errors if exact else torch.where(ok, 0, errors)


def block_stats(u: torch.Tensor, result, info_pos: torch.Tensor,
                exact: bool = False) -> BlockStats:
    """Per-codeword stats of one decoded batch: ``u`` uint8 [B, k] the sent
    info bits, ``result`` a DecodeResult, ``info_pos`` int64 [k] their
    codeword positions."""
    decoded = result.est.index_select(1, info_pos)
    errs = (decoded != u.to(decoded.dtype)).sum(dim=1).to(torch.int32)
    return BlockStats(error_bits=failed_frame_errors(errs, result.ok, exact),
                      ok=result.ok, conv_iter=result.conv_iter,
                      norm_llr=result.norm_llr)


def reduce_block_stats(stats: BlockStats, valid: torch.Tensor) -> BlockCounters:
    """Masked reduction of BlockStats -> BlockCounters."""

    def msum(x):
        return torch.where(valid, x, torch.zeros_like(x)).sum()

    converged = stats.conv_iter >= 0
    i32 = torch.int32
    return BlockCounters(
        blocks=valid.sum().to(i32),
        ok_blocks=msum(stats.ok.to(i32)).to(i32),
        error_bits=msum(stats.error_bits).to(i32),
        fer_frames=msum((~stats.ok).to(i32)).to(i32),
        norm_llr_sum=msum(stats.norm_llr).to(torch.float32),
        conv_iters_sum=msum(
            torch.where(converged, stats.conv_iter, torch.zeros_like(stats.conv_iter))
        ).to(i32),
        conv_count=msum(converged.to(i32)).to(i32),
    )


def count_block_metrics(u: torch.Tensor, result, info_pos: torch.Tensor,
                        exact: bool = False,
                        valid: torch.Tensor | None = None) -> BlockCounters:
    """One-shot convenience (studies, tests): :func:`block_stats` and
    :func:`reduce_block_stats` together (``metrics.py:130-141``)."""
    if valid is None:
        valid = torch.ones(u.shape[0], dtype=torch.bool, device=u.device)
    return reduce_block_stats(block_stats(u, result, info_pos, exact), valid)


def pack_counters(c: BlockCounters, iters: torch.Tensor) -> torch.Tensor:
    """BlockCounters + iteration count -> one int32[8] device tensor in the
    :data:`SLOTS` layout, so a batch's result is one transfer."""
    named = dict(c._asdict(), iters=iters.to(torch.int32))
    ints = torch.stack([named[f] for f in SLOTS[:_NORM]]).to(torch.int32)
    f = c.norm_llr_sum.to(torch.float32).reshape(1).view(torch.int32)
    return torch.cat([ints, f])


def batch_counters(stats: BlockStats, iters: torch.Tensor, lo: int,
                   take: int) -> torch.Tensor:
    """int32[8] counters (:data:`SLOTS`) of one rank's rows of a batch:
    ``stats`` [B] of rows ``lo .. lo + B - 1``, of which those below
    ``take`` count; ``iters`` the decode's trips, [B] or one value, whose
    largest is the ``iters`` slot over every row. K7 on the card
    (:func:`launch_batch_counters`), :func:`plain_batch_counters` on the
    CPU."""
    if stats.ok.device.type == "cpu":
        return plain_batch_counters(stats, iters, lo, take)
    return launch_batch_counters(stats, iters, lo, take)


def plain_batch_counters(stats: BlockStats, iters: torch.Tensor, lo: int,
                         take: int) -> torch.Tensor:
    """:func:`batch_counters` in PyTorch, on any device."""
    valid = torch.arange(lo, lo + stats.ok.shape[0],
                         device=stats.ok.device) < take
    return pack_counters(reduce_block_stats(stats, valid), iters.max())


def launch_batch_counters(stats: BlockStats, iters: torch.Tensor, lo: int,
                          take: int) -> torch.Tensor:
    """K7's reduction of :func:`batch_counters`: one launch. Raises, before
    any launch, on a tensor the kernel would read out of bounds or misread:
    the stats int32 / bool / int32 / f32 [B] with B >= 1, ``iters`` int32
    [B], [1] or [], each contiguous and on the device of ``stats.ok``."""
    dev = stats.ok.device
    B = stats.ok.shape[0] if stats.ok.dim() == 1 else 0
    if B < 1:
        raise ValueError(f"ok has shape {tuple(stats.ok.shape)}, expected "
                         "one frame or more")
    rows = ((B,),)
    for x, name, dtype in zip(stats, BlockStats._fields, _STAT_DTYPES):
        check_arg(x, name, dtype, rows, dev)
    check_arg(iters, "iters", torch.int32, ((B,), (1,), ()), dev)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    out = torch.empty(len(SLOTS), dtype=torch.int32, device=dev)
    BATCH_COUNTERS(*(x.data_ptr() for x in stats), iters.data_ptr(),
                   out.data_ptr(), B, min(max(take - lo, 0), B),
                   iters.numel(), dev.index,
                   torch.cuda.current_stream(dev).cuda_stream)
    return out


def add_packed(total: torch.Tensor, packed: torch.Tensor) -> None:
    """Add packed counters (``[..., 8]``, :func:`pack_counters`) into
    ``total``, float64 ``[..., >= 8]`` in the same slots with the norm sum
    as its value: exact, as float64 holds every count and f32 value. K7's
    add on the card (:func:`launch_add_packed`), :func:`plain_add_packed`
    on the CPU."""
    if packed.device.type == "cpu":
        plain_add_packed(total, packed)
    else:
        launch_add_packed(total, packed)


def plain_add_packed(total: torch.Tensor, packed: torch.Tensor) -> None:
    """:func:`add_packed` in PyTorch, on any device."""
    total[..., :_NORM] += packed[..., :_NORM].to(torch.float64)
    total[..., _NORM] += packed[..., _NORM:_NORM + 1].view(
        torch.float32)[..., 0].to(torch.float64)


def launch_add_packed(total: torch.Tensor, packed: torch.Tensor) -> None:
    """K7's add of :func:`add_packed`: one launch. Raises, before any
    launch, unless ``packed`` is int32 ``[..., 8]`` and ``total`` float64
    with the same leading shape and rows of 8 or more, both contiguous and
    on one device."""
    dev, lead = packed.device, tuple(packed.shape[:-1])
    check_arg(packed, "packed", torch.int32, ((*lead, len(SLOTS)),), dev)
    width = total.shape[-1] if total.dim() == packed.dim() else 0
    check_arg(total, "total", torch.float64,
              ((*lead, max(width, len(SLOTS))),), dev)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    rows = packed.numel() // len(SLOTS)
    if rows:
        ADD_COUNTERS(total.data_ptr(), packed.data_ptr(), rows, width,
                     dev.index, torch.cuda.current_stream(dev).cuda_stream)


def unpack_counters(vec) -> tuple[BlockCounters, int]:
    """Host-side inverse of :func:`pack_counters` (numpy scalars), also of
    a float64 total (:func:`add_packed`; slots past the layout's ignored)."""
    if isinstance(vec, torch.Tensor):
        vec = vec.cpu().numpy()
    v = np.asarray(vec)
    named = dict(zip(SLOTS, v))
    if v.dtype == np.int32:  # the norm sum as its f32 bit pattern
        named["norm_llr_sum"] = v[_NORM:_NORM + 1].view(np.float32)[0]
    iters = int(named.pop("iters"))
    return BlockCounters(**named), iters
