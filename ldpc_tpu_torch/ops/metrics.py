"""BER / FER / convergence accounting with the reference's conventions.

Counterpart of ``ldpc_tpu/ops/metrics.py:24-141``:
  * FER counts frames whose decode result != OK.
  * BER counts erroneous info bits only for failed frames unless ``exact``
    (:func:`failed_frame_errors`, which :func:`block_stats` and the fused
    path's step both apply).
  * average convergence iterations average over converged frames only.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# the slots of a batch's packed counters (the JAX package's order): int32
# counts, the decode's iterations, then the f32 norm sum as its bit pattern
SLOTS = ("blocks", "ok_blocks", "error_bits", "fer_frames", "conv_iters_sum",
         "conv_count", "iters", "norm_llr_sum")
_NORM = SLOTS.index("norm_llr_sum")


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


def add_packed(total: torch.Tensor, packed: torch.Tensor) -> None:
    """Add packed counters (``[..., 8]``, :func:`pack_counters`) into
    ``total``, float64 ``[..., >= 8]`` in the same slots with the norm sum
    as its value: exact, as float64 holds every count and f32 value."""
    total[..., :_NORM] += packed[..., :_NORM].to(torch.float64)
    total[..., _NORM] += packed[..., _NORM:_NORM + 1].view(
        torch.float32)[..., 0].to(torch.float64)


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
