"""BER / FER / convergence accounting with the reference's conventions.

Counterpart of ``ldpc_tpu/ops/metrics.py:24-141``:
  * FER counts frames whose decode result != OK.
  * BER counts erroneous info bits only for failed frames unless ``exact``
    (:func:`block_stats` on the unfused path; the runner applies the same
    rule to the fused kernels' every-frame counts).
  * average convergence iterations average over converged frames only.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class BlockCounters(NamedTuple):
    """Summable per-batch counters (int32 / float32 scalar tensors)."""

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


def block_stats(u: torch.Tensor, result, info_pos: torch.Tensor,
                exact: bool = False) -> BlockStats:
    """Per-codeword stats of one decoded batch: ``u`` uint8 [B, k] the sent
    info bits, ``result`` a DecodeResult, ``info_pos`` int64 [k] their
    codeword positions."""
    decoded = result.est.index_select(1, info_pos)
    errs = (decoded != u.to(decoded.dtype)).sum(dim=1).to(torch.int32)
    if not exact:
        # reference: bits counted only when decode failed (main.py:134)
        errs = torch.where(result.ok, torch.zeros_like(errs), errs)
    return BlockStats(error_bits=errs, ok=result.ok,
                      conv_iter=result.conv_iter, norm_llr=result.norm_llr)


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
    """BlockCounters + iteration count -> one int32[8] device tensor
    (the f32 norm sum is carried as its bit pattern), so a batch's result
    is one transfer."""
    ints = torch.stack([
        c.blocks, c.ok_blocks, c.error_bits, c.fer_frames,
        c.conv_iters_sum, c.conv_count, iters.to(torch.int32),
    ]).to(torch.int32)
    f = c.norm_llr_sum.to(torch.float32).reshape(1).view(torch.int32)
    return torch.cat([ints, f])


def unpack_counters(vec) -> tuple[BlockCounters, int]:
    """Host-side inverse of :func:`pack_counters` (numpy scalars)."""
    if isinstance(vec, torch.Tensor):
        vec = vec.cpu().numpy()
    v = np.asarray(vec)
    norm = v[7:8].view(np.float32)[0]
    return (
        BlockCounters(
            blocks=v[0], ok_blocks=v[1], error_bits=v[2], fer_frames=v[3],
            norm_llr_sum=norm, conv_iters_sum=v[4], conv_count=v[5],
        ),
        int(v[6]),
    )
