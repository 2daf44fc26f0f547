"""Batched GF(2) systematic encoding as one matrix product.

Counterpart of ``ldpc_tpu/ops/encode.py:19-79``. ``parity = (u @ P) mod 2``
is exact in float32 while the integer sums stay below 2^24. The operands are
kept in float32 on purpose: a bf16 product returns bf16, which rounds
integer sums above 256, and a WiMAX parity sum reaches k = 576. TF32 (when a
caller enables it) rounds only the operands, and 0/1 are exact in TF32, so
the f32 accumulation keeps the product exact either way. This product was
never a Pallas kernel, so it stays a library matmul.
"""

from __future__ import annotations

import numpy as np
import torch

from ldpc_tpu_torch.utils.device import resolve_device


def generator_T(spec, graph: str = "orig") -> np.ndarray:
    """f32 [n, k]: column j of the full generator, ``w[j] = sum u * G[j]``.

    The domain gather of the systematic word is folded into the generator,
    so the whole encode is one product (``encode.py:47-58``)."""
    k, n_minus_k = spec.P.shape
    n = k + n_minus_k
    dm = np.asarray(spec.domain_map(graph))
    Gfull = np.zeros((k, n), dtype=np.float32)
    info_cols = dm < k
    Gfull[dm[info_cols], np.nonzero(info_cols)[0]] = 1.0
    Gfull[:, ~info_cols] = spec.P[:, dm[~info_cols] - k]
    return np.ascontiguousarray(Gfull.T)


def make_encoder(spec, graph: str = "orig",
                 device: str | torch.device | None = None):
    """Build ``encode(u: [B, k]) -> f32 [B, n]``: codewords on the major
    axis, the layout of the unfused path (``encode.py:19-36``)."""
    G = torch.from_numpy(np.ascontiguousarray(generator_T(spec, graph).T)) \
        .to(resolve_device(device))

    def encode(u: torch.Tensor) -> torch.Tensor:
        return torch.remainder(u.to(torch.float32) @ G, 2.0)

    return encode


def make_encoder_T(spec, graph: str = "orig",
                   device: str | torch.device | None = None):
    """Build ``encode_T(u: [B, k]) -> f32 [n, B]``: codewords on the minor
    axis, the layout the fused kernels consume."""
    GT = torch.from_numpy(generator_T(spec, graph)).to(resolve_device(device))

    def encode_T(u: torch.Tensor) -> torch.Tensor:
        uT = u.to(torch.float32).T  # [k, B]
        return torch.remainder(GT @ uT, 2.0)

    return encode_T


def random_info_bits(generator: torch.Generator, batch: int, k: int) -> torch.Tensor:
    """Uniform random info bits [batch, k] as uint8 on the generator's device."""
    return torch.randint(0, 2, (batch, k), generator=generator,
                         device=generator.device, dtype=torch.uint8)
