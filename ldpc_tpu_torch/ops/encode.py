"""Batched GF(2) systematic encoding: K8 on the card, the product on the CPU.

Counterpart of ``ldpc_tpu/ops/encode.py:19-79``, which encodes with one dense
matrix product, ``(u @ G) mod 2``. On the CPU the port runs that product
(:meth:`GF2Encoder.plain`): it is exact in float32 while the integer sums
stay below 2^24, and the operands stay float32 on purpose, since a bf16
product rounds sums above 256 and a WiMAX parity sum reaches k = 576. On the
card K8 (``csrc/gf2_encode.cu``; ``ENCODE.launches`` counts it) packs
instead: the generator, with the domain gather of the systematic word folded
in (:func:`generator_T`), becomes a table of ``ceil(k/32)`` uint32 words a
column (:func:`generator_words`), made on the host and copied to the device
once per encoder; a frame's info bits become words of 32 bits; a codeword bit
is the parity of ``popcount(info words & column words)``. GF(2) has one
answer, so both are bit for bit the same in both layouts.

:class:`GF2Encoder` routes by the tensor's device alone: a CUDA tensor
launches K8, a CPU tensor takes the product, and any other device raises.
There is no fallback. An encoder made on the card loads K8's library when it
is made, so no build or load lands inside a batch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ldpc_tpu_torch.ops import build
from ldpc_tpu_torch.ops.build import Kernel, check_arg
from ldpc_tpu_torch.utils.device import resolve_device

_P, _I = ctypes.c_void_p, ctypes.c_int
ENCODE = Kernel(
    "gf2_encode", "gf2_encode_launch",
    [_P, _P, _P,  # u, table, out
     _I, _I, _I, _I, _I,  # frames, k, n, words, table columns
     _I, _I, _P],  # frames minor, device, stream
)
TILE = 128  # K8's tile: the table's columns are padded to a multiple of it


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


def generator_words(GT: np.ndarray) -> np.ndarray:
    """uint32 [ceil(k/32), n rounded up to :data:`TILE`] from the generator
    ``GT`` [n, k] (:func:`generator_T`): bit ``b`` of word ``w`` of column
    ``j`` is its entry of info bit ``32 w + b`` in codeword bit ``j``; zero
    past k and n."""
    n, k = GT.shape
    words, cols = -(-k // 32), -(-n // TILE) * TILE
    bits = np.zeros((cols, 32 * words), np.uint8)
    bits[:n, :k] = GT.astype(np.uint8) & 1
    packed = np.packbits(bits, axis=1, bitorder="little")  # [cols, 4 words]
    return np.ascontiguousarray(packed.view("<u4").astype(np.uint32).T)


class GF2Encoder:
    """``encoder(u)``: the f32 0/1 codewords of uint8 info bits ``u``
    [B, k], as ``[n, B]`` (``frames_minor``: codewords on the minor axis,
    the layout K1 and K2 consume) or ``[B, n]`` (the unfused path's and
    K6's). Only the low bit of each byte counts, as in the product mod 2."""

    def __init__(self, spec, graph: str = "orig",
                 device: str | torch.device | None = None, *,
                 frames_minor: bool):
        dev = resolve_device(device)
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"no encoder for device {dev}")
        GT = generator_T(spec, graph)
        self.k, self.n = spec.P.shape[0], sum(spec.P.shape)
        self.frames_minor = frames_minor
        # the plain version's operand, on the host until a call on the card
        self.G = torch.from_numpy(GT if frames_minor
                                  else np.ascontiguousarray(GT.T))
        words = generator_words(GT)
        self.table = torch.from_numpy(words.view(np.int32)).to(dev)
        self.device = self.table.device
        if dev.type == "cuda":
            build.load(ENCODE.library)

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        if u.device.type == "cpu":
            return self.plain(u)
        if u.device.type != "cuda":
            raise ValueError(f"no kernel for device {u.device}")
        return self.launch(u)

    def _check(self, u: torch.Tensor) -> int:
        """B, after raising unless ``u`` is uint8 [B, k] with B >= 1,
        contiguous and on the table's device."""
        if u.dim() != 2 or u.shape[0] < 1 or u.shape[1] != self.k:
            raise ValueError(f"u has shape {tuple(u.shape)}, expected "
                             f"(B, {self.k}) with B >= 1")
        check_arg(u, "u", torch.uint8, (tuple(u.shape),), self.device)
        return u.shape[0]

    def plain(self, u: torch.Tensor) -> torch.Tensor:
        """The f32 product mod 2 (``[n, k] @ u^T`` or ``u @ [k, n]``), on
        the encoder's device: the oracle K8 is held to."""
        self._check(u)
        if self.G.device != u.device:
            self.G = self.G.to(u.device)
        x = u.to(torch.float32)
        return torch.remainder(self.G @ x.T if self.frames_minor
                               else x @ self.G, 2.0)

    def launch(self, u: torch.Tensor) -> torch.Tensor:
        """K8: one launch. Raises, before any launch, on a tensor the kernel
        would misread, and on a device without the kernel."""
        B = self._check(u)
        dev = self.device
        if dev.type != "cuda":
            raise ValueError(f"no kernel for device {dev}")
        out = torch.empty((self.n, B) if self.frames_minor else (B, self.n),
                          dtype=torch.float32, device=dev)
        words, cols = self.table.shape
        ENCODE(u.data_ptr(), self.table.data_ptr(), out.data_ptr(), B, self.k,
               self.n, words, cols, int(self.frames_minor), dev.index,
               torch.cuda.current_stream(dev).cuda_stream)
        return out


def make_encoder(spec, graph: str = "orig",
                 device: str | torch.device | None = None) -> GF2Encoder:
    """Build ``encode(u: [B, k]) -> f32 [B, n]``: codewords on the major
    axis, the layout of the unfused path (``encode.py:19-36``)."""
    return GF2Encoder(spec, graph, device, frames_minor=False)


def make_encoder_T(spec, graph: str = "orig",
                   device: str | torch.device | None = None) -> GF2Encoder:
    """Build ``encode_T(u: [B, k]) -> f32 [n, B]``: codewords on the minor
    axis, the layout the fused kernels consume."""
    return GF2Encoder(spec, graph, device, frames_minor=True)


def random_info_bits(generator: torch.Generator, batch: int, k: int) -> torch.Tensor:
    """Uniform random info bits [batch, k] as uint8 on the generator's device."""
    return torch.randint(0, 2, (batch, k), generator=generator,
                         device=generator.device, dtype=torch.uint8)
