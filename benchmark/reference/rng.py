"""The simulator's random streams, worked out from its keys: the splitmix64
key tree, the torch generators a batch's bits, interleaver and channel draw
from, and the Philox4x32-10 words and Box-Muller normals of the fused
channel.

Key tree: a point's key is ``derive(base, point)``, its batch ``i`` has key
``derive(point key, i)``. A fused batch seeds its info bits' generator with
``mix(key ^ 1) >> 1`` and keys Philox with the two halves of ``mix(key ^ 2)``;
an unfused batch seeds three generators with ``derive(key, j) >> 1`` for the
info bits (j = 0), the interleaver (1) and the channel (2).

Philox: codeword b, base-column pair p (columns 2p and 2p + 1), row z draw
``philox(counter=(b, p Z + z, call, 0), key)``. Words 0-2 of call 0 are the
48-bit radial uniform (hi, lo) and the angle uniform of one Box-Muller pair:
its cosine goes to column 2p and its sine to column 2p + 1.
"""

from __future__ import annotations

import math

import torch

M64 = (1 << 64) - 1
M32 = 0xFFFFFFFF


def mix(x: int) -> int:
    """splitmix64's finaliser."""
    x = (x + 0x9E3779B97F4A7C15) & M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M64
    return x ^ (x >> 31)


def derive(key: int, index: int) -> int:
    return mix(mix(int(key) & M64) ^ (int(index) & M64))


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def info_bits(gen: torch.Generator, batch: int, k: int) -> torch.Tensor:
    return torch.randint(0, 2, (batch, k), generator=gen, device=gen.device,
                         dtype=torch.uint8)


def fused_streams(key: int, device):
    """(info-bit generator, Philox key words) of one fused batch."""
    k = mix(key ^ 2)
    return generator(mix(key ^ 1) >> 1, device), (k & M32, k >> 32)


def _mulhilo(a: torch.Tensor, m: int):
    lo16 = (a & 0xFFFF) * m
    hi16 = (a >> 16) * m
    s = ((hi16 & 0xFFFF) << 16) + lo16
    return ((hi16 >> 16) + (s >> 32)) & M32, s & M32


def philox(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors of 32-bit words."""
    for r in range(10):
        if r:
            k0 = (k0 + 0x9E3779B9) & M32
            k1 = (k1 + 0xBB67AE85) & M32
        hi0, lo0 = _mulhilo(c0, 0xD2511F53)
        hi1, lo1 = _mulhilo(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _u24(w: torch.Tensor, dtype) -> torch.Tensor:
    return (w >> 8).to(torch.int32).to(dtype) * 2.0**-24 + 2.0**-25


def normals(key: tuple[int, int], nb: int, Z: int, B: int, device,
            dtype=torch.float32) -> torch.Tensor:
    """Standard normals [nb, Z, B] of the fused channel's call 0."""
    P = (nb + 1) // 2
    b = torch.arange(B, dtype=torch.int64, device=device).view(1, 1, B)
    pz = torch.arange(P * Z, dtype=torch.int64, device=device).view(P, Z, 1)
    zero = torch.zeros((P, Z, B), dtype=torch.int64, device=device)
    w0, w1, w2, _ = philox(b.expand(P, Z, B), pz.expand(P, Z, B), zero, zero,
                           key[0] & M32, key[1] & M32)
    hi = (w0 >> 8).to(torch.int32).to(dtype)
    lo = (w1 >> 8).to(torch.int32).to(dtype)
    below_one = 1.0 - 2.0**-24 if dtype == torch.float32 else \
        1.0 - torch.finfo(dtype).eps / 2
    u1 = torch.clamp_max(hi * 2.0**-24 + (lo * 2.0**-48 + 2.0**-49), below_one)
    r = torch.sqrt(-2.0 * torch.log(u1))
    ang = (2.0 * math.pi) * _u24(w2, dtype)
    out = torch.empty((nb, Z, B), dtype=dtype, device=device)
    out[0::2] = r * torch.cos(ang)
    out[1::2] = (r * torch.sin(ang))[: nb // 2]
    return out
