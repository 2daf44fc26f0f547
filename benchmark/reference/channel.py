"""The channels of the two configurations, from their definitions.

Eb/N0 in dB at code rate ``speed``: sigma1 = 1 / sqrt(2 speed 10^(snr/10)).
BPSK (bit b sent as 2b - 1) over AWGN gives the LLR 2 y / sigma1^2 with the
convention LLR > 0 for bit 1; the decoder takes its negation. Mode 2 adds,
with probability p per symbol, a second Gaussian of deviation
sigma2 = 1 / sqrt(2 speed 10^(isnr/10) p) (the jammer's power spread over
its duty cycle). Square Gray 16-QAM: each 4 bits are I then Q, two bits an
axis, MSB first, the axis level of label l at position l ^ (l >> 1) over
(-3, -1, 1, 3) sqrt(1/10); per-bit max-log LLRs with the noise variance of
that symbol, (sigma1^2 + jam sigma2^2) / 4 per dimension. Each constant is
worked out in double precision and rounded once to float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import rng


def constants(snr_db: float, speed: float, *, isnr_db: float = 1.0,
              p: float = 0.1) -> dict[str, float]:
    sn1 = 10.0 ** (snr_db * 0.1)
    sn2 = 10.0 ** (isnr_db * 0.1)
    sigma1 = 1.0 / math.sqrt(2.0 * speed * sn1)
    v = {"noise_std": sigma1, "llr_scale": 2.0 / (sigma1 ** 2),
         "sigma1": sigma1,
         "sigma2": 1.0 / math.sqrt(2.0 * speed * (sn2 * p)), "p": p}
    return {name: float(np.float32(x)) for name, x in v.items()}


def bpsk_llr(wT: torch.Tensor, z: torch.Tensor, c: dict) -> torch.Tensor:
    """Decoder-domain LLRs [n, B] (log p0/p1) of bits ``wT`` [n, B] under
    unit normals ``z`` [n, B]."""
    sym = 2.0 * wT - 1.0
    return -(c["llr_scale"] * (sym + c["noise_std"] * z))


def _qam_axis():
    """Per-axis Gray levels (by label) and the label's bits, MSB first."""
    levels = np.empty(4)
    for pos, amp in enumerate((-3.0, -1.0, 1.0, 3.0)):
        levels[pos ^ (pos >> 1)] = amp
    bits = np.array([[(lab >> (1 - b)) & 1 for lab in range(4)]
                     for b in range(2)], dtype=bool)
    return levels * math.sqrt(3.0 / (2.0 * 15.0)), bits


def qam16_jammed(w: torch.Tensor, gen: torch.Generator, c: dict,
                 dtype=torch.float32) -> torch.Tensor:
    """Channel-domain LLRs [B, n] (> 0 for bit 1) of bits ``w`` [B, n] sent
    as Gray 16-QAM through the mode-2 jammer. Draws, in order, the jam
    uniforms, the I normals and the Q normals, one per symbol each."""
    B, n = w.shape
    dev = w.device
    lv, lbits = _qam_axis()
    levels = torch.as_tensor(lv.astype(np.float32), device=dev).to(dtype)
    lbits = torch.as_tensor(lbits, device=dev)
    g = w.reshape(B, n // 4, 4).to(torch.int64)
    yI = levels[g[..., 0] * 2 + g[..., 1]]
    yQ = levels[g[..., 2] * 2 + g[..., 3]]
    shape = yI.shape
    jam = (torch.rand(shape, generator=gen, device=dev) < c["p"]).to(dtype)
    s1, s2 = np.float32(c["sigma1"]), np.float32(c["sigma2"])
    # the squares are float32 products, as the rest of the chain is
    var = (float(s1 * s1) + jam * float(s2 * s2)) / 4
    std = torch.sqrt(var)
    yI = yI + std * torch.randn(shape, generator=gen, device=dev).to(dtype)
    yQ = yQ + std * torch.randn(shape, generator=gen, device=dev).to(dtype)
    out = []
    for y in (yI, yQ):
        diff = y[..., None] - levels
        d2 = diff * diff
        for b in range(2):
            d0 = torch.where(lbits[b], 1e30, d2).amin(dim=-1)
            d1 = torch.where(lbits[b], d2, 1e30).amin(dim=-1)
            out.append((d0 - d1) / (2.0 * var))
    return torch.stack(out, dim=-1).reshape(B, n)


def random_permutations(gen: torch.Generator, B: int, n: int, device):
    """A fresh uniform permutation per codeword: the order of n uniforms.
    Bit i of the sent word is bit ``pi[i]`` of the codeword."""
    return torch.argsort(torch.rand((B, n), generator=gen, device=device),
                         dim=-1)


def unfused_llr(u: torch.Tensor, G: torch.Tensor, key: int, c: dict,
                dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """(codewords [B, n], decoder-domain LLRs [n, B]) of one 16-QAM batch
    with a random interleaver, from its key."""
    dev = u.device
    w = torch.remainder(u.to(torch.float32) @ G, 2.0)
    B, n = w.shape
    pi = random_permutations(rng.generator(rng.derive(key, 1) >> 1, dev),
                             B, n, dev)
    sent = torch.gather(w, 1, pi)
    llr = qam16_jammed(sent, rng.generator(rng.derive(key, 2) >> 1, dev), c,
                       dtype)
    back = torch.empty_like(llr).scatter_(1, pi, llr)
    return w, (-back).T.contiguous()
