"""Gray-mapped square M-QAM with max-log per-bit LLRs.

Counterpart of ``ldpc_tpu/ops/modem.py``. A square constellation factors
into two binary-reflected-Gray PAM axes: a symbol takes ``bps`` consecutive
bits, the I half then the Q half, each MSB first, and position ``pos`` of an
axis carries label ``pos ^ (pos >> 1)``. Input bits in {0, 1}, output LLR > 0
<=> bit 1, unit average symbol energy; the per-dimension noise variance comes
from the caller (``ops.channel``).
"""

from __future__ import annotations

import numpy as np
import torch


def gray_pam(bits_per_axis: int) -> np.ndarray:
    """Amplitude of each bit-label for binary-reflected-Gray M-PAM:
    ``levels[label]`` over (-(M-1), ..., -1, 1, ..., M-1)."""
    m = 1 << bits_per_axis
    amp = np.arange(-(m - 1), m, 2, dtype=np.float64)  # ascending positions
    levels = np.empty(m, dtype=np.float64)
    for pos in range(m):
        levels[pos ^ (pos >> 1)] = amp[pos]
    return levels


def qam_spec(order: int) -> tuple[int, np.ndarray, float]:
    """(bits per symbol, per-axis Gray levels, axis scale) for square M-QAM;
    the scale makes the average symbol energy 1."""
    if order not in (4, 16, 64):
        raise ValueError(f"Unsupported QAM order: {order} (use 4, 16, 64)")
    bps = int(np.log2(order))
    per_axis = bps // 2
    m_axis = 1 << per_axis
    scale = float(np.sqrt(3.0 / (2.0 * (m_axis**2 - 1))))
    return bps, gray_pam(per_axis), scale


def make_qam_modem(order: int, n: int, device: str | torch.device = "cpu"):
    """Build ``(modulate, demap)`` for length-``n`` codewords.

    modulate(bits f32 [B, n]) -> (I, Q) f32 [B, n/bps]
    demap(I, Q, noise_var)    -> llr f32 [B, n]  (``noise_var`` a scalar or
    [B, n/bps] tensor; a ``1e30`` sentinel stands in the masked minima)
    """
    bps, levels, scale = qam_spec(order)
    if n % bps:
        raise ValueError(f"codeword length {n} not divisible by {bps} bits/symbol")
    per_axis = bps // 2
    n_sym = n // bps
    m_axis = levels.shape[0]
    levels_s = torch.as_tensor((levels * scale).astype(np.float32), device=device)
    # bit b of axis label l (MSB first), True where it is 1: [per_axis, m_axis]
    label_bits = torch.as_tensor(np.array(
        [[(lab >> (per_axis - 1 - b)) & 1 for lab in range(m_axis)]
         for b in range(per_axis)], dtype=bool), device=device)
    weights = torch.as_tensor(
        [1 << (per_axis - 1 - b) for b in range(per_axis)], dtype=torch.int64,
        device=device)
    big = torch.tensor(1e30, dtype=torch.float32, device=device)

    def axis_map(bits_axis: torch.Tensor) -> torch.Tensor:
        """bits [B, n_sym, per_axis] -> amplitudes [B, n_sym]."""
        labels = (bits_axis.to(torch.int64) * weights).sum(dim=-1)
        return levels_s[labels]

    def modulate(bits: torch.Tensor):
        g = bits.reshape(bits.shape[0], n_sym, bps)
        return axis_map(g[..., :per_axis]), axis_map(g[..., per_axis:])

    def axis_llr(y: torch.Tensor, noise_var) -> torch.Tensor:
        """y [B, n_sym] -> per-bit max-log LLRs [B, n_sym, per_axis]."""
        diff = y[..., None] - levels_s
        d2 = diff * diff  # [B, n_sym, m_axis]
        out = []
        for b in range(per_axis):
            mask1 = label_bits[b]
            d0 = torch.where(mask1, big, d2).amin(dim=-1)
            d1 = torch.where(mask1, d2, big).amin(dim=-1)
            out.append((d0 - d1) / (2.0 * noise_var))
        return torch.stack(out, dim=-1)

    def demap(yI: torch.Tensor, yQ: torch.Tensor, noise_var) -> torch.Tensor:
        llr = torch.cat([axis_llr(yI, noise_var), axis_llr(yQ, noise_var)],
                        dim=-1)  # [B, n_sym, bps]
        return llr.reshape(yI.shape[0], n_sym * bps)

    return modulate, demap
