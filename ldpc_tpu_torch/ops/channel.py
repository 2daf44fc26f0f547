"""Channel constants for the fused Monte-Carlo kernels.

Counterpart of ``ldpc_tpu/ops/channel.py:43-112``: the per-SNR scale
factors of the reference channel (`python_ldpc_app/channel.py:102-119`),
BPSK / QPSK-proxy modulation and the three interference modes. The fused
kernels (ldpc_tpu_torch.ops.mc_kernels) take them as one f32 tensor of eight
values in :data:`CONSTS_ORDER`, the order of the JAX kernel's SMEM vector
(``mc_pallas.py:133-139``), so an SNR sweep changes a tensor, not a kernel.

Noise model quirk: the reference draws mode-1 noise with sigma**2 passed as
the standard deviation (`channel.py:55-68`); ``noise_model='legacy'`` keeps
that, ``'exact'`` uses the correct sigma.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ldpc_tpu_torch.utils.device import resolve_device

CONSTS_ORDER = ("noise1_std", "llr_scale", "sigma1", "sigma2", "l_c1", "l_c2",
                "l_c3", "p")


@dataclass(frozen=True)
class ChannelParams:
    """Host-side channel configuration for one SNR point."""

    mode: int = 1  # 1=AWGN, 2=partial-band, 3=jamming
    modulation: int = 1  # 1=BPSK, 2=QPSK-proxy (+-0.7)
    speed: float = 1.0  # code rate factor in Eb/N0 scaling
    snr_db: float = 0.0  # signal SNR (sn1)
    interference_snr_db: float = 1.0  # interference SNR (sn2), modes 2/3
    p: float = 0.1  # interference probability / mix weight (gamma)
    noise_model: str = "legacy"  # 'legacy' (sigma^2-as-stddev quirk) | 'exact'

    @property
    def l_c1(self) -> float:
        return 4.0 * self.speed * (10.0 ** (self.snr_db * 0.1))

    @property
    def l_c2(self) -> float:
        sn1 = 10.0 ** (self.snr_db * 0.1)
        sn2 = 10.0 ** (self.interference_snr_db * 0.1)
        return 4.0 * self.speed / ((1.0 / sn1) + (1.0 / (sn2 * self.p)))

    @property
    def l_c3(self) -> float:
        sn1 = 10.0 ** (self.snr_db * 0.1)
        sn2 = 10.0 ** (self.interference_snr_db * 0.1)
        return 4.0 * self.p * self.speed / (1.0 / sn2 + 1.0 / sn2) + (
            4.0 * self.speed * (1.0 - self.p) * sn1
        )

    @property
    def sigma1(self) -> float:
        return 1.0 / math.sqrt(2.0 * self.speed * (10.0 ** (self.snr_db * 0.1)))

    @property
    def sigma2(self) -> float:
        sn2 = 10.0 ** (self.interference_snr_db * 0.1)
        if self.mode == 2:
            return 1.0 / math.sqrt(2.0 * self.speed * (sn2 * self.p))
        return 1.0 / math.sqrt(2.0 * self.speed * sn2)

    def values(self) -> dict[str, float]:
        """The eight constants as Python floats, by name."""
        sigma1 = self.sigma1
        return {
            "noise1_std": sigma1**2 if self.noise_model == "legacy" else sigma1,
            "llr_scale": 2.0 / (sigma1**2),
            "sigma1": sigma1,
            "sigma2": self.sigma2,
            "l_c1": self.l_c1,
            "l_c2": self.l_c2,
            "l_c3": self.l_c3,
            "p": self.p,
        }

    def consts(self, device: str | torch.device | None = None) -> torch.Tensor:
        """f32 [8] in :data:`CONSTS_ORDER` (each value rounded once to f32)."""
        v = self.values()
        return torch.tensor([v[name] for name in CONSTS_ORDER],
                            dtype=torch.float32, device=resolve_device(device))
