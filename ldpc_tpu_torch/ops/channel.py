"""Channel constants and the channel of the unfused path.

Counterpart of ``ldpc_tpu/ops/channel.py``: the per-SNR scale factors of the
reference channel (`python_ldpc_app/channel.py:102-119`), BPSK / QPSK-proxy
modulation and the three interference modes, and true Gray M-QAM
(``ops.modem``). The constants travel as one f32 tensor of eight values in
:data:`CONSTS_ORDER`, the order of the JAX fused kernel's SMEM vector
(``mc_pallas.py:133-139``), so an SNR sweep changes a tensor, not a kernel;
the fused kernels (ldpc_tpu_torch.ops.mc_kernels) and :func:`make_channel_fn`
both read it.

  mode 1: AWGN.              LLR = 2 y / sigma1^2
  mode 2: partial-band: with probability p a bit (a whole QAM symbol) also
          receives a second Gaussian; LLR = (bit+n1[+n2]) * L_c2 or * L_c1
          (QAM: demapped with that symbol's noise variance)
  mode 3: barrage jamming: convex mix scaled by L_c3 (QAM: y = s + n1 + p n2)

Noise model quirk: the reference draws mode-1 noise with sigma**2 passed as
the standard deviation (`channel.py:55-68`); ``noise_model='legacy'`` keeps
that, ``'exact'`` uses the correct sigma. QAM always uses exact noise.

Every draw goes through :func:`draw_normal` / :func:`draw_uniform` from the
batch's ``torch.Generator``, in the JAX channel's call order, so a test can
hand both packages the same draws.
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


def draw_normal(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard normals, f32, on the generator's device."""
    return torch.randn(tuple(shape), generator=generator,
                       device=generator.device, dtype=torch.float32)


def draw_uniform(generator: torch.Generator, shape) -> torch.Tensor:
    """Uniforms in [0, 1), f32, on the generator's device."""
    return torch.rand(tuple(shape), generator=generator,
                      device=generator.device, dtype=torch.float32)


def make_channel_fn(mode: int, modulation: int = 1, n: int | None = None):
    """Build ``channel(generator, bits f32 [B, n], consts f32 [8]) -> llr``.

    ``bits`` are code bits in {0, 1}; the result is the per-bit channel LLRs
    with the reference's sign convention (LLR > 0 <=> bit 1). ``modulation``
    1 = BPSK, 2 = the reference's +-0.7 QPSK proxy, 4/16/64 = Gray QAM
    (needs ``n``). Draw order: mode 1 one normal; modes 2 and 3 two normals,
    then (mode 2) the jam uniforms; QAM the per-symbol jam uniforms (mode 2),
    then the I normals and the Q normals.
    """
    c = {name: i for i, name in enumerate(CONSTS_ORDER)}

    if modulation in (4, 16, 64):
        if n is None:
            raise ValueError("QAM channels need the codeword length n")
        from ldpc_tpu_torch.ops.modem import make_qam_modem, qam_spec

        bps, _, _ = qam_spec(modulation)
        if mode not in (1, 2, 3):
            raise ValueError(f"Unknown channel mode: {mode}")
        modems: dict = {}

        def channel(generator, bits, consts):
            dev = bits.device
            if dev not in modems:
                modems[dev] = make_qam_modem(modulation, n, dev)
            modulate, demap = modems[dev]
            yI, yQ = modulate(bits)
            s1, s2, p = consts[c["sigma1"]], consts[c["sigma2"]], consts[c["p"]]
            # per-dimension noise variance sigma^2 / bps (speed and SNR are
            # folded into sigma1); per symbol under mode 2's jammer, which
            # hits I and Q together (sigma2 embeds the 1/p duty cycle)
            if mode == 1:
                noise_var = (s1 * s1) / bps
            elif mode == 2:
                jam = (draw_uniform(generator, yI.shape) < p).to(torch.float32)
                noise_var = (s1 * s1 + jam * (s2 * s2)) / bps
            else:
                noise_var = (s1 * s1 + (p * p) * (s2 * s2)) / bps
            std = torch.sqrt(noise_var)
            yI = yI + std * draw_normal(generator, yI.shape)
            yQ = yQ + std * draw_normal(generator, yQ.shape)
            # demap with the matched variance the noise was drawn at
            return demap(yI, yQ, noise_var)

        return channel

    if modulation not in (1, 2):
        raise ValueError(
            f"Unknown modulation {modulation}: 1=BPSK, 2=QPSK proxy, "
            f"4/16/64=Gray QAM"
        )
    amp = 1.0 if modulation == 1 else 0.7

    if mode == 1:
        def channel(generator, bits, consts):
            sym = (2.0 * bits - 1.0) * amp
            noise = consts[c["noise1_std"]] * draw_normal(generator, bits.shape)
            return consts[c["llr_scale"]] * (sym + noise)

        return channel

    if mode == 2:
        def channel(generator, bits, consts):
            sym = (2.0 * bits - 1.0) * amp
            n1 = consts[c["sigma1"]] * draw_normal(generator, bits.shape)
            n2 = consts[c["sigma2"]] * draw_normal(generator, bits.shape)
            jammed = draw_uniform(generator, bits.shape) < consts[c["p"]]
            return torch.where(jammed, (sym + n1 + n2) * consts[c["l_c2"]],
                               (sym + n1) * consts[c["l_c1"]])

        return channel

    if mode == 3:
        def channel(generator, bits, consts):
            sym = (2.0 * bits - 1.0) * amp
            n1 = consts[c["sigma1"]] * draw_normal(generator, bits.shape)
            n2 = consts[c["sigma2"]] * draw_normal(generator, bits.shape)
            p = consts[c["p"]]
            return ((sym + n1 + n2) * p + (sym + n1) * (1.0 - p)) * consts[c["l_c3"]]

        return channel

    raise ValueError(f"Unknown channel mode: {mode}")


def make_channel(params: ChannelParams, n: int | None = None,
                 device: str | torch.device | None = None):
    """One SNR point's channel: ``channel(generator, bits) -> llr``. ``n``
    (codeword length) is required for the QAM modulations."""
    if params.modulation in (4, 16, 64) and params.noise_model == "legacy":
        raise ValueError(
            "QAM modulations use exact noise physics; the legacy "
            "sigma^2-as-stddev quirk is BPSK-specific -- set "
            "noise_model='exact'"
        )
    fn = make_channel_fn(params.mode, params.modulation, n=n)
    consts = params.consts(device)

    def channel(generator, bits):
        return fn(generator, bits, consts)

    return channel
