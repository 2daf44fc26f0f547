"""Gray QAM and the unfused path's channel against the JAX package's, on
the same bits and the same random draws (numpy draws stand in for both
packages' samplers, in the JAX channel's call order)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.ops import channel as jchannel
from ldpc_tpu.ops import modem as jmodem
from ldpc_tpu_torch.ops import channel as tchannel
from ldpc_tpu_torch.ops import modem as tmodem

torch.set_num_threads(1)

N, B = 576, 32


@pytest.mark.parametrize("order", [4, 16, 64])
def test_qam_modem_matches_reference(order):
    bps, levels, scale = tmodem.qam_spec(order)
    j_bps, j_levels, j_scale = jmodem.qam_spec(order)
    assert bps == j_bps and scale == j_scale
    np.testing.assert_array_equal(levels, j_levels)
    rng = np.random.default_rng(order)
    bits = rng.integers(0, 2, (B, N)).astype(np.float32)
    j_mod, j_demap = jmodem.make_qam_modem(order, N)
    t_mod, t_demap = tmodem.make_qam_modem(order, N)
    jI, jQ = j_mod(jnp.asarray(bits))
    tI, tQ = t_mod(torch.from_numpy(bits))
    np.testing.assert_array_equal(tI.numpy(), np.asarray(jI))
    np.testing.assert_array_equal(tQ.numpy(), np.asarray(jQ))
    # demap the same received samples with a per-symbol noise variance
    n_sym = N // bps
    yI = (np.asarray(jI) + 0.3 * rng.standard_normal((B, n_sym))).astype(np.float32)
    yQ = (np.asarray(jQ) + 0.3 * rng.standard_normal((B, n_sym))).astype(np.float32)
    var = rng.uniform(0.01, 0.2, (B, n_sym)).astype(np.float32)
    ref = np.asarray(j_demap(jnp.asarray(yI), jnp.asarray(yQ), jnp.asarray(var)))
    port = t_demap(torch.from_numpy(yI), torch.from_numpy(yQ),
                   torch.from_numpy(var)).numpy()
    # the same IEEE f32 ops in the same order: equal bit for bit
    np.testing.assert_array_equal(port, ref)
    # noiseless symbols decode to their bits
    clean = t_demap(tI, tQ, torch.tensor(0.1)).numpy()
    np.testing.assert_array_equal(clean > 0, bits > 0.5)


class _Draws:
    """numpy normals / uniforms handed out in call order, the same sequence
    to both packages."""

    def __init__(self, seed: int):
        self.seed = seed
        self.reset()

    def reset(self):
        self.rng = np.random.default_rng(self.seed)

    def normal(self, shape):
        return self.rng.standard_normal(tuple(shape)).astype(np.float32)

    def uniform(self, shape):
        return self.rng.random(tuple(shape)).astype(np.float32)


@pytest.mark.parametrize("modulation", [1, 2, 16])
@pytest.mark.parametrize("mode", [1, 2, 3])
def test_channel_matches_reference(mode, modulation, monkeypatch):
    draws = _Draws(100 * mode + modulation)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(draws.normal(shape)))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, dtype=None: jnp.asarray(draws.uniform(shape)))
    monkeypatch.setattr(tchannel, "draw_normal",
                        lambda gen, shape: torch.from_numpy(draws.normal(shape)))
    monkeypatch.setattr(tchannel, "draw_uniform",
                        lambda gen, shape: torch.from_numpy(draws.uniform(shape)))
    params = dict(mode=mode, modulation=modulation, speed=0.5, snr_db=4.0,
                  interference_snr_db=-3.0 if mode == 2 else 2.0, p=0.15,
                  noise_model="exact")
    bits = np.random.default_rng(mode).integers(0, 2, (B, N)).astype(np.float32)
    ref = np.asarray(jchannel.make_channel(jchannel.ChannelParams(**params), n=N)(
        jax.random.key(0), jnp.asarray(bits)))
    draws.reset()
    port = tchannel.make_channel(tchannel.ChannelParams(**params), n=N,
                                 device="cpu")(None, torch.from_numpy(bits))
    assert port.dtype == torch.float32 and tuple(port.shape) == (B, N)
    np.testing.assert_allclose(port.numpy(), ref, rtol=1e-6)
    assert np.isfinite(ref).all()


def test_qam_refuses_legacy_noise_and_odd_lengths():
    with pytest.raises(ValueError, match="exact"):
        tchannel.make_channel(tchannel.ChannelParams(modulation=16), n=N,
                              device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        tmodem.make_qam_modem(64, 580)
    with pytest.raises(ValueError, match="mode"):
        tchannel.make_channel_fn(4, 1)
