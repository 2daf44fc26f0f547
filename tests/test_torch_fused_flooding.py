"""The fused kernels' flooding schedule and flip metric (K1 ``MCDecoder``, K2
``LLRDecoder``, plain versions on the CPU) against the JAX package's
interpret-mode ``make_mc_decoder`` / ``make_llr_decoder`` with
``schedule='flooding'`` and ``track_norm=True`` on the same inputs (info
bits and injected noise words, or LLRs and a pre-done mask), and a fused
flooding executor whose counters do not depend on the dispatch mode."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.models import standards as jstd
from ldpc_tpu.models.code import LDPCCode as JCode
from ldpc_tpu.ops import channel as jchannel
from ldpc_tpu.ops import encode as jencode
from ldpc_tpu.ops.mc_pallas import (
    consts_vector,
    make_llr_decoder,
    make_mc_decoder,
)
from ldpc_tpu_torch.ops.mc_kernels import DRAWS_PER_BIT, LLRDecoder, MCDecoder
from ldpc_tpu_torch.sim.config import SimOptions
from ldpc_tpu_torch.sim.runner import PointExecutor, load_code
from ldpc_tpu_torch.utils.carry import code_from_numpy, consts_from_numpy

torch.set_num_threads(1)

W576 = "wimax_576_0.5.alist.txt"
N128 = "CCSDS_ldpc_n128_k64.alist.txt"  # Z = 16: two codewords per warp
B = 128
ITERS = 10


def _codes(name=W576):
    ref = JCode(alist=jstd.make_builtin(name), name=name)
    port = code_from_numpy(ref.n, ref.m, ref.H.row_idx, ref.H.col_idx, name)
    return ref, port


def _same(port, ref, variant, what):
    """Per-frame equality: every frame for the min-sum family, >= 99% for
    SPA (tanh and log differ by ulps between the two libraries)."""
    same = np.ones(B, bool)
    for name, a, b in zip(what, port, ref):
        same &= np.asarray(a) == np.asarray(b)
    if variant == "spa":
        assert same.mean() >= 0.99, np.nonzero(~same)[0].tolist()
    else:
        assert same.all(), np.nonzero(~same)[0].tolist()
    return same


@pytest.mark.parametrize("variant,mode,name", [
    ("normalized_minsum", 2, N128), ("spa", 1, N128)])
def test_mc_decoder_flooding_with_the_flip_metric(variant, mode, name):
    """K1 flooding: err / ok / conv of every frame (SPA: >= 99%), the flip
    metric within 1e-6 (XLA divides by k as a product with 1/k), and the
    batch's trips equal the interpret-mode kernel's."""
    ref, port = _codes(name)
    info = ref.standard_encode_spec.info_pos("orig")
    rng = np.random.default_rng(20 + mode)
    u = rng.integers(0, 2, (B, ref.k), dtype=np.uint8)
    raw = rng.integers(0, 2**32, (DRAWS_PER_BIT[mode], ref.n, B),
                       dtype=np.uint32)
    wT = jencode.make_encoder_T(ref.standard_encode_spec, "orig")(
        jnp.asarray(u))
    params = dict(mode=mode, modulation=1, snr_db=2.0 if mode == 1 else 2.5,
                  speed=0.5, noise_model="exact", p=0.2,
                  interference_snr_db=-1.0)
    cv = consts_vector(jchannel.ChannelParams(**params).consts())
    mc = make_mc_decoder(ref.qc, info, ITERS, variant, mode=mode,
                         schedule="flooding", noise_source="input",
                         interpret=True, track_norm=True)
    r = [np.asarray(x) for x in jax.jit(mc)(wT, cv, jnp.zeros(2, jnp.int32),
                                            jnp.asarray(raw))]
    dec = MCDecoder(port.qc, port.standard_encode_spec.info_pos("orig"),
                    ITERS, variant, mode=mode, schedule="flooding",
                    track_norm=True)
    o = [x.numpy() for x in dec(torch.from_numpy(np.array(wT, np.float32)),
                                consts_from_numpy(np.asarray(cv), "cpu"),
                                raw=torch.from_numpy(raw))]
    same = _same(o[:3], r[:3], variant, ("err", "ok", "conv"))
    np.testing.assert_allclose(o[3][same], r[3][same], rtol=0, atol=1e-6)
    assert int(o[4].max()) == int(r[4].max())
    assert 0 < o[1].sum() < B and (o[3] > 0).any()


@pytest.mark.parametrize("variant", ["normalized_minsum", "spa"])
def test_llr_decoder_flooding_with_the_flip_metric(variant):
    """K2 flooding from given LLRs with a pre-done mask: the live frames'
    err / ok / conv (SPA: >= 99%) and flip metric (1e-6); pre-done frames
    are placeholders with no flip metric."""
    ref, port = _codes(N128)
    info = ref.standard_encode_spec.info_pos("orig")
    rng = np.random.default_rng(31)
    u = rng.integers(0, 2, (B, ref.k), dtype=np.uint8)
    w = ref.standard_encode_spec.encode_numpy(u, "orig").astype(np.float32)
    sigma = 1.0 / np.sqrt(2 * 0.5 * 10 ** 0.2)
    llr = (-2 * ((2 * w - 1) + sigma * rng.standard_normal(w.shape))
           / sigma**2).astype(np.float32)
    llrT, wT = np.ascontiguousarray(llr.T), np.ascontiguousarray(w.T)
    done0 = (rng.random(B) < 0.3).astype(np.float32)
    dec = make_llr_decoder(ref.qc, info, ITERS, variant, schedule="flooding",
                           interpret=True, track_norm=True)
    r = [np.asarray(x) for x in jax.jit(dec)(
        jnp.asarray(llrT), jnp.asarray(wT), jnp.asarray(done0))]
    o = [x.numpy() for x in LLRDecoder(
        port.qc, port.standard_encode_spec.info_pos("orig"), ITERS, variant,
        schedule="flooding", track_norm=True)(
        torch.from_numpy(llrT), torch.from_numpy(wT), torch.from_numpy(done0))]
    live = done0 < 0.5
    same = np.ones(B, bool)
    for a, b in zip(o[:3], r[:3]):
        same &= a == b
    if variant == "spa":
        assert same[live].mean() >= 0.99
    else:
        assert same[live].all(), np.nonzero(~same & live)[0].tolist()
    keep = same & live
    np.testing.assert_allclose(o[3][keep], r[3][keep], rtol=0, atol=1e-6)
    assert (o[3][~live] == 0).all() and o[1][~live].all()
    assert 0 < o[1][live].sum() < live.sum() and (o[3][live] > 0).any()


def test_fused_flooding_counters_equal_across_dispatch_modes():
    """A fused flooding executor: a single pass and a forced split (phase 1
    of 8 sweeps, K2 re-decoding the unconverged frames) give the same
    counters on the same frames."""
    code = load_code(f"builtin:{W576}")
    stats = {}
    for two_phase in ("off", "8"):
        ex = PointExecutor(code, SimOptions(
            matrix=code.name, iterations=16, fidelity="exact", batch=256,
            seed=5, speed=0.5, schedule="flooding",
            decoder="normalized-minsum", two_phase=two_phase), device="cpu")
        assert ex.fused and ex.kernel_used == (
            "cpu+fused" + ("" if two_phase == "off" else "+2phase(8)"))
        stats[two_phase] = ex.run_point(1.75, 2 * 256)
    assert stats["off"] == stats["8"]
    assert 0 < stats["off"].fer_frames < stats["off"].blocks


def test_flooding_refusals():
    _, port = _codes()
    info = port.standard_encode_spec.info_pos("orig")
    with pytest.raises(ValueError, match="layer_groups"):
        MCDecoder(port.qc, info, 12, "spa", schedule="flooding",
                  layer_groups=[[i] for i in range(port.qc.mb)])
    with pytest.raises(ValueError, match="track_norm=False"):
        LLRDecoder(port.qc, info, 12, "spa", schedule="flooding",
                   track_norm=True, check_every=2)
    with pytest.raises(ValueError, match="Unknown schedule"):
        MCDecoder(port.qc, info, 12, "spa", schedule="zigzag")
