"""Encode, channel constants, counters and the channel LLRs of the port
against the JAX package, on the same numpy inputs."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.models import standards as jstd
from ldpc_tpu.models.code import LDPCCode as JCode
from ldpc_tpu.ops import channel as jchannel
from ldpc_tpu.ops import encode as jencode
from ldpc_tpu.ops import mc_pallas
from ldpc_tpu.ops import metrics as jmetrics
from ldpc_tpu_torch.ops import channel as tchannel
from ldpc_tpu_torch.ops import encode as tencode
from ldpc_tpu_torch.ops import mc_kernels
from ldpc_tpu_torch.ops import metrics as tmetrics
from ldpc_tpu_torch.utils.carry import consts_from_numpy

torch.set_num_threads(1)
CPU = "cpu"


@pytest.fixture(scope="module")
def code1152():
    name = "wimax_1152_0.5.alist.txt"
    return JCode(alist=jstd.make_builtin(name), name=name)


def test_encoder_T_matches_reference(code1152):
    spec = code1152.standard_encode_spec
    u = np.random.default_rng(0).integers(0, 2, (256, code1152.k), dtype=np.uint8)
    ref = np.asarray(jencode.make_encoder_T(spec, "orig")(jnp.asarray(u)))
    port = tencode.make_encoder_T(spec, "orig", CPU)(torch.from_numpy(u))
    assert port.dtype == torch.float32 and tuple(port.shape) == (code1152.n, 256)
    np.testing.assert_array_equal(port.numpy(), ref.astype(np.float32))
    # a valid codeword of the original H
    assert not code1152.syndrome_orig(port.numpy()[:, 0]).any()


def test_random_info_bits_follow_the_generator():
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    a = tencode.random_info_bits(g1, 64, 576)
    b = tencode.random_info_bits(g2, 64, 576)
    assert a.dtype == torch.uint8 and tuple(a.shape) == (64, 576)
    assert torch.equal(a, b) and 0.45 < a.float().mean() < 0.55


PARAMS = [
    dict(mode=1, snr_db=2.0, speed=0.5, noise_model="exact"),
    dict(mode=1, snr_db=-1.5, speed=1.0, noise_model="legacy"),
    dict(mode=2, modulation=2, snr_db=4.0, interference_snr_db=6.0, p=0.2,
         noise_model="exact"),
    dict(mode=3, snr_db=1.0, interference_snr_db=3.0, p=0.4, speed=0.75),
]


@pytest.mark.parametrize("kw", PARAMS)
def test_consts_match_reference(kw):
    ref = np.asarray(mc_pallas.consts_vector(jchannel.ChannelParams(**kw).consts()))
    port = tchannel.ChannelParams(**kw).consts(CPU)
    assert port.dtype == torch.float32
    np.testing.assert_array_equal(port.numpy(), ref)
    np.testing.assert_array_equal(consts_from_numpy(ref, CPU).numpy(), ref)


def test_counters_match_reference():
    rng = np.random.default_rng(3)
    B = 300
    err = rng.integers(0, 40, B).astype(np.int32)
    ok = rng.random(B) < 0.7
    conv = np.where(ok, rng.integers(0, 12, B), -1).astype(np.int32)
    norm = rng.random(B).astype(np.float32)
    valid = np.arange(B) < 271
    iters = np.int32(17)
    jstats = jmetrics.BlockStats(jnp.asarray(err), jnp.asarray(ok),
                                 jnp.asarray(conv), jnp.asarray(norm))
    ref = np.asarray(jmetrics.pack_counters(
        jmetrics.reduce_block_stats(jstats, jnp.asarray(valid)),
        jnp.asarray(iters)))
    tstats = tmetrics.BlockStats(*(torch.from_numpy(x) for x in (err, ok, conv, norm)))
    port = tmetrics.pack_counters(
        tmetrics.reduce_block_stats(tstats, torch.from_numpy(valid)),
        torch.tensor(iters))
    assert port.dtype == torch.int32
    np.testing.assert_array_equal(port.numpy(), ref)
    (jc, ji), (tc, ti) = jmetrics.unpack_counters(ref), tmetrics.unpack_counters(port)
    assert ji == ti and tuple(map(float, jc)) == tuple(map(float, tc))


@pytest.mark.parametrize("modulation", [1, 2])
@pytest.mark.parametrize("mode", [1, 2, 3])
def test_channel_llrs_match_reference(mode, modulation):
    name = "wimax_576_0.5.alist.txt"
    code = JCode(alist=jstd.make_builtin(name), name=name)
    Z, n, B = code.qc.Z, code.n, 64
    rng = np.random.default_rng(10 * mode + modulation)
    wT = rng.integers(0, 2, (n, B)).astype(np.float32)
    raw = rng.integers(0, 2**32, (mc_kernels.DRAWS_PER_BIT[mode], n, B),
                       dtype=np.uint32)
    params = dict(mode=mode, modulation=modulation, snr_db=1.0, speed=0.5,
                  interference_snr_db=6.0, p=0.3, noise_model="exact")
    ref = np.asarray(mc_pallas.channel_llr_reference(
        jnp.asarray(wT), jnp.asarray(raw),
        jchannel.ChannelParams(**params).consts(), mode, modulation, Z))
    port = mc_kernels.channel_llr_reference(
        torch.from_numpy(wT), torch.from_numpy(raw),
        tchannel.ChannelParams(**params).consts(CPU), mode, modulation, Z)
    # the reference's own bar for replays of the channel math
    # (test_mc_fused.py:132-133)
    np.testing.assert_allclose(port.numpy(), ref.astype(np.float32),
                               rtol=1e-5, atol=1e-4)


def test_box_muller_tail_depth():
    """The 48-bit radial uniform reaches 8.24 sigma (test_mc_fused.py:62-80)."""
    zero = torch.zeros(4, dtype=torch.int64)
    full = torch.full((4,), 0xFFFFFFFF, dtype=torch.int64)
    z_deep, _ = mc_kernels.box_muller2(zero, zero, zero)
    np.testing.assert_allclose(z_deep.numpy(), np.sqrt(-2 * np.log(2.0**-49)),
                               rtol=1e-5)
    assert (z_deep > 8.2).all()
    z_mid, _ = mc_kernels.box_muller2(zero, full, zero)
    np.testing.assert_allclose(z_mid.numpy(), np.sqrt(-2 * np.log(2.0**-24)),
                               rtol=1e-4)
    z_top, _ = mc_kernels.box_muller2(full, full, zero)
    assert torch.isfinite(z_top).all() and (z_top.abs() > 0).all()


def test_box_muller2_statistics():
    rng = np.random.default_rng(2)
    raw = torch.from_numpy(rng.integers(0, 2**32, (3, 200_000), dtype=np.uint32))
    za, zb = mc_kernels.box_muller2(raw[0], raw[1], raw[2])
    for z in (za.numpy(), zb.numpy()):
        assert abs(z.mean()) < 0.01 and abs(z.std() - 1.0) < 0.01
        assert np.abs(z).max() < 8.25
    assert abs(np.corrcoef(za.numpy(), zb.numpy())[0, 1]) < 0.01


@pytest.mark.parametrize("ctr,key,expect", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, expect):
    """Philox4x32-10 against the known-answer vectors of Random123."""
    out = mc_kernels.philox4x32(*(torch.tensor([c], dtype=torch.int64) for c in ctr),
                                *key)
    assert tuple(int(v) for v in out) == expect


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_philox_raw_layout(mode):
    """Philox words land where the kernel reads them: column 2p's planes of
    pair p; mode 2's jam words of both columns; nothing else."""
    n, Z, B, key = 7 * 4, 4, 5, (11, 22)
    raw = mc_kernels.philox_raw(key, n, Z, B, mode, CPU)
    assert tuple(raw.shape) == (mc_kernels.DRAWS_PER_BIT[mode], n, B)
    r = raw.view(raw.shape[0], 7, Z, B)
    p, z, b = 2, 3, 4
    c = [torch.tensor([v], dtype=torch.int64) for v in (b, p * Z + z, 0, 0)]
    x = [int(v) for v in mc_kernels.philox4x32(*c, *key)]
    assert [int(r[d, 2 * p, z, b]) for d in range(3)] == x[:3]
    assert int(r[0, 2 * p + 1].abs().sum()) == 0  # odd columns use column 2p's
    if mode != 1:
        c[2] = c[2] + 1
        y = [int(v) for v in mc_kernels.philox4x32(*c, *key)]
        assert [int(r[3 + d, 2 * p, z, b]) for d in range(3)] == y[:3]
        if mode == 2:
            assert int(r[6, 2 * p, z, b]) == x[3]
            assert int(r[6, 2 * p + 1, z, b]) == y[3]


@pytest.mark.parametrize("name", ["wimax_576_0.5.alist.txt",
                                  "wimax_1152_0.5.alist.txt"])
def test_encoder_matches_reference(name):
    code = JCode(alist=jstd.make_builtin(name), name=name)
    spec = code.standard_encode_spec
    u = np.random.default_rng(4).integers(0, 2, (128, code.k), dtype=np.uint8)
    ref = np.asarray(jencode.make_encoder(spec, "orig")(jnp.asarray(u)))
    port = tencode.make_encoder(spec, "orig", CPU)(torch.from_numpy(u))
    assert port.dtype == torch.float32 and tuple(port.shape) == (128, code.n)
    np.testing.assert_array_equal(port.numpy(), ref.astype(np.float32))


@pytest.mark.parametrize("exact", [False, True])
def test_block_stats_match_reference(exact):
    from ldpc_tpu.ops.spa import DecodeResult as JResult
    from ldpc_tpu_torch.ops.spa import DecodeResult as TResult

    rng = np.random.default_rng(5)
    B, n, k = 64, 96, 40
    info = rng.permutation(n)[:k].astype(np.int64)
    u = rng.integers(0, 2, (B, k), dtype=np.uint8)
    est = rng.integers(0, 2, (B, n), dtype=np.uint8)
    est[:B // 2, info] = u[:B // 2]  # half the frames decode their bits
    ok = rng.random(B) < 0.6
    conv = np.where(ok, rng.integers(0, 9, B), -1).astype(np.int32)
    norm = rng.random(B).astype(np.float32)
    ref = jmetrics.block_stats(
        jnp.asarray(u), JResult(jnp.asarray(ok), jnp.asarray(est),
                                jnp.asarray(conv), jnp.asarray(norm),
                                jnp.int32(9)),
        jnp.asarray(info.astype(np.int32)), exact=exact)
    port = tmetrics.block_stats(
        torch.from_numpy(u), TResult(torch.from_numpy(ok), torch.from_numpy(est),
                                     torch.from_numpy(conv), torch.from_numpy(norm),
                                     torch.tensor(9)),
        torch.from_numpy(info), exact=exact)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert port.error_bits.dtype == torch.int32
