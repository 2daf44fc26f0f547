"""The GF(2) encode (``ops.encode``) on the CPU: its plain version, the f32
matrix product mod 2, against the JAX package's encoder, bit for bit, in
both layouts; every codeword in the kernel of H; K8's word table, and its
packed arithmetic worked in numpy, against the plain version; and the
wrapper's refusals."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.models import standards as jstd
from ldpc_tpu.models.code import LDPCCode as JCode
from ldpc_tpu.ops import encode as jencode
from ldpc_tpu_torch.models import standards as tstd
from ldpc_tpu_torch.models.code import LDPCCode as TCode
from ldpc_tpu_torch.ops import build
from ldpc_tpu_torch.ops.encode import (
    ENCODE,
    TILE,
    GF2Encoder,
    generator_T,
    generator_words,
    make_encoder,
    make_encoder_T,
)

torch.set_num_threads(1)

B = 67  # a ragged batch
# WiMAX (576, 288) and (1152, 576), CCSDS (128, 64), ITU-T G.hn (336, 168):
# its k of 168 (the name says 196) is not a multiple of 32
CODES = ("wimax_576_0.5.alist.txt", "wimax_1152_0.5.alist.txt",
         "CCSDS_ldpc_n128_k64.alist.txt", "LDPC_N336_K196_ITU_G.h.alist.txt")
_CACHE: dict[str, tuple] = {}


def _codes(name: str):
    if name not in _CACHE:
        _CACHE[name] = (JCode(alist=jstd.make_builtin(name), name=name),
                        TCode(alist=tstd.make_builtin(name), name=name))
    return _CACHE[name]


def _packed(words: np.ndarray, u: np.ndarray, n: int) -> np.ndarray:
    """K8's arithmetic in numpy: a frame's bits as little-endian words, the
    XOR over words of ``info word & column word``, the parity of its
    popcount. f32 [B, n]."""
    B, k = u.shape
    bits = np.zeros((B, 32 * words.shape[0]), np.uint8)
    bits[:, :k] = u & 1
    uw = np.packbits(bits, axis=1, bitorder="little").view("<u4")
    acc = np.bitwise_xor.reduce(uw[:, :, None] & words[None], axis=1)
    return (np.bitwise_count(acc[:, :n]) & 1).astype(np.float32)


@pytest.mark.parametrize("frames_minor", [True, False])
@pytest.mark.parametrize("graph", ["orig", "std"])
@pytest.mark.parametrize("name", CODES)
def test_plain_encode_equals_jax(name, graph, frames_minor):
    jc, tc = _codes(name)
    spec = tc.standard_encode_spec
    u = np.random.default_rng(7).integers(0, 2, (B, tc.k), dtype=np.uint8)
    make = make_encoder_T if frames_minor else make_encoder
    jmake = jencode.make_encoder_T if frames_minor else jencode.make_encoder
    got = make(spec, graph, "cpu")(torch.from_numpy(u))
    want_shape = (tc.n, B) if frames_minor else (B, tc.n)
    assert got.dtype == torch.float32 and tuple(got.shape) == want_shape
    assert got.is_contiguous()
    got = got.numpy()
    w = got.T if frames_minor else got  # [B, n]
    ref = np.asarray(jmake(jc.standard_encode_spec, graph)(jnp.asarray(u)))
    np.testing.assert_array_equal(got, ref.astype(np.float32))
    syndrome = tc.syndrome_orig if graph == "orig" else tc.syndrome_std
    assert not syndrome(w.T.astype(np.uint8)).any()
    np.testing.assert_array_equal(w[:, spec.info_pos(graph)], u)


@pytest.mark.parametrize("frames_minor", [True, False])
def test_only_the_low_bit_of_a_byte_counts(frames_minor):
    """Bytes other than 0 / 1 encode as their low bits, in the plain
    version as in K8's packing."""
    _, tc = _codes(CODES[0])
    spec = tc.standard_encode_spec
    u = np.random.default_rng(8).integers(0, 256, (B, tc.k), dtype=np.uint8)
    enc = GF2Encoder(spec, "orig", "cpu", frames_minor=frames_minor)
    got = enc(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(
        got, enc(torch.from_numpy(u & 1)).numpy())
    want = _packed(generator_words(generator_T(spec, "orig")), u, tc.n)
    np.testing.assert_array_equal(got, want.T if frames_minor else want)


@pytest.mark.parametrize("name", CODES)
def test_word_table_holds_the_generator(name):
    """Bit b of word w of column j is the generator's entry of info bit
    32 w + b; the padding past k and n is zero."""
    _, tc = _codes(name)
    spec = tc.standard_encode_spec
    words = generator_words(generator_T(spec, "orig"))
    words_n = -(-tc.k // 32)
    assert words.dtype == np.uint32
    assert words.shape == (words_n, -(-tc.n // TILE) * TILE)
    bits = (words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    bits = bits.transpose(1, 0, 2).reshape(words.shape[1], 32 * words_n)
    np.testing.assert_array_equal(bits[:tc.n, :tc.k],
                                  generator_T(spec, "orig").astype(np.uint32))
    assert not bits[tc.n:].any() and not bits[:, tc.k:].any()


@pytest.mark.parametrize("graph", ["orig", "std"])
@pytest.mark.parametrize("name", CODES)
def test_packed_words_encode_as_the_plain_version(name, graph):
    """K8's arithmetic on its word table, worked in numpy, gives the plain
    version's codewords bit for bit."""
    _, tc = _codes(name)
    spec = tc.standard_encode_spec
    u = np.random.default_rng(9).integers(0, 2, (B, tc.k), dtype=np.uint8)
    want = make_encoder(spec, graph, "cpu")(torch.from_numpy(u)).numpy()
    got = _packed(generator_words(generator_T(spec, graph)), u, tc.n)
    np.testing.assert_array_equal(got, want)


def test_the_cpu_path_loads_no_library():
    _, tc = _codes(CODES[2])
    loaded, launched = set(build._LIBS), ENCODE.launches
    u = torch.zeros((B, tc.k), dtype=torch.uint8)
    make_encoder_T(tc.standard_encode_spec, "orig", "cpu")(u)
    assert set(build._LIBS) == loaded and ENCODE.launches == launched


def _call(fault):
    _, tc = _codes(CODES[2])
    enc = make_encoder(tc.standard_encode_spec, "orig", "cpu")
    args = dict(enc=enc, u=torch.zeros((B, tc.k), dtype=torch.uint8),
                call=enc)
    fault(args)
    args["call"](args["u"])


_FAULTS = {
    "dtype int64": (lambda a: a.update(u=a["u"].long()), "u has dtype"),
    "dtype float32": (lambda a: a.update(u=a["u"].float()), "u has dtype"),
    "dtype bool": (lambda a: a.update(u=a["u"].bool()), "u has dtype"),
    "rank 1": (lambda a: a.update(u=a["u"][0]), "u has shape"),
    "k + 1": (lambda a: a.update(u=torch.zeros((B, 65), dtype=torch.uint8)),
              "u has shape"),
    "no frame": (lambda a: a.update(u=a["u"][:0]), "u has shape"),
    "strided rows": (lambda a: a.update(
        u=torch.stack([a["u"], a["u"]], dim=2)[..., 0]),
        "u must be contiguous"),
    "device meta": (lambda a: a.update(u=a["u"].to("meta")),
                    "no kernel for device meta"),
    "plain on another device": (lambda a: a.update(
        u=a["u"].to("meta"), call=a["enc"].plain), "u is on meta"),
    "launch on cpu": (lambda a: a.update(call=a["enc"].launch),
                      "no kernel for device cpu"),
}


@pytest.mark.parametrize("case", list(_FAULTS))
def test_refusals(case):
    """The wrapper hands K8 raw pointers, so it refuses, before any launch,
    each tensor the kernel would misread, and a device without the
    kernel."""
    fault, match = _FAULTS[case]
    with pytest.raises(ValueError, match=match):
        _call(fault)


def test_no_encoder_on_a_device_without_the_kernel():
    _, tc = _codes(CODES[2])
    with pytest.raises(ValueError, match="no encoder for device meta"):
        make_encoder_T(tc.standard_encode_spec, "orig", "meta")
