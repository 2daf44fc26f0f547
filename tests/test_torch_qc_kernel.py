"""The standalone QC decoder's plain version (``QCDecoder`` on the CPU)
against the JAX package: the interpret-mode ``spa_pallas.make_qc_decoder``
for what only the kernel has (paired layers with a syndrome check every two
sweeps, and ``skip``) and for the plain loop at the kernel's block (one
codeword, or the codewords that share a warp) under both schedules with the
flip metric, the jnp layered decoder for the layered schedule with the flip
metric, and the kernel's block plans."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.models import standards as jstd
from ldpc_tpu.models.code import LDPCCode as JCode
from ldpc_tpu.models.qc import paired_layer_groups
from ldpc_tpu.ops.layered import make_qc_layered_decoder
from ldpc_tpu.ops.spa_pallas import make_qc_decoder
from ldpc_tpu_torch.ops import mc_kernels as mk
from ldpc_tpu_torch.ops.decode_loop import block_max_trips, build_tables
from ldpc_tpu_torch.ops.mc_kernels import fused_plan
from ldpc_tpu_torch.ops.qc_kernels import QCDecoder
from ldpc_tpu_torch.utils.carry import code_from_numpy

torch.set_num_threads(1)

ITU = "LDPC_N336_K196_ITU_G.h.alist.txt"
WIMAX = "wimax_576_0.5.alist.txt"
B = 128


def _case(name: str, ebno_db: float, seed: int, batch: int = B):
    ref = JCode(alist=jstd.make_builtin(name), name=name)
    port = code_from_numpy(ref.n, ref.m, ref.H.row_idx, ref.H.col_idx, name)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, ref.k), dtype=np.uint8)
    w = ref.standard_encode_spec.encode_numpy(u, "orig").astype(np.float64)
    sigma = 1.0 / np.sqrt(2 * ref.k / ref.n * 10 ** (ebno_db / 10))
    llr = (2 * ((2 * w - 1) + sigma * rng.standard_normal(w.shape))
           / sigma**2).astype(np.float32)
    return ref, port, llr


def _np(res):
    return [np.asarray(x) for x in (res.est, res.ok, res.conv_iter,
                                    res.norm_llr)] + [int(res.iters_run)]


def test_paired_ce2_and_skip_match_the_interpret_mode_kernel():
    ref, port, llr = _case(ITU, 2.0, 1)
    groups = paired_layer_groups(ref.qc)
    info = ref.standard_encode_spec.info_pos("orig")
    kw = dict(schedule="layered", track_norm=False, layer_groups=groups,
              check_every=2)
    jdec = jax.jit(make_qc_decoder(ref.qc, info, 12, "minsum",
                                   interpret=True, **kw))
    tdec = QCDecoder(port.qc, port.standard_encode_spec.info_pos("orig"), 12,
                     "minsum", **kw)
    x = torch.from_numpy(llr)
    for skip in (0, 1):
        r = _np(jdec(jnp.asarray(llr), jnp.int32(skip)))
        o = _np(tdec(x, skip=skip))
        for what, a, b in zip(("est", "ok", "conv", "norm", "iters"), o, r):
            np.testing.assert_array_equal(a, b, err_msg=f"{what} skip={skip}")
        if skip:
            # every lane pre-marked done: no sweep, decisions from the LLRs
            assert o[4] == 0 and o[1].all() and (o[2] == -1).all()
            np.testing.assert_array_equal(o[0], (llr > 0).astype(np.uint8))
        else:
            assert 0 < o[1].sum() < B and ((o[2][o[1]] % 2) == 1).all()


@pytest.mark.parametrize("variant", ["normalized_minsum", "offset_minsum"])
def test_layered_with_flip_metric_matches_reference(variant):
    """The layered sweep against the jnp layered decoder, with the
    normalized-LLR metric (not part of the fused kernels) on."""
    ref, port, llr = _case(WIMAX, 1.5, 2)
    info = ref.standard_encode_spec.info_pos("orig")
    r = _np(make_qc_layered_decoder(ref.qc, info, 8, variant)(jnp.asarray(llr)))
    o = _np(QCDecoder(port.qc, port.standard_encode_spec.info_pos("orig"), 8,
                      variant, schedule="layered", track_norm=True)(
        torch.from_numpy(llr)))
    for what, i in (("est", 0), ("ok", 1), ("conv", 2), ("iters", 4)):
        np.testing.assert_array_equal(o[i], r[i], err_msg=what)
    np.testing.assert_allclose(o[3], r[3], rtol=0, atol=1e-6)
    assert 0 < o[1].sum() < B and (o[3] > 0).any()


def test_block_plans_and_options():
    code = code_from_numpy(*_dims("wimax_1152_0.5.alist.txt"))
    t = build_tables(code.qc)
    # one codeword per block: flooding's 2 rows per step, serial's 1 (48 of
    # 64 threads); the channel LLRs stay in device memory, so flooding adds
    # only its column tables and drops the layer groups
    flood, serial = fused_plan(t, flood=True), fused_plan(t)
    assert (flood.lanes, flood.rows, flood.threads) == (1, 2, 96)
    assert (serial.lanes, serial.rows, serial.threads) == (1, 1, 64)
    assert flood.smem - serial.smem == \
        4 * ((code.qc.nb + 1) + 2 * t.e_slots - len(t.groups) * 2)
    info = code.standard_encode_spec.info_pos("orig")
    with pytest.raises(ValueError, match="track_norm"):
        QCDecoder(code.qc, info, 12, "spa", schedule="layered", check_every=2)
    with pytest.raises(ValueError, match="layer_groups"):
        QCDecoder(code.qc, info, 12, "spa", layer_groups=[[0]])
    # int8 extrinsics are the min-sum family's (the JAX kernels' refusals)
    with pytest.raises(ValueError, match="min-sum variant"):
        QCDecoder(code.qc, info, 12, "spa", msg_store="int8")
    with pytest.raises(ValueError, match="'f32' or 'int8'"):
        QCDecoder(code.qc, info, 12, "minsum", msg_store="int4")
    assert QCDecoder(code.qc, info, 12, "minsum", msg_store="int8").plan.int8
    dec = QCDecoder(code.qc, info, 4, "spa", track_norm=False)
    x = torch.zeros((code.n, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        dec(x)
    empty = dec(torch.zeros((0, code.n)))
    assert tuple(empty.est.shape) == (0, code.n) and int(empty.iters_run) == 0


def test_big_codes_fit_or_raise_with_their_bytes():
    import os

    from ldpc_tpu_torch.models.alist import read_alist
    from ldpc_tpu_torch.models.qc import detect_qc

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # (threads, bytes): L + E + the gather offsets + the tables of one
    # codeword; the n=9216 flooding block is 208.4 KB of the 225 KB limit
    for name, flood_plan in (("wimax_like_n4608_z192.alist.txt", (384, 107400)),
                             ("wimax_like_n9216_z384.alist.txt", (768, 213384))):
        qc = detect_qc(read_alist(os.path.join(root, "examples", "big_code",
                                               name)))
        p = fused_plan(build_tables(qc), flood=True)
        assert (p.lanes, p.rows) == (1, 2)
        assert (p.threads, p.smem) == flood_plan
    huge = code_from_numpy(*_dims("wimax_2304_0.5.alist.txt"))
    t = build_tables(huge.qc)
    need = fused_plan(t, flood=True).smem
    limit = mk._SMEM_LIMIT
    try:
        mk._SMEM_LIMIT = need - 1
        with pytest.raises(ValueError, match=rf"{need} bytes of shared memory"):
            fused_plan(t, flood=True)
    finally:
        mk._SMEM_LIMIT = limit


# the plain loop at the kernel's block against the interpret-mode kernel:
# (code, schedule, layer order, variant, iterations, check every,
# track_norm, Eb/N0 dB); WiMAX 576 is one codeword per block (64 threads),
# CCSDS n32 4 (flooding) or 8 (layered) codewords sharing one warp
AT_PLAN = [
    (WIMAX, "flooding", "serial", "normalized_minsum", 10, 1, True, 1.5),
    (WIMAX, "flooding", "serial", "spa", 10, 1, True, 1.5),
    ("CCSDS_ldpc_n32_k16.alist.txt", "flooding", "serial", "minsum", 10, 1,
     True, 3.0),
    (WIMAX, "layered", "paired", "normalized_minsum", 12, 2, False, 1.5),
    (WIMAX, "layered", "paired", "spa", 12, 2, False, 1.5),
]


@pytest.mark.parametrize(
    "name,schedule,order,variant,iters,ce,norm,ebno", AT_PLAN,
    ids=[f"{c[0][:6]}-{c[1]}-{c[3]}" for c in AT_PLAN])
def test_plain_loop_at_the_kernels_block(name, schedule, order, variant,
                                         iters, ce, norm, ebno):
    """est, ok and conv of every frame equal the interpret-mode kernel's
    (SPA: on >= 99% of frames, tanh and log differ by ulps between
    libraries), norm within 1e-6, and each frame's ``iters`` is its block's
    trips: at one codeword per block its own."""
    ref, port, llr = _case(name, ebno, 5, batch=64)
    info = ref.standard_encode_spec.info_pos("orig")
    kw = dict(schedule=schedule, track_norm=norm, check_every=ce,
              layer_groups=paired_layer_groups(ref.qc) if order == "paired"
              else None)
    r = _np(jax.jit(make_qc_decoder(ref.qc, info, iters, variant,
                                    interpret=True, **kw))(jnp.asarray(llr)))
    dec = QCDecoder(port.qc, port.standard_encode_spec.info_pos("orig"), iters,
                    variant, **kw)
    est, ok, conv, nrm, it = (x.numpy() for x in dec.outputs(torch.from_numpy(llr)))
    same = (est == r[0]).all(axis=1) & (ok == r[1]) & (conv == r[2])
    if variant == "spa":
        assert same.mean() >= 0.99, np.nonzero(~same)[0].tolist()
    else:
        assert same.all(), np.nonzero(~same)[0].tolist()
    np.testing.assert_allclose(nrm[same], r[3][same], rtol=0, atol=1e-6)
    if norm:
        assert (nrm > 0).any()
    own = np.where(ok, conv + 1, iters)
    want = block_max_trips(torch.from_numpy(ok), torch.from_numpy(conv),
                           dec.lanes, iters).numpy()
    np.testing.assert_array_equal(it, want)
    if dec.lanes == 1:
        np.testing.assert_array_equal(it, own)
    assert int(it.max()) == r[4]
    assert 0 < ok.sum() < len(ok)


def _dims(name):
    ref = JCode(alist=jstd.make_builtin(name), name=name)
    return ref.n, ref.m, ref.H.row_idx, ref.H.col_idx, name
