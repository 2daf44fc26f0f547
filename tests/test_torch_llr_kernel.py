"""The LLR decoder's plain version (phase 2) against the JAX package's
interpret-mode ``mc_pallas.make_llr_decoder`` on the same LLRs and pre-done
mask: check every 2 sweeps, paired layers, and the additive update of
multi-diagonal layers (CCSDS)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.models import standards as jstd
from ldpc_tpu.models.code import LDPCCode as JCode
from ldpc_tpu.models.qc import paired_layer_groups
from ldpc_tpu.ops.mc_pallas import make_llr_decoder
from ldpc_tpu_torch.ops.mc_kernels import LLRDecoder
from ldpc_tpu_torch.utils.carry import code_from_numpy

torch.set_num_threads(1)

ITU = "LDPC_N336_K196_ITU_G.h.alist.txt"
CCSDS = "CCSDS_ldpc_n32_k16.alist.txt"
B = 128


def _inputs(code, ebno_db: float, seed: int):
    """Sent words and their channel LLRs in the decode domain (log p0/p1),
    BPSK + AWGN at ``ebno_db`` for the code's rate, f32 [n, B]."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (B, code.k), dtype=np.uint8)
    w = code.standard_encode_spec.encode_numpy(u, "orig").astype(np.float32)
    sigma = 1.0 / np.sqrt(2 * code.k / code.n * 10 ** (ebno_db / 10))
    y = (2 * w - 1) + sigma * rng.standard_normal(w.shape)
    llr = (-2 * y / sigma**2).astype(np.float32)
    done0 = (rng.random(B) < 0.3).astype(np.float32)
    return u, np.ascontiguousarray(w.T), np.ascontiguousarray(llr.T), done0


def _both(name, variant, iters, ebno_db, seed, paired=True, check_every=2):
    ref_code = JCode(alist=jstd.make_builtin(name), name=name)
    code = code_from_numpy(ref_code.n, ref_code.m, ref_code.H.row_idx,
                           ref_code.H.col_idx, name)
    groups = paired_layer_groups(ref_code.qc) if paired else None
    info = ref_code.standard_encode_spec.info_pos("orig")
    _, wT, llrT, done0 = _inputs(ref_code, ebno_db, seed)
    dec = make_llr_decoder(ref_code.qc, info, iters, variant,
                           schedule="layered", interpret=True,
                           track_norm=False, layer_groups=groups,
                           check_every=check_every)
    ref = jax.jit(dec)(jnp.asarray(llrT), jnp.asarray(wT), jnp.asarray(done0))
    ref = [np.asarray(x) for x in ref]
    port = LLRDecoder(code.qc, code.standard_encode_spec.info_pos("orig"),
                      iters, variant, layer_groups=groups,
                      check_every=check_every)
    out = port(torch.from_numpy(llrT), torch.from_numpy(wT),
               torch.from_numpy(done0))
    out = [x.numpy() for x in out]
    return ref, out, done0 < 0.5


def test_minsum_ce2_pre_done_exact_on_active_lanes():
    ref, out, live = _both(ITU, "normalized_minsum", 12, 2.0, 1)
    for name, i in (("err", 0), ("ok", 1), ("conv", 2)):
        np.testing.assert_array_equal(out[i][live], ref[i][live], err_msg=name)
    ok = out[1][live]
    assert 0 < ok.sum() < ok.size  # the point exercises both outcomes
    assert ((out[2][live & out[1]] % 2) == 1).all()  # window-end check iters
    # pre-done lanes are placeholders: done, no errors, no convergence
    assert out[1][~live].all() and (out[0][~live] == 0).all()
    assert (out[2][~live] == -1).all()


def test_spa_ce2_pre_done_agrees_on_active_lanes():
    """SPA: XLA's CPU tanh and torch's differ by a few ulp, so per-frame
    results agree on >= 99% of the live frames, not bit for bit."""
    ref, out, live = _both(ITU, "spa", 12, 1.5, 2)
    same = ((out[0] == ref[0]) & (out[1] == ref[1]) & (out[2] == ref[2]))[live]
    bad = np.nonzero(~same)[0]
    assert same.mean() >= 0.99, (
        f"live frames differing: {bad.tolist()}, ok {out[1][live][bad]} vs "
        f"{ref[1][live][bad]}, conv {out[2][live][bad]} vs {ref[2][live][bad]}")
    assert 0 < out[1][live].sum() < live.sum()


def test_multi_diagonal_additive_update_exact():
    """CCSDS n32: every base row holds one base column twice, so every layer
    takes the additive update L += roll(E_new - E_old)."""
    ref, out, live = _both(CCSDS, "normalized_minsum", 8, 3.0, 3,
                           paired=False, check_every=1)
    for name, i in (("err", 0), ("ok", 1), ("conv", 2)):
        np.testing.assert_array_equal(out[i][live], ref[i][live], err_msg=name)
    assert 0 < out[1][live].sum() < live.sum()


def test_multi_diagonal_tables():
    from ldpc_tpu_torch.ops.decode_loop import build_tables
    from ldpc_tpu_torch.ops.mc_kernels import fused_plan, gather_words, table_len

    ref_code = JCode(alist=jstd.make_builtin(CCSDS), name=CCSDS)
    code = code_from_numpy(ref_code.n, ref_code.m, ref_code.H.row_idx,
                           ref_code.H.col_idx, CCSDS)
    t = build_tables(code.qc)
    assert t.has_dup and t.row_dup.all() and t.R == 1 and t.dmax == 8
    # the delta scratch of multi-diagonal rows is part of the layered
    # block's plan (K1, K2 and K3 layered), not of the flooding one (K3)
    qc = code.qc
    per_lane = qc.n + t.e_slots * qc.Z + t.R * 8 * qc.Z
    plan = fused_plan(t)
    assert plan.smem > 4 * plan.lanes * per_lane
    flood = fused_plan(t, flood=True)
    assert flood.smem == 4 * (flood.lanes * (flood.l_stride + t.e_slots * qc.Z)
                              + table_len(t, True) + gather_words(t))
    with pytest.raises(ValueError, match="disjoint"):
        build_tables(code.qc, [[0, 1], [2], [3]])
