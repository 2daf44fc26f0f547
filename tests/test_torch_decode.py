"""The plain decode loop of the port against the JAX package's layered
decoder (ldpc_tpu.ops.layered, jnp) on the same channel LLRs."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.models import standards as jstd
from ldpc_tpu.models.code import LDPCCode as JCode
from ldpc_tpu.models.qc import paired_layer_groups
from ldpc_tpu.ops.layered import _check_update_list, make_qc_layered_decoder
from ldpc_tpu_torch.ops.decode_loop import DecodeLoop, build_tables

torch.set_num_threads(1)

NAME = "wimax_576_0.5.alist.txt"
B = 256


@pytest.fixture(scope="module")
def setup():
    """Codewords through BPSK + AWGN at Eb/N0 1.5 dB (rate 1/2): a mix of
    frames that converge early, late and never. LLRs in the channel
    convention (LLR > 0 <=> bit 1), f32 [B, n]."""
    code = JCode(alist=jstd.make_builtin(NAME), name=NAME)
    spec = code.standard_encode_spec
    rng = np.random.default_rng(7)
    u = rng.integers(0, 2, (B, code.k), dtype=np.uint8)
    w = spec.encode_numpy(u, "orig").astype(np.float32)
    sigma = 1.0 / np.sqrt(2 * 0.5 * 10 ** 0.15)
    y = (2 * w - 1) + sigma * rng.standard_normal(w.shape)
    llr = (2 * y / sigma**2).astype(np.float32)
    groups = paired_layer_groups(code.qc)
    return code, u, llr, groups


def _port(code, llr, groups, iters, variant, check_every=1):
    loop = DecodeLoop(build_tables(code.qc, groups), iters, variant,
                      check_every=check_every, lanes=128)
    L = torch.from_numpy(-llr.T.copy())
    done, conv, it = loop.run(L, torch.zeros(llr.shape[0], dtype=torch.bool))
    return done.numpy(), conv.numpy(), (L < 0).numpy().T.astype(np.uint8), it


def _ref(code, llr, groups, iters, variant):
    dec = make_qc_layered_decoder(
        code.qc, code.standard_encode_spec.info_pos("orig"), iters, variant,
        layer_order=[bi for g in groups for bi in g])
    res = dec(jnp.asarray(llr))
    return (np.asarray(res.ok), np.asarray(res.conv_iter),
            np.asarray(res.est), int(res.iters_run))


@pytest.mark.parametrize("variant", ["normalized_minsum", "minsum",
                                     "offset_minsum"])
def test_minsum_family_bit_exact(setup, variant):
    code, u, llr, groups = setup
    ok, conv, est, it = _port(code, llr, groups, 8, variant)
    r_ok, r_conv, r_est, r_it = _ref(code, llr, groups, 8, variant)
    np.testing.assert_array_equal(ok, r_ok)
    np.testing.assert_array_equal(conv, r_conv)
    np.testing.assert_array_equal(est, r_est)
    assert int(it.max()) == r_it  # one 256-lane batch = the jnp loop's trips
    assert 0 < ok.sum() < B  # the point exercises both outcomes


def test_spa_one_sweep_posteriors(setup):
    """One SPA sweep in the paired order: the port's posteriors against a
    sweep built from the JAX package's check update. XLA's and torch's tanh
    differ by a few ulp, so the bar is relative."""
    code, _, llr, groups = setup
    qc = code.qc
    Z = qc.Z
    rows = qc.row_slots()
    L = jnp.asarray(-llr.reshape(B, qc.nb, Z))
    E = {}
    for bi in [bi for g in groups for bi in g]:
        msgs = [jnp.roll(L[:, bj], -s, axis=-1) - E.get((bi, j), 0.0)
                for j, (bj, s) in enumerate(rows[bi])]
        e_new = _check_update_list(msgs, "spa", 0.75, 0.15)
        for j, (bj, s) in enumerate(rows[bi]):
            L = L.at[:, bj].set(jnp.roll(msgs[j] + e_new[j], s, axis=-1))
            E[(bi, j)] = e_new[j]
    ref = np.asarray(L, np.float32).reshape(B, qc.n).T

    loop = DecodeLoop(build_tables(qc, groups), 1, "spa")
    Lt = torch.from_numpy(-llr.T.copy())
    Et = torch.zeros((loop.tables.e_slots, Z, B))
    loop.sweep(Lt, Et, torch.ones(B, dtype=torch.bool))
    np.testing.assert_allclose(Lt.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_spa_full_decode_agrees(setup):
    """SPA cannot be bit-exact across tanh implementations: per-frame ok,
    conv and info-bit errors must agree on at least 99% of frames."""
    code, u, llr, groups = setup
    info = code.standard_encode_spec.info_pos("orig")
    ok, conv, est, _ = _port(code, llr, groups, 8, "spa")
    r_ok, r_conv, r_est, _ = _ref(code, llr, groups, 8, "spa")
    err = (est[:, info] != u).sum(1)
    r_err = (r_est[:, info] != u).sum(1)
    same = (ok == r_ok) & (conv == r_conv) & (err == r_err)
    bad = np.nonzero(~same)[0]
    assert same.mean() >= 0.99, (
        f"frames differing: {bad.tolist()} ok {ok[bad]} vs {r_ok[bad]}, "
        f"conv {conv[bad]} vs {r_conv[bad]}, err {err[bad]} vs {r_err[bad]}")
    assert 0 < ok.sum() < B


def test_check_every_freezes_at_window_ends(setup):
    """check_every=2: conv reports the window's last sweep, lanes converge
    no earlier than at check_every=1, and iters advance in whole windows."""
    code, _, llr, groups = setup
    ok1, conv1, _, _ = _port(code, llr, groups, 8, "normalized_minsum")
    ok2, conv2, _, it2 = _port(code, llr, groups, 8, "normalized_minsum", 2)
    assert ((conv2[ok2] % 2) == 1).all()
    both = ok1 & ok2
    assert (conv2[both] >= conv1[both]).all()
    assert ((it2.numpy() % 2) == 0).all()
