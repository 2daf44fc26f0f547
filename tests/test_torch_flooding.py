"""The plain flooding decode loop of the port (through ``QCDecoder`` on the
CPU) against the JAX package's XLA decoder ``spa.make_decoder`` with the
exact rule, which ``tests/test_pallas.py`` holds bit-identical to the
flooding Pallas kernel: decisions, ok, convergence iteration and the
normalized-LLR metric on the same channel LLRs."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.models import standards as jstd
from ldpc_tpu.models.code import LDPCCode as JCode
from ldpc_tpu.ops.spa import make_decoder
from ldpc_tpu_torch.ops.qc_kernels import QCDecoder
from ldpc_tpu_torch.utils.carry import code_from_numpy

torch.set_num_threads(1)

WIMAX = "wimax_576_0.5.alist.txt"
CCSDS = "CCSDS_ldpc_n32_k16.alist.txt"  # two circulants in one base column
B = 256
ITERS = 10


def _case(name: str, ebno_db: float, seed: int):
    """Channel LLRs (LLR > 0 <=> bit 1, f32 [B, n]) of BPSK + AWGN at
    ``ebno_db`` for the code's rate: a mix of frames that converge early,
    late and never."""
    ref = JCode(alist=jstd.make_builtin(name), name=name)
    port = code_from_numpy(ref.n, ref.m, ref.H.row_idx, ref.H.col_idx, name)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (B, ref.k), dtype=np.uint8)
    w = ref.standard_encode_spec.encode_numpy(u, "orig").astype(np.float64)
    sigma = 1.0 / np.sqrt(2 * ref.k / ref.n * 10 ** (ebno_db / 10))
    y = (2 * w - 1) + sigma * rng.standard_normal(w.shape)
    llr = (2 * y / sigma**2).astype(np.float32)
    return ref, port, llr


def _both(name, variant, ebno_db, seed):
    ref, port, llr = _case(name, ebno_db, seed)
    info = ref.standard_encode_spec.info_pos("orig")
    r = make_decoder(ref.layout("orig"), info, ITERS, variant,
                     rule="exact")(jnp.asarray(llr))
    dec = QCDecoder(port.qc, port.standard_encode_spec.info_pos("orig"), ITERS,
                    variant, schedule="flooding", track_norm=True)
    o = dec(torch.from_numpy(llr))
    return ([np.asarray(x) for x in (r.est, r.ok, r.conv_iter, r.norm_llr)],
            [x.numpy() for x in (o.est, o.ok, o.conv_iter, o.norm_llr)],
            (int(r.iters_run), int(o.iters_run)))


@pytest.mark.parametrize("name,ebno", [(WIMAX, 1.5), (CCSDS, 3.0)])
@pytest.mark.parametrize("variant", ["normalized_minsum", "minsum"])
def test_flooding_minsum_exact(name, ebno, variant):
    ref, port, (r_it, p_it) = _both(name, variant, ebno, 7)
    for what, i in (("est", 0), ("ok", 1), ("conv", 2)):
        np.testing.assert_array_equal(port[i], ref[i], err_msg=what)
    # XLA divides the flip count by k as a product with 1/k: <= 1 ulp
    np.testing.assert_allclose(port[3], ref[3], rtol=0, atol=1e-6)
    assert p_it == r_it
    assert 0 < port[1].sum() < B  # the point exercises both outcomes
    assert (port[3] > 0).any()


def test_flooding_spa_agrees():
    """SPA: XLA's CPU tanh and torch's may differ by an ulp, so ok and conv
    must agree on at least 99% of frames (mismatches listed)."""
    ref, port, _ = _both(WIMAX, "spa", 1.5, 8)
    same = (port[1] == ref[1]) & (port[2] == ref[2])
    bad = np.nonzero(~same)[0]
    assert same.mean() >= 0.99, (
        f"frames differing: {bad.tolist()}, ok {port[1][bad]} vs {ref[1][bad]}, "
        f"conv {port[2][bad]} vs {ref[2][bad]}")
    assert 0 < port[1].sum() < B


def test_track_norm_changes_nothing_else():
    _, port, llr = _case(WIMAX, 1.5, 9)
    info = port.standard_encode_spec.info_pos("orig")
    x = torch.from_numpy(llr)
    on = QCDecoder(port.qc, info, ITERS, "spa", track_norm=True)(x)
    off = QCDecoder(port.qc, info, ITERS, "spa", track_norm=False)(x)
    for a, b in zip(on[:3], off[:3]):
        assert torch.equal(a, b)
    assert (off.norm_llr == 0).all() and (on.norm_llr > 0).any()
