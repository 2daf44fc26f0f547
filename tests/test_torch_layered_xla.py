"""The port's layered QC decoder (``ldpc_tpu_torch.ops.layered``, the decoder
of ``--kernel xla --schedule layered``) against the JAX package's
``make_qc_layered_decoder`` on the same LLRs, and, for the min-sum family,
against the port's plain QC decoder (the CUDA kernel K3's plain version) in
the flattened paired order.

Tolerances: the min-sum family is equal bit for bit to both (est, ok,
conv_iter; iters_run and the normalized-LLR metric against JAX; that metric
within 1e-6 of the QC decoder, which divides the flip count by k where XLA
and this decoder multiply by 1/k); SPA gives equal decisions and counters
on these inputs (tanh and log differ by ulps between libraries).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.models import standards as jstd
from ldpc_tpu.models.code import LDPCCode as JCode
from ldpc_tpu.models.qc import paired_layer_groups
from ldpc_tpu.ops.layered import make_qc_layered_decoder as jlayered
from ldpc_tpu_torch.models import standards as tstd
from ldpc_tpu_torch.models.code import LDPCCode as TCode
from ldpc_tpu_torch.models.generate import qc_random
from ldpc_tpu_torch.ops.layered import make_qc_layered_decoder as tlayered
from ldpc_tpu_torch.ops.qc_kernels import QCDecoder
from ldpc_tpu_torch.sim.config import SimOptions
from ldpc_tpu_torch.sim.runner import PointExecutor, load_code

torch.set_num_threads(1)

W576 = "wimax_576_0.5.alist.txt"
CCSDS = "CCSDS_ldpc_n128_k64.alist.txt"  # multi-diagonal base rows
VARIANTS = ("spa", "minsum", "normalized_minsum", "offset_minsum")
B = 32


@pytest.fixture(scope="module")
def codes():
    """WiMAX 576, CCSDS n128 and a small random QC code (4 x 8 base graph,
    Z = 8, two disjoint row pairs), whose JAX decoder compiles fast."""
    out = {name: (JCode(alist=jstd.make_builtin(name), name=name),
                  TCode(alist=tstd.make_builtin(name), name=name))
           for name in (W576, CCSDS)}
    a = qc_random(4, 8, 8, 4, seed=1)
    out["qc32"] = (JCode(alist=a, name="qc32"), TCode(alist=a, name="qc32"))
    return out


def _llrs(code, seed, sigma=0.7):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (B, code.k), dtype=np.uint8)
    w = code.standard_encode_spec.encode_numpy(u, "orig").astype(np.float64)
    return (2.5 * ((2.0 * w - 1.0) + rng.normal(0, sigma, w.shape))) \
        .astype(np.float32)


def _order(qc, paired):
    if not paired:
        return None
    return [bi for g in paired_layer_groups(qc) for bi in g]


# the small code under every variant and both orders; CCSDS (multi-diagonal)
# serial; WiMAX 576 paired for normalized min-sum (each WiMAX compile of the
# JAX decoder takes about 7 s on one CPU core)
CASES = ([("qc32", p, v) for p in (False, True) for v in VARIANTS]
         + [(CCSDS, False, v) for v in VARIANTS]
         + [(W576, True, "normalized_minsum")])


@pytest.mark.parametrize("name,paired,variant", CASES)
def test_layered_decoder_matches_jax(codes, name, paired, variant):
    jcode, tcode = codes[name]
    llr = _llrs(jcode, seed=VARIANTS.index(variant) + 10 * paired)
    info = jcode.standard_encode_spec.info_pos("orig")
    order = _order(jcode.qc, paired)
    j = jlayered(jcode.qc, info, 8, variant, layer_order=order)(jnp.asarray(llr))
    t = tlayered(tcode.qc, info, 8, variant, layer_order=order,
                 device="cpu")(torch.from_numpy(llr))
    np.testing.assert_array_equal(t.est.numpy(), np.asarray(j.est))
    np.testing.assert_array_equal(t.ok.numpy(), np.asarray(j.ok))
    np.testing.assert_array_equal(t.conv_iter.numpy(), np.asarray(j.conv_iter))
    assert int(t.iters_run) == int(j.iters_run)
    if variant != "spa":
        np.testing.assert_array_equal(t.norm_llr.numpy(), np.asarray(j.norm_llr))


@pytest.mark.parametrize("alpha", [(0.6, 0.7, 0.8), ((0.6, 0.65), (0.7, 0.75))])
def test_alpha_schedules_match_jax(codes, alpha):
    """[T] on CCSDS n128 and [T, D] on WiMAX 576 (row degrees 6 and 7)."""
    jcode, tcode = codes[W576 if np.ndim(alpha) == 2 else CCSDS]
    llr = _llrs(jcode, seed=21)
    info = jcode.standard_encode_spec.info_pos("orig")
    j = jlayered(jcode.qc, info, 8, "normalized_minsum", alpha=alpha)(
        jnp.asarray(llr))
    t = tlayered(tcode.qc, info, 8, "normalized_minsum", alpha=alpha,
                 device="cpu")(torch.from_numpy(llr))
    np.testing.assert_array_equal(t.est.numpy(), np.asarray(j.est))
    np.testing.assert_array_equal(t.conv_iter.numpy(), np.asarray(j.conv_iter))
    assert int(t.iters_run) == int(j.iters_run)


@pytest.mark.parametrize("name", [W576, CCSDS, "qc32"])
@pytest.mark.parametrize("variant", ["minsum", "normalized_minsum",
                                     "offset_minsum"])
def test_layered_decoder_matches_the_qc_kernels_plain_version(codes, name,
                                                              variant):
    """Paired layers: the plain decoder in the flattened order equals the
    QC decoder (K3's plain version) on the paired groups."""
    _, tcode = codes[name]
    qc = tcode.qc
    groups = paired_layer_groups(qc)
    info = tcode.standard_encode_spec.info_pos("orig")
    llr = torch.from_numpy(_llrs(tcode, seed=31))
    t = tlayered(qc, info, 8, variant, layer_order=_order(qc, True),
                 device="cpu")(llr)
    q = QCDecoder(qc, info, 8, variant, schedule="layered",
                  layer_groups=groups, track_norm=True)(llr)
    assert torch.equal(t.est, q.est) and torch.equal(t.ok, q.ok)
    assert torch.equal(t.conv_iter, q.conv_iter)
    # the flip count over k: a product with 1/k here (as XLA), a division
    # in the QC decoder (as its kernel): within an ulp
    torch.testing.assert_close(t.norm_llr, q.norm_llr, rtol=0, atol=1e-6)
    assert bool(t.ok.any())


def test_layer_order_is_validated(codes):
    _, tcode = codes[W576]
    with pytest.raises(ValueError, match="permute"):
        tlayered(tcode.qc, [0], 4, "minsum", layer_order=[0, 0, 1],
                 device="cpu")


@pytest.mark.parametrize("layer_order,kind", [
    ("serial", "torch+layered"), ("paired", "torch+layered+paired")])
def test_kernel_xla_layered_routes_to_the_plain_decoder(layer_order, kind):
    """``--kernel xla --schedule layered`` takes the layered plain decoder
    with the JAX runner's ``kernel_used`` suffixes, and counts frames."""
    name = f"builtin:{W576}"
    opts = SimOptions(matrix=name, fidelity="exact", kernel="xla",
                      schedule="layered", layer_order=layer_order, batch=64,
                      iterations=6, quiet=True, decoder="normalized-minsum")
    ex = PointExecutor(load_code(name), opts, device="cpu")
    assert not ex.fused and ex.kernel_used == kind
    stats = ex.run_point(2.5, 128)
    assert stats.blocks == 128 and stats.ok_blocks > 0
