"""The port's flooding decoder on EdgeLayout and bit-flipping
(``ldpc_tpu_torch.ops.spa``) against the JAX package's ``make_decoder`` /
``make_bitflip_decoder`` on the same LLRs, and the unfused path's routing to
them.

Tolerances: the min-sum family and bit-flipping are equal bit for bit
(est, ok, conv_iter, iters_run and the normalized-LLR metric; the ops are
min, sign, one multiply and adds in the order XLA runs them, and the flip
count over k a product with 1/k as XLA computes it); SPA, whose tanh,
log and cumprod differ by ulps between the libraries, gives equal decisions
and counters on these inputs. The float64 decoder equals
``tests/reference_spa.py`` as the JAX package's own test holds it.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.models import standards as jstd
from ldpc_tpu.models.code import LDPCCode as JCode
from ldpc_tpu.ops import spa as jspa
from ldpc_tpu_torch.models.generate import gallager_regular
from ldpc_tpu_torch.ops import spa as tspa
from ldpc_tpu_torch.sim.config import SimOptions
from ldpc_tpu_torch.sim.runner import PointExecutor, load_code
from ldpc_tpu_torch.utils.carry import code_from_numpy

from reference_spa import decode_reference

torch.set_num_threads(1)

W576 = "wimax_576_0.5.alist.txt"
VARIANTS = ("spa", "minsum", "normalized_minsum", "offset_minsum")
B = 32


@pytest.fixture(scope="module")
def codes():
    a = gallager_regular(96, 3, 6, seed=4)
    return {
        "wimax576": JCode(alist=jstd.make_builtin(W576), name=W576),
        "gallager96": JCode(alist=a, name="gallager96"),
    }


def _llrs(code, graph, seed, sigma, batch=B, scale=2.5):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, code.k), dtype=np.uint8)
    w = code.standard_encode_spec.encode_numpy(u, graph).astype(np.float64)
    return (scale * ((2.0 * w - 1.0) + rng.normal(0, sigma, w.shape))) \
        .astype(np.float32)


def _decode_both(code, graph, variant, llr, iters=5, torch_quantize=None,
                 **kw):
    """The JAX decoder and the port's on the same LLRs; ``torch_quantize``
    is the port's counterpart of a JAX ``quantize_msgs``."""
    layout = code.layout(graph)
    info = code.standard_encode_spec.info_pos(graph)
    j = jspa.make_decoder(layout, info, iters, variant, **kw)(jnp.asarray(llr))
    tkw = dict(kw)
    if "dtype" in tkw:
        tkw["dtype"] = {jnp.float64: torch.float64,
                        jnp.float32: torch.float32}[tkw["dtype"]]
    if torch_quantize is not None:
        tkw["quantize_msgs"] = torch_quantize
    t = tspa.make_decoder(layout, info, iters, variant, device="cpu",
                          **tkw)(torch.from_numpy(llr))
    return j, t


def _assert_same(j, t, decisions_only=False):
    np.testing.assert_array_equal(np.asarray(j.est), t.est.numpy())
    np.testing.assert_array_equal(np.asarray(j.ok), t.ok.numpy())
    np.testing.assert_array_equal(np.asarray(j.conv_iter), t.conv_iter.numpy())
    assert int(j.iters_run) == int(t.iters_run)
    if not decisions_only:
        np.testing.assert_array_equal(t.norm_llr.numpy(), np.asarray(j.norm_llr))


# per graph, a noise level where some frames converge and some do not
SIGMA = {"orig": 0.7, "std": 0.4}


@pytest.mark.parametrize("code_name", ["wimax576", "gallager96"])
@pytest.mark.parametrize("graph", ["orig", "std"])
@pytest.mark.parametrize("rule", ["exact", "legacy"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_flooding_decoder_matches_jax(codes, code_name, graph, rule, variant):
    code = codes[code_name]
    seed = 8 * VARIANTS.index(variant) + 2 * (rule == "exact") + (graph == "std")
    llr = _llrs(code, graph, seed=seed, sigma=SIGMA[graph])
    j, t = _decode_both(code, graph, variant, llr, rule=rule)
    _assert_same(j, t, decisions_only=variant == "spa")


@pytest.mark.parametrize("alpha", [(0.6, 0.7, 0.8), ((0.6, 0.65), (0.7, 0.75),
                                                    (0.8, 0.85))])
def test_alpha_schedules_on_std(codes, alpha):
    """[T] and [T, D] schedules on the std graph (the gallager96 std graph
    has two distinct check degrees for [T, D])."""
    code = codes["gallager96"] if np.ndim(alpha) == 2 else codes["wimax576"]
    layout = code.layout("std")
    if np.ndim(alpha) == 2:
        _, degrees = jspa.check_degree_classes(layout)
        _, tdeg = tspa.check_degree_classes(layout)
        assert tdeg == degrees
        alpha = tuple(tuple(a[0] + 0.01 * d for d in range(len(degrees)))
                      for a in alpha)
    llr = _llrs(code, "std", seed=3, sigma=SIGMA["std"])
    j, t = _decode_both(code, "std", "normalized_minsum", llr, rule="legacy",
                        alpha=alpha)
    _assert_same(j, t)


def test_float64_matches_reference_spa(codes):
    """float64 SPA on both graphs and rules equals the numpy reference
    decoder frame by frame (decisions, convergence, normalized LLR)."""
    code = codes["gallager96"]
    for graph in ("std", "orig"):
        for rule in ("legacy", "exact"):
            layout = code.layout(graph)
            info = code.standard_encode_spec.info_pos(graph)
            llr = _llrs(code, graph, seed=42, sigma=0.8, batch=8,
                        scale=4.0).astype(np.float64)
            res = tspa.make_decoder(layout, info, 8, "spa", rule=rule,
                                    dtype=torch.float64, device="cpu")(
                torch.from_numpy(llr))
            for b in range(llr.shape[0]):
                ok, est, conv, norm = decode_reference(layout, info, llr[b], 8,
                                                       rule=rule)
                assert bool(res.ok[b]) == ok
                assert int(res.conv_iter[b]) == conv
                np.testing.assert_array_equal(res.est[b].numpy(), est)
                assert float(res.norm_llr[b]) == pytest.approx(norm, abs=1e-12)


def test_float64_and_bf16_message_hook_match_jax(codes):
    """f64 messages, and f32 messages rounded through bfloat16 at the start
    of every iteration (the ``quantize_msgs`` hook), against JAX."""
    code = codes["wimax576"]
    llr = _llrs(code, "orig", seed=9, sigma=0.7)
    j, t = _decode_both(code, "orig", "minsum", llr.astype(np.float64),
                        dtype=jnp.float64)
    _assert_same(j, t)
    j, t = _decode_both(
        code, "orig", "normalized_minsum", llr,
        quantize_msgs=lambda M: M.astype(jnp.bfloat16).astype(jnp.float32),
        torch_quantize=lambda M: M.to(torch.bfloat16).to(torch.float32))
    _assert_same(j, t)


def test_prod_clip_survives_its_dtype():
    assert tspa._prod_clip(torch.float64) == jspa._prod_clip(jnp.float64)
    assert tspa._prod_clip(torch.float32) == jspa._prod_clip(jnp.float32)
    assert tspa._prod_clip(torch.bfloat16) == jspa._prod_clip(jnp.bfloat16) \
        == 1.0 - 2.0**-8
    assert torch.tensor(tspa._prod_clip(torch.bfloat16),
                        dtype=torch.bfloat16).item() < 1.0


def test_helpers_match_jax(codes):
    """The leave-one-out product and the min-sum update on random messages
    with padding, ties and a degree-1 row."""
    rng = np.random.default_rng(0)
    t = rng.uniform(-1, 1, (4, 6, 9)).astype(np.float32)
    np.testing.assert_allclose(tspa._exclusive_prod(torch.from_numpy(t)).numpy(),
                               np.asarray(jspa._exclusive_prod(jnp.asarray(t))),
                               rtol=1e-6)
    M = np.round(rng.normal(0, 2, (4, 6, 9)), 1).astype(np.float32)  # ties
    valid = rng.random((6, 9)) < 0.7
    valid[0] = False
    valid[0, 3] = True  # a degree-1 row
    js, jm = jspa.minsum_excl_update(jnp.asarray(M), jnp.asarray(valid),
                                     jnp.float32)
    ts, tm = tspa.minsum_excl_update(torch.from_numpy(M),
                                     torch.from_numpy(valid), torch.float32)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    layout = codes["wimax576"].layout("orig")
    ji, jd = jspa.check_degree_classes(layout)
    ti, td = tspa.check_degree_classes(layout)
    np.testing.assert_array_equal(ti, ji)
    assert td == jd


def test_skip_and_slices(codes, monkeypatch):
    """``skip`` runs no iteration; a batch decoded in slices of codewords
    equals one decoded whole."""
    code = codes["wimax576"]
    layout = code.layout("std")
    info = code.standard_encode_spec.info_pos("std")
    llr = torch.from_numpy(_llrs(code, "std", seed=5, sigma=SIGMA["std"]))
    dec = tspa.make_decoder(layout, info, 5, "minsum", rule="legacy",
                            device="cpu")
    skipped = dec(llr, skip=True)
    assert int(skipped.iters_run) == 0 and bool(skipped.ok.all())
    whole = dec(llr)
    monkeypatch.setattr(tspa, "SLICE_ELEMS", 5 * layout.m * layout.dc)
    sliced = tspa.make_decoder(layout, info, 5, "minsum", rule="legacy",
                               device="cpu")
    assert sliced.slice_rows == 5
    parts = sliced(llr)
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)
    assert not bool(whole.ok.all()) and bool(whole.ok.any())


@pytest.mark.parametrize("graph", ["orig", "std"])
def test_bitflipping_matches_jax(codes, graph):
    code = codes["wimax576"]
    layout = code.layout(graph)
    info = code.standard_encode_spec.info_pos(graph)
    llr = _llrs(code, graph, seed=13, sigma={"orig": 0.6, "std": 0.45}[graph])
    j = jspa.make_decoder(layout, info, 20, "bitflipping")(jnp.asarray(llr))
    t = tspa.make_decoder(layout, info, 20, "bitflipping", device="cpu")(
        torch.from_numpy(llr))
    _assert_same(j, t)
    if graph == "orig":
        assert bool(t.ok.any()) and not bool(t.ok.all())


def test_non_qc_code_decodes_through_the_flooding_decoder():
    a = gallager_regular(48, 3, 6, seed=11)
    code = code_from_numpy(a.n, a.m, a.row_idx, a.col_idx, "gallager48")
    opts = SimOptions(matrix="gallager48", fidelity="exact", batch=64,
                      iterations=4, quiet=True)
    ex = PointExecutor(code, opts, device="cpu")
    assert not ex.fused and ex.kernel_used == "torch"
    assert isinstance(ex._decoder, tspa.FloodingDecoder)
    stats = ex.run_point(4.0, 128)
    assert stats.blocks == 128 and stats.ok_blocks > 0


@pytest.mark.parametrize("kw,what", [
    # the JAX runner's ValueErrors (runner.py:263-321)
    (dict(kernel="pallas", fidelity="reference"), "kernel='pallas' requires"),
    (dict(schedule="layered", fidelity="reference"),
     "schedule='layered' requires"),
    (dict(schedule="layered", decoder="bitflipping"),
     "schedule='layered' requires"),
    (dict(check_every=2, kernel="xla", fused="off", schedule="layered"),
     "--check-every > 1"),
    (dict(msg_store="int8", decoder="minsum", fidelity="reference"),
     "storage knob"),
])
def test_plain_decoder_refusals(kw, what):
    opts = dict(matrix=f"builtin:{W576}", fidelity="exact", batch=64,
                iterations=4, quiet=True)
    opts.update(kw)
    with pytest.raises(ValueError, match=what):
        PointExecutor(load_code(f"builtin:{W576}"), SimOptions(**opts),
                      device="cpu")
