"""The fused Monte-Carlo step of the port against the JAX package's
interpret-mode kernels, on the same info bits and injected noise words.

* K1 alone: ``MCDecoder`` (plain version) against
  ``mc_pallas.make_mc_decoder(noise_source='input', emit_llr=True)``.
* The slice as a whole: ``make_encoder_T`` -> K1 (6 iterations, LLRs
  emitted) -> stable argsort -> K2 (12 iterations) -> the failed-frames BER
  rule -> ``reduce_block_stats`` -> ``pack_counters`` in JAX, against one
  ``PointExecutor.step`` of the port with the same words injected.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.models import standards as jstd
from ldpc_tpu.models.code import LDPCCode as JCode
from ldpc_tpu.models.qc import paired_layer_groups
from ldpc_tpu.ops import channel as jchannel
from ldpc_tpu.ops import encode as jencode
from ldpc_tpu.ops import metrics as jmetrics
from ldpc_tpu.ops.mc_pallas import (
    channel_llr_reference,
    consts_vector,
    make_llr_decoder,
    make_mc_decoder,
)
from ldpc_tpu_torch.ops.mc_kernels import DRAWS_PER_BIT, MCDecoder
from ldpc_tpu_torch.sim.config import SimOptions
from ldpc_tpu_torch.sim.runner import PointExecutor
from ldpc_tpu_torch.utils.carry import code_from_numpy, consts_from_numpy

torch.set_num_threads(1)

ITU = "LDPC_N336_K196_ITU_G.h.alist.txt"
B = 128
PHASE1, ITERS = 6, 12
VARIANT = "normalized_minsum"
PARAMS = dict(mode=1, modulation=1, snr_db=2.0, speed=0.5, noise_model="exact")


@pytest.fixture(scope="module")
def jax_k1():
    """The JAX side's inputs and its interpret-mode K1 outputs (one call,
    shared by both tests)."""
    code = JCode(alist=jstd.make_builtin(ITU), name=ITU)
    spec = code.standard_encode_spec
    info = spec.info_pos("orig")
    groups = paired_layer_groups(code.qc)
    rng = np.random.default_rng(11)
    u = rng.integers(0, 2, (B, code.k), dtype=np.uint8)
    raw = rng.integers(0, 2**32, (DRAWS_PER_BIT[1], code.n, B), dtype=np.uint32)
    wT = jencode.make_encoder_T(spec, "orig")(jnp.asarray(u))
    cv = consts_vector(jchannel.ChannelParams(**PARAMS).consts())
    mc = make_mc_decoder(code.qc, info, PHASE1, VARIANT, schedule="layered",
                         noise_source="input", interpret=True, emit_llr=True,
                         track_norm=False, layer_groups=groups, check_every=2)
    out = jax.jit(mc)(wT, cv, jnp.zeros(2, jnp.int32), jnp.asarray(raw))
    return dict(code=code, info=info, groups=groups, u=u, raw=raw, wT=wT,
                cv=cv, out=out)


def test_mc_step_matches_interpret_kernel(jax_k1):
    j = jax_k1
    code = j["code"]
    port_code = code_from_numpy(code.n, code.m, code.H.row_idx,
                                code.H.col_idx, ITU)
    wT = torch.from_numpy(np.array(j["wT"], np.float32))
    consts = consts_from_numpy(np.asarray(j["cv"]), "cpu")
    mc = MCDecoder(port_code.qc, port_code.standard_encode_spec.info_pos("orig"),
                   PHASE1, VARIANT, layer_groups=j["groups"], check_every=2,
                   emit_llr=True)
    err, ok, conv, _, _, llr = mc(wT, consts, raw=torch.from_numpy(j["raw"]))
    r_err, r_ok, r_conv, _, _, r_llr = (np.asarray(x) for x in j["out"])
    # the emitted LLRs to the channel bar of the JAX package's own tests
    # (test_mc_fused.py:132-133), and to its eager replay of the channel
    np.testing.assert_allclose(llr.numpy(), r_llr, rtol=1e-5, atol=1e-4)
    replay = -np.asarray(channel_llr_reference(
        j["wT"], jnp.asarray(j["raw"]),
        jchannel.ChannelParams(**PARAMS).consts(), 1, 1, code.qc.Z))
    np.testing.assert_allclose(llr.numpy(), replay.astype(np.float32),
                               rtol=1e-5, atol=1e-4)
    # min-sum counters: equal for every frame
    np.testing.assert_array_equal(err.numpy(), r_err)
    np.testing.assert_array_equal(ok.numpy(), r_ok)
    np.testing.assert_array_equal(conv.numpy(), r_conv)
    assert 0 < ok.sum() < B  # phase 1 leaves some frames to phase 2


def _jax_chain(j) -> np.ndarray:
    """The JAX runner's two-phase composition (runner.py:684-711, 796-803)
    on the interpret-mode kernels, reduced and packed."""
    code = j["code"]
    err1, ok1, conv1, norm1, it1, llrT = j["out"]
    order = jnp.argsort(ok1.astype(jnp.int32), stable=True)
    dec = make_llr_decoder(code.qc, j["info"], ITERS, VARIANT,
                           schedule="layered", interpret=True, track_norm=False,
                           layer_groups=j["groups"], check_every=2)
    err2, ok2, conv2, norm2, it2 = jax.jit(dec)(
        jnp.take(llrT, order, axis=1), jnp.take(j["wT"], order, axis=1),
        ok1[order].astype(jnp.float32))

    def unsort(x):
        return jnp.zeros_like(x).at[order].set(x)

    err = jnp.where(ok1, err1, unsort(err2))
    conv = jnp.where(ok1, conv1, unsort(conv2))
    norm = jnp.where(ok1, norm1, unsort(norm2))
    ok = ok1 | unsort(ok2)
    iters = it1 + unsort(it2)
    err = jnp.where(ok, 0, err)  # failed frames only (metrics.block_stats)
    stats = jmetrics.BlockStats(err, ok, conv, norm)
    c = jmetrics.reduce_block_stats(stats, jnp.ones(B, bool))
    return np.asarray(jmetrics.pack_counters(c, jnp.max(iters)))


def test_slice_as_a_whole_packed_counters_equal(jax_k1):
    j = jax_k1
    ref = _jax_chain(j)
    opts = SimOptions(matrix=ITU, iterations=ITERS, decoder="normalized-minsum",
                      fidelity="exact", batch=B, speed=PARAMS["speed"],
                      schedule="layered", layer_order="paired", check_every=2,
                      two_phase=str(PHASE1))
    code = j["code"]
    port_code = code_from_numpy(code.n, code.m, code.H.row_idx,
                                code.H.col_idx, ITU)
    ex = PointExecutor(port_code, opts, device="cpu")
    assert ex.phase1 == PHASE1
    assert ex.kernel_used == "cpu+fused+layered+paired+ce2+2phase(6)"
    stats, iters = ex.step(0, ex.consts(PARAMS["snr_db"]), ex.phase1,
                           u=torch.from_numpy(j["u"]),
                           raw=torch.from_numpy(j["raw"].view(np.int32)))
    port = ex.packed(stats, iters, B)
    assert port.dtype == torch.int32 and tuple(port.shape) == (8,)
    np.testing.assert_array_equal(port.numpy(), ref)
    assert 0 < ref[3] < B and ref[2] > 0  # failed frames carry bit errors
