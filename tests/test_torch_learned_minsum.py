"""The port's learned min-sum (``ldpc_tpu_torch.analysis.learned_minsum``)
on the CPU, against the JAX package's on the same LLRs.

The unrolled posteriors, the multiloss and its gradient with respect to the
raw schedule parameters must match the JAX ones (``jax.value_and_grad`` of
the same loss, optax's BCE) within 1e-5 relative; the posteriors'
iteration-1 decisions equal the flooding decoder's. Whole training runs only
need to agree in outcome: the loss falls and the schedule stays in range.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ldpc_tpu.analysis.learned_minsum import (
    make_unrolled_minsum as j_unrolled,
)
from ldpc_tpu.ops.channel import ChannelParams, make_channel_fn
from ldpc_tpu.ops.encode import make_encoder, random_info_bits
from ldpc_tpu.sim.runner import load_code as jload
from ldpc_tpu_torch.analysis import learned_minsum as tlm
from ldpc_tpu_torch.ops.spa import check_degree_classes, make_decoder
from ldpc_tpu_torch.sim.runner import load_code

torch.set_num_threads(1)

W576 = "builtin:wimax_576_0.5.alist.txt"


@pytest.fixture(scope="module")
def codes():
    return load_code(W576), jload(W576)


def _llrs(jcode, B, snr_db=2.0, seed=0):
    k_u, k_ch = jax.random.split(jax.random.key(seed))
    u = random_info_bits(k_u, B, jcode.k)
    w = make_encoder(jcode.standard_encode_spec, "orig")(u)
    consts = ChannelParams(mode=1, modulation=1, speed=jcode.rate,
                           snr_db=snr_db, noise_model="exact").consts()
    llr = make_channel_fn(1, 1, n=jcode.n)(k_ch, w, consts)
    return np.array(w, np.float32), np.array(llr, np.float32)


def _j_loss(jcode, iters, per_degree, llr, w):
    unrolled = j_unrolled(jcode.layout("orig"), iters, per_degree=per_degree)

    def loss(raw):
        Ls = unrolled(1.5 * jax.nn.sigmoid(raw), jnp.asarray(llr))
        labels = jnp.broadcast_to(jnp.asarray(w), Ls.shape)
        return jnp.mean(optax.sigmoid_binary_cross_entropy(-Ls, labels))

    return loss


@pytest.mark.parametrize("iters,per_degree", [(3, False), (5, False),
                                              (3, True)])
def test_posteriors_loss_and_gradients_match(codes, iters, per_degree):
    code, jcode = codes
    w, llr = _llrs(jcode, 16, seed=iters)
    D = len(check_degree_classes(code.layout("orig"))[1])
    shape = (iters, D) if per_degree else (iters,)
    raw = np.random.default_rng(iters).normal(0.5, 0.3, shape).astype(
        np.float32)
    j_loss = _j_loss(jcode, iters, per_degree, llr, w)
    jl, jg = jax.value_and_grad(j_loss)(jnp.asarray(raw))
    jL = j_unrolled(jcode.layout("orig"), iters, per_degree=per_degree)(
        1.5 * jax.nn.sigmoid(jnp.asarray(raw)), jnp.asarray(llr))

    unrolled = tlm.make_unrolled_minsum(code.layout("orig"), iters,
                                        per_degree=per_degree, device="cpu")
    traw = torch.tensor(raw, requires_grad=True)
    tL = unrolled(1.5 * torch.sigmoid(traw), torch.from_numpy(llr))
    tl = tlm.multiloss(tL, torch.from_numpy(w))
    tl.backward()
    np.testing.assert_allclose(tL.detach().numpy(), np.asarray(jL),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(traw.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-8)


def test_unrolled_first_iteration_matches_the_decoder(codes):
    code, jcode = codes
    _, llr = _llrs(jcode, 32, seed=4)
    layout = code.layout("orig")
    Ls = tlm.make_unrolled_minsum(layout, 1, device="cpu")(
        torch.full((1,), 0.8125), torch.from_numpy(llr))
    d = make_decoder(layout, code.standard_encode_spec.info_pos("orig"), 1,
                     "normalized_minsum", alpha=0.8125, early_exit=False,
                     device="cpu")
    assert torch.equal((Ls[0] < 0).to(torch.uint8), d(torch.from_numpy(llr)).est)


@pytest.mark.parametrize("per_degree", [False, True])
def test_training_lowers_the_loss(codes, per_degree):
    """Held out: the learned schedule's loss on a fixed batch is below the
    initial schedule's."""
    code, jcode = codes
    alphas, losses = tlm.train_alphas(
        code, 2.0, iters=4, steps=30, batch=64, lr=0.05, seed=0,
        per_degree=per_degree, say=lambda *a, **k: None, device="cpu")
    D = len(check_degree_classes(code.layout("orig"))[1])
    assert alphas.shape == ((4, D) if per_degree else (4,))
    assert len(losses) == 30 and np.all(np.isfinite(losses))
    assert np.all((alphas > 0) & (alphas < 1.5))
    w, llr = (torch.from_numpy(x) for x in _llrs(jcode, 256, seed=11))
    unrolled = tlm.make_unrolled_minsum(code.layout("orig"), 4,
                                        per_degree=per_degree, device="cpu")
    before = tlm.multiloss(unrolled(torch.full(alphas.shape, 0.75), llr), w)
    after = tlm.multiloss(unrolled(torch.from_numpy(alphas), llr), w)
    assert float(after) < float(before)
    r = tlm.evaluate_alphas(code, alphas, 2.0, iters=4, blocks=256,
                            batch=128, device="cpu")
    assert r["frames"] == 256 and 0 <= r["fer"] <= 1


def test_evaluate_alphas_pairs_its_streams(codes):
    """Same seed, same frames: a constant schedule equals the scalar."""
    code, _ = codes
    a = tlm.evaluate_alphas(code, 0.8, 1.5, iters=4, blocks=256, batch=128,
                            device="cpu")
    b = tlm.evaluate_alphas(code, np.full(4, 0.8), 1.5, iters=4, blocks=256,
                            batch=128, device="cpu")
    assert a == b and a["fer"] > 0


def test_init_alpha_range_is_checked(codes):
    with pytest.raises(ValueError, match="init_alpha"):
        tlm.train_alphas(codes[0], 2.0, 2, steps=1, init_alpha=1.6,
                         device="cpu")
