"""The unfused path's QAM channel wrapper (``ops.qam_channel``, K6's plain
version) on the CPU: the same LLRs as the interleave -> channel ->
deinterleave chain from the same generators, the kernel's draws taken as the
chain takes them, the kernel's per-symbol algorithm on those draws, and the
wrapper's refusals."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ldpc_tpu_torch.ops.channel import ChannelParams, make_channel_fn
from ldpc_tpu_torch.ops.interleave import make_interleaver
from ldpc_tpu_torch.ops.qam_channel import QAMChannel

torch.set_num_threads(1)

N, B = 96, 8  # 96 bits: 48 / 24 / 16 symbols of QPSK / 16-QAM / 64-QAM
MODES, ORDERS, KINDS = (1, 2, 3), (4, 16, 64), ("none", "regular", "random")


def _consts(mode: int, order: int) -> torch.Tensor:
    return ChannelParams(mode=mode, modulation=order, speed=0.5, snr_db=3.0,
                         interference_snr_db=-3.0, p=0.15,
                         noise_model="exact").consts("cpu")


def _gens(seed: int):
    return (torch.Generator().manual_seed(seed),
            torch.Generator().manual_seed(seed + 1))


def _bits(seed: int = 5) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 2, (B, N)).astype(np.float32))


def _chain(mode, order, kind, gens, w, consts):
    """The unfused path's sequence before K6: interleave, channel,
    deinterleave (``runner.PointExecutor._draw``)."""
    interleave, deinterleave = make_interleaver(kind, N, s_param=2, seed=3)
    w_int, state = interleave(gens[0], w)
    llr = make_channel_fn(mode, order, n=N)(gens[1], w_int, consts)
    return deinterleave(state, llr), state


def _kernel_twin(ch: QAMChannel, w, pi, jam, z_i, z_q, consts) -> np.ndarray:
    """K6's per-symbol algorithm in numpy: gather the symbol's bits through
    pi, Gray labels MSB first (I half, then Q), levels plus noise at the
    symbol's variance, max-log per bit, scatter through pi."""
    bps, ax = ch.bps, ch.bps // 2
    n_sym = N // bps
    if pi is None:
        pos = np.broadcast_to(np.arange(N), (B, N))
    else:
        pos = np.broadcast_to(pi.numpy(), (B, N))
    bits = np.take_along_axis(w.numpy(), pos, 1).astype(np.int64)
    bits = bits.reshape(B, n_sym, bps)
    weights = 1 << np.arange(ax)[::-1]
    lab_i = (bits[..., :ax] * weights).sum(-1)
    lab_q = (bits[..., ax:] * weights).sum(-1)
    lv = ch._levels.numpy()
    s1, s2, p = (np.float64(consts[i]) for i in (2, 3, 7))
    if ch.mode == 1:
        nv = np.full((B, n_sym), s1 * s1 / bps)
    elif ch.mode == 2:
        nv = (s1 * s1 + (jam.numpy() < p) * s2 * s2) / bps
    else:
        nv = np.full((B, n_sym), (s1 * s1 + p * p * s2 * s2) / bps)
    ys = (lv[lab_i] + np.sqrt(nv) * z_i.numpy(),
          lv[lab_q] + np.sqrt(nv) * z_q.numpy())
    llr = np.empty((B, n_sym, bps))
    labels = np.arange(1 << ax)
    for half, y in enumerate(ys):
        d2 = (y[..., None] - lv) ** 2
        for b in range(ax):
            one = (labels >> (ax - 1 - b)) & 1 == 1
            llr[..., half * ax + b] = ((d2[..., ~one].min(-1)
                                        - d2[..., one].min(-1)) / (2 * nv))
    out = np.empty((B, N))
    np.put_along_axis(out, pos, llr.reshape(B, N), 1)
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("mode", MODES)
def test_plain_version_equals_the_chain(mode, order, kind):
    """The wrapper on a CPU tensor gives the chain's LLRs exactly from the
    same generator seeds, and leaves both generators where the chain does;
    the kernel's draws leave them there too, and the random permutation it
    takes is the chain's."""
    consts, w = _consts(mode, order), _bits()
    ch = QAMChannel(mode, order, N, kind, s_param=2, seed=3)
    gens = _gens(11)
    got = ch(*gens, w, consts)
    ref_gens = _gens(11)
    want, state = _chain(mode, order, kind, ref_gens, w, consts)
    assert got.dtype == torch.float32 and got.shape == (B, N)
    assert torch.equal(got, want)
    for g, r in zip(gens, ref_gens):
        assert torch.equal(g.get_state(), r.get_state())
    draw_gens = _gens(11)
    pi, jam, z_i, z_q = ch.draws(*draw_gens, B)
    for g, r in zip(draw_gens, ref_gens):
        assert torch.equal(g.get_state(), r.get_state())
    assert (jam is None) == (mode != 2)
    assert z_i.shape == z_q.shape == (B, N // ch.bps)
    if kind == "random":
        assert torch.equal(pi, state)
    elif kind == "none":
        assert pi is None


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("mode", MODES)
def test_kernel_algorithm_on_the_draws(mode, order, kind):
    """K6's algorithm on the draws of ``draws`` gives the plain version's
    LLRs (in float64 here; on the card, chip_smoke.py holds the kernel's
    float32 LLRs equal to the plain version's bit for bit)."""
    consts, w = _consts(mode, order), _bits(7)
    ch = QAMChannel(mode, order, N, kind, s_param=2, seed=3)
    want = ch.plain(*_gens(21), w, consts).numpy()
    got = _kernel_twin(ch, w, *ch.draws(*_gens(21), B), consts)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["dtype", "contiguous", "order"])
def test_wrapper_refusals(case):
    consts = _consts(1, 16)
    if case == "order":
        with pytest.raises(ValueError, match="Unsupported QAM order"):
            QAMChannel(1, 32, N)
        return
    ch = QAMChannel(1, 16, N)
    if case == "dtype":
        w, match = _bits().to(torch.float64), "dtype"
    else:
        w, match = torch.zeros(B, 2 * N)[:, ::2], "contiguous"
    with pytest.raises(ValueError, match=match):
        ch(*_gens(1), w, consts)


def _launch_args(mode: int):
    """A 16-QAM random-interleaver channel of ``mode`` and valid arguments
    of its ``launch`` on the CPU: (channel, w, pi, jam, z_i, z_q, consts)."""
    ch = QAMChannel(mode, 16, N, "random")
    return (ch, _bits(), *ch.draws(*_gens(3), B), _consts(mode, 16))


_LAUNCH_FAULTS = {
    "pi dtype": (2, lambda a: a.update(pi=a["pi"].to(torch.int32)),
                 "pi has dtype"),
    "pi shape": (2, lambda a: a.update(pi=torch.zeros(B, N + 4,
                                                       dtype=torch.int64)),
                 "pi has shape"),
    "pi contiguous": (2, lambda a: a.update(pi=a["pi"].t().contiguous().t()),
                      "pi must be contiguous"),
    "pi device": (2, lambda a: a.update(pi=a["pi"].to("meta")), "pi is on meta"),
    "jam missing": (2, lambda a: a.update(jam=None), "jam is missing"),
    "jam given": (1, lambda a: a.update(jam=a["z_i"].clone()), "jam is given"),
    "jam shape": (2, lambda a: a.update(jam=a["jam"][:, :-1].contiguous()),
                  "jam has shape"),
    "z_i dtype": (1, lambda a: a.update(z_i=a["z_i"].double()),
                  "z_i has dtype"),
    "z_q shape": (3, lambda a: a.update(z_q=torch.zeros(B, N // 4 + 1)),
                  "z_q has shape"),
    "z_q contiguous": (3, lambda a: a.update(
        z_q=torch.zeros(N // 4, B).t()), "z_q must be contiguous"),
    "w rank": (1, lambda a: a.update(w=a["w"].reshape(-1)), "w has shape"),
    "consts shape": (1, lambda a: a.update(consts=a["consts"][:4]),
                     "consts has shape"),
    "cpu": (2, lambda a: None, "no kernel for device cpu"),
}


@pytest.mark.parametrize("case", list(_LAUNCH_FAULTS))
def test_launch_refusals(case):
    """``launch`` hands the kernel raw pointers, so it refuses, before any
    launch, each argument the kernel would read out of bounds or misread,
    and a device without the kernel."""
    mode, fault, match = _LAUNCH_FAULTS[case]
    ch, *vals = _launch_args(mode)
    args = dict(zip(("w", "pi", "jam", "z_i", "z_q", "consts"), vals))
    fault(args)
    with pytest.raises(ValueError, match=match):
        ch.launch(**args)
