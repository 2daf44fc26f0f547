"""Learned per-iteration normalized-min-sum weight schedules.

Counterpart of ``ldpc_tpu/analysis/learned_minsum.py``, on autograd and
``torch.optim.Adam`` (the update of optax's ``adam`` at its defaults). The
decoder is a differentiable function of its check-update weights, so the
framework can optimize the decoder itself (Nachmani et al. 2017,
arXiv:1701.05931; degree-specific weights, arXiv:2107.04221): this module
learns a per-iteration schedule ``alpha[t]`` for the normalized min-sum
decoder by unrolling T iterations with no early exit (gradients flow through
every iteration), drawing fresh channel noise each optimizer step, and
minimizing the multiloss sigmoid BCE between every iteration's posterior and
the transmitted codeword.

Train and inference share one check update (``ops.spa.minsum_excl_update``);
the learned vector deploys through ``ops.spa.make_decoder(...,
alpha=alphas)`` and through the CUDA kernels' ``--minsum-alpha`` schedule.
All of it is plain PyTorch: the JAX module has no Pallas kernel either.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ldpc_tpu_torch.ops.spa import (
    check_degree_classes,
    minsum_excl_update,
    posterior_sum,
)
from ldpc_tpu_torch.utils.device import resolve_device


def make_unrolled_minsum(layout, iters: int, dtype=torch.float32,
                         per_degree: bool = False, device=None):
    """Differentiable unrolled normalized min-sum (exact rule, orig graph).

    Returns ``posteriors(alphas, llr [B, n]) -> [T, B, n]`` posteriors in
    the log(p0/p1) domain (bit = 1 <=> L < 0), one per iteration; alphas is
    [T], or [T, D] with ``per_degree=True`` (D = distinct check degrees
    ascending, ops.spa.check_degree_classes). Input LLRs use the channel
    convention LLR > 0 <=> bit 1. No early exit and no hard decisions
    inside. ``device=None`` means the card.
    """
    dev = resolve_device(device)
    n, m, dc = layout.n, layout.m, layout.dc
    chk_var = torch.as_tensor(np.asarray(layout.chk_var, np.int64),
                              device=dev)  # [m, dc] pad = n
    var_edge = torch.as_tensor(np.asarray(layout.var_edge, np.int64),
                               device=dev)  # [n, dv] pad = m*dc
    slot_valid = chk_var < n
    flat = chk_var.reshape(-1)
    deg_idx = (torch.as_tensor(check_degree_classes(layout)[0],
                               dtype=torch.int64, device=dev)
               if per_degree else None)

    def posteriors(alphas: torch.Tensor, llr: torch.Tensor) -> torch.Tensor:
        lc = -llr.to(dtype)  # exact rule: log(p0/p1) domain
        B = lc.shape[0]
        lc_pad = F.pad(lc, (0, 1))  # sentinel var n -> 0
        M = lc_pad.index_select(1, flat).view(B, m, dc)
        outs = []
        for t in range(iters):
            sgn, mag = minsum_excl_update(M, slot_valid, dtype)
            a_t = (alphas[t][deg_idx][None, :, None] if per_degree
                   else alphas[t])
            E = sgn * (a_t * mag)
            E = torch.where(slot_valid, E, torch.zeros((), dtype=dtype,
                                                       device=E.device))
            E_flat = F.pad(E.reshape(B, m * dc), (0, 1))
            L = lc + posterior_sum(E_flat, var_edge)
            outs.append(L)
            M = F.pad(L, (0, 1)).index_select(1, flat).view(B, m, dc) - E
        return torch.stack(outs)

    return posteriors


def multiloss(Ls: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid BCE of every iteration's posterior ``Ls`` [T, B, n]
    against the sent bits ``w`` [B, n]: P(bit=1) = sigmoid(-L), in optax's
    ``sigmoid_binary_cross_entropy`` form."""
    labels = w.to(Ls.dtype).expand_as(Ls)
    logits = -Ls
    return torch.mean(-labels * F.logsigmoid(logits)
                      - (1.0 - labels) * F.logsigmoid(-logits))


def _channel_setup(code, snr_db: float, speed, dev):
    from ldpc_tpu_torch.ops.channel import ChannelParams, make_channel_fn
    from ldpc_tpu_torch.ops.encode import make_encoder

    spec = code.standard_encode_spec
    encode = make_encoder(spec, "orig", dev)
    channel = make_channel_fn(1, 1, n=code.n)
    consts = ChannelParams(
        mode=1, modulation=1, speed=speed if speed is not None else code.rate,
        snr_db=snr_db, noise_model="exact",
    ).consts(dev)
    return spec, encode, channel, consts


def _generator(key: int, dev) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(key >> 1)
    return g


def train_alphas(
    code,
    snr_db: float,
    iters: int,
    *,
    steps: int = 150,
    batch: int = 128,
    lr: float = 0.05,
    seed: int = 0,
    init_alpha: float = 0.75,
    speed: float | None = None,
    per_degree: bool = False,
    say=print,
    device=None,
):
    """Learn a per-iteration alpha schedule at one operating point.

    Returns ``(alphas numpy, losses [steps])`` with alphas [T], or [T, D]
    degree-specific weights when ``per_degree=True``. ``speed`` follows the
    CLI semantics (Eb/N0 axis scale; defaults to the code rate so snr_db is
    per info bit). Training uses mode-1 BPSK with exact noise; step ``s``
    draws its frames from ``derive_key(seed, s)``.
    """
    from ldpc_tpu_torch.ops.encode import random_info_bits
    from ldpc_tpu_torch.sim.runner import derive_key

    dev = resolve_device(device)
    layout = code.layout("orig")
    _, encode, channel, consts = _channel_setup(code, snr_db, speed, dev)
    unrolled = make_unrolled_minsum(layout, iters, per_degree=per_degree,
                                    device=dev)
    k = code.k

    # alpha = 1.5 * sigmoid(raw): positive, bounded, init at init_alpha
    if not 0.0 < init_alpha < 1.5:
        raise ValueError(
            f"init_alpha={init_alpha} outside the schedule's (0, 1.5) "
            "sigmoid parametrization range"
        )
    shape = ((iters, len(check_degree_classes(layout)[1])) if per_degree
             else (iters,))
    raw = torch.full(shape, float(np.log(init_alpha / (1.5 - init_alpha))),
                     dtype=torch.float32, device=dev, requires_grad=True)
    opt = torch.optim.Adam([raw], lr=lr)

    losses = []
    for s in range(steps):
        key = derive_key(seed, s)
        u = random_info_bits(_generator(derive_key(key, 0), dev), batch, k)
        w = encode(u)
        llr = channel(_generator(derive_key(key, 1), dev), w, consts)
        loss = multiloss(unrolled(1.5 * torch.sigmoid(raw), llr), w)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if s % max(steps // 5, 1) == 0:
            say(f"  step {s:4d} loss {losses[-1]:.5f}")
    alphas = (1.5 * torch.sigmoid(raw)).detach().cpu().numpy()
    say(f"  learned alphas: {np.round(alphas, 4).tolist()}")
    return alphas, losses


def evaluate_alphas(
    code,
    alpha,
    snr_db: float,
    iters: int,
    *,
    blocks: int = 4096,
    batch: int = 512,
    seed: int = 1,
    speed: float | None = None,
    device=None,
):
    """FER/BER of the normalized min-sum decoder with ``alpha`` (scalar or
    per-iteration vector) at one SNR point, through the flooding decoder
    ``ops.spa.make_decoder``. Same stream for every alpha at a given seed,
    so comparisons are paired. The counts stay on the device until the
    end."""
    from ldpc_tpu_torch.ops.encode import random_info_bits
    from ldpc_tpu_torch.ops.metrics import block_stats
    from ldpc_tpu_torch.ops.spa import make_decoder
    from ldpc_tpu_torch.sim.runner import derive_key

    dev = resolve_device(device)
    layout = code.layout("orig")
    spec, encode, channel, consts = _channel_setup(code, snr_db, speed, dev)
    info_pos = spec.info_pos("orig")
    info_t = torch.as_tensor(np.asarray(info_pos, np.int64), device=dev)
    decode = make_decoder(layout, info_pos, iters, "normalized_minsum",
                          alpha=alpha, rule="exact", device=dev)
    fails = torch.zeros((), dtype=torch.int64, device=dev)
    errs = torch.zeros((), dtype=torch.int64, device=dev)
    n_batches = max(blocks // batch, 1)
    for i in range(n_batches):
        key = derive_key(seed, i)
        u = random_info_bits(_generator(derive_key(key, 0), dev), batch,
                             code.k)
        llr = channel(_generator(derive_key(key, 1), dev), encode(u), consts)
        s = block_stats(u, decode(llr), info_t, exact=True)
        fails += (~s.ok).sum()
        errs += s.error_bits.sum()
    frames = n_batches * batch
    return {
        "fer": int(fails) / frames,
        "ber": int(errs) / (frames * code.k),
        "frames": frames,
    }
