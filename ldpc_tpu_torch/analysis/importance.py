"""Importance-sampled FER estimation for the deep error-floor regime.

Counterpart of ``ldpc_tpu/analysis/importance.py``. Plain Monte-Carlo needs
~100/FER frames per point; this module estimates FER at error-floor depths
by biasing the channel noise toward the KNOWN dominant error events -- the
trapping-set supports and minimum-distance codeword orbits the census
machinery surfaces (:mod:`ldpc_tpu_torch.analysis.failures`,
``examples/error_floor``) -- and unbiasing with likelihood-ratio weights.

Estimator: DEFENSIVE MIXTURE importance sampling. The proposal is

    q(n) = pi0 * p(n) + (1 - pi0)/M * sum_j N(n; D_j, sigma^2 I)

where p is the true AWGN density and each D_j is a mean shift that drags
the received word toward one error event: for a support T (bit positions,
original graph), D_j flips the transmitted symbols on T by
``shift * 2 * amp`` (shift = 0.5 lands exactly on the pairwise decision
boundary). Every cyclic lift of every support is its own component
(:func:`orbit_supports`). The estimate is E_q[w * 1{fail}] with w = p/q for
the FULL mixture, unbiased for the TOTAL failure probability, and the
defensive p-component bounds w <= 1/pi0. The shifted components give the
known-event contribution (the floor) with tight CIs; failures outside every
known event are sampled only by the defensive component at plain-MC power,
so at sample sizes where it sees none the estimate is a rigorous lower bound
on total FER (the JAX module's docstring has the full argument).

Weight computation never forms q directly: with n = sigma*z + D_sel,

    w(n) = 1 / (pi0 + (1 - pi0)/M * sum_j exp((n . D_j - |D_j|^2 / 2) / sigma^2))

and the M dot products are one [B, n] x [n, M] ``torch.matmul`` (the JAX
package computes it outside any Pallas kernel too). The fused kernels cannot
take biased noise, so the IS step is the unfused one: the channel here and
the unfused route's decoder (``runner.choose_route``; K3 on a QC code).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, replace

import numpy as np
import torch

from ldpc_tpu_torch.models.code import LDPCCode
from ldpc_tpu_torch.ops.channel import (
    CONSTS_ORDER,
    ChannelParams,
    draw_normal,
    draw_uniform,
)
from ldpc_tpu_torch.ops.encode import make_encoder, random_info_bits
from ldpc_tpu_torch.ops.metrics import block_stats
from ldpc_tpu_torch.sim.config import SimOptions
from ldpc_tpu_torch.sim.runner import choose_route, derive_key
from ldpc_tpu_torch.utils.device import resolve_device


def orbit_supports(supports: list[list[int]], Z: int, n: int,
                   max_components: int | None = None) -> np.ndarray:
    """Expand base supports by the QC lift automorphism.

    Each support (original-graph bit indices) yields Z components: index
    (bj, r) -> (bj, (r + t) % Z) for t in [0, Z). Duplicate components
    (supports invariant under some shift) are dropped. Returns a dense
    [M, n] float32 matrix of 0/1 masks.
    """
    seen: set[tuple[int, ...]] = set()
    rows: list[np.ndarray] = []
    for sup in supports:
        sup = np.asarray(sorted(sup), np.int64)
        if sup.size == 0:
            continue
        bj, r = sup // Z, sup % Z
        for t in range(Z):
            shifted = tuple(sorted(bj * Z + (r + t) % Z))
            if shifted in seen:
                continue
            seen.add(shifted)
            mask = np.zeros(n, np.float32)
            mask[list(shifted)] = 1.0
            rows.append(mask)
            if max_components and len(rows) >= max_components:
                return np.stack(rows)
    if not rows:
        raise ValueError("no non-empty supports given")
    return np.stack(rows)


def census_supports(census_path: str, min_count: int = 2,
                    max_size: int = 16) -> list[list[int]]:
    """Pull shift targets out of a trapping-census / undetected-codewords
    JSON (examples/error_floor): every recorded exact support with
    ``count >= min_count`` or size <= max_size."""
    with open(census_path, encoding="utf-8") as f:
        data = json.load(f)
    out: list[list[int]] = []
    for entry in data.get("recurring_supports", []):
        sup = entry["support"] if isinstance(entry, dict) else entry
        if len(sup) <= max_size:
            out.append(list(sup))
    for entry in data.get("patterns", []):
        sup = entry.get("support") if isinstance(entry, dict) else entry
        if sup and len(sup) <= max_size:
            out.append(list(sup))
    return out


@dataclass
class ISResult:
    """One SNR point's importance-sampled estimates (all per-frame rates)."""

    snr_db: float
    frames: int
    fer: float  # detected failures (syndrome unsatisfied at max iters)
    fer_std: float
    wer: float  # any wrong delivery: detected OR undetected (exact)
    wer_std: float
    undetected: float  # syndrome-passing wrong codewords only
    undetected_std: float
    mean_weight: float  # E_q[w] ~ 1.0 is a consistency diagnostic
    max_weight: float
    fail_frames: int  # raw (unweighted) failing frames observed under q

    def to_dict(self) -> dict:
        return self.__dict__.copy()


def _consts(opts: SimOptions, snr_db: float, device) -> torch.Tensor:
    return ChannelParams(
        mode=opts.mode, modulation=opts.modulation, speed=opts.speed,
        snr_db=snr_db, interference_snr_db=opts.interference_snr,
        p=opts.p, noise_model=opts.noise_model,
    ).consts(device)


def make_is_step(code: LDPCCode, opts: SimOptions, shifts: np.ndarray,
                 *, pi0: float = 0.2, shift: float = 0.5,
                 return_resid: bool = False, device=None):
    """Build ``step(key, consts) -> per-frame (w, detected, wrong)`` and the
    decoder's ``kernel_used``.

    ``shifts``: [M, n] 0/1 support masks (:func:`orbit_supports`). Mode-1
    BPSK exact-noise channel only. ``key`` (an int) seeds the batch's
    draws: the info bits, the normals and the component choice, each from
    its own ``torch.Generator`` (``derive_key(key, 0 / 1 / 2)``); ``u``,
    ``z`` and ``comp`` (-1 = the defensive draw) replace them, so a test can
    hand both packages the same draws. ``return_resid=True`` appends the
    residuals ``est XOR transmitted`` (uint8 [B, n]) for
    :func:`harvest_failures`. ``device=None`` means the card.
    """
    opts = opts.resolved()
    if opts.mode != 1 or opts.modulation != 1:
        raise ValueError("importance sampling supports mode 1 / BPSK")
    if opts.noise_model != "exact":
        raise ValueError("importance sampling requires noise_model='exact'")
    if not 0.0 < pi0 < 1.0:
        raise ValueError("pi0 must be in (0, 1)")
    dev = resolve_device(device)

    spec = code.encode_spec(opts.encoding_method, opts.ru_gap)
    info_pos = np.asarray(spec.info_pos(opts.decode_graph)[: code.k],
                          np.int64)
    route = choose_route(code, replace(opts, fused="off"), dev,
                         opts.iterations, opts.modulation, opts.interleaver)
    decode = route.unfused_decoder(info_pos, opts.iterations)
    encode = make_encoder(spec, opts.decode_graph, dev)

    M, n = shifts.shape
    if n != code.n:
        raise ValueError(f"shifts have {n} columns, the code has n={code.n}")
    batch, k = opts.batch, code.k
    # delta magnitude per shifted bit, in symbol units (amp = 1 for BPSK)
    delta_amp = 2.0 * shift
    shifts_t = torch.as_tensor(np.asarray(shifts, np.float32), device=dev)
    sup_sizes = shifts_t.sum(dim=1)  # [M]
    info_t = torch.as_tensor(info_pos, device=dev)
    i_std, i_scale = CONSTS_ORDER.index("noise1_std"), \
        CONSTS_ORDER.index("llr_scale")

    def gen(key: int) -> torch.Generator:
        g = torch.Generator(device=dev)
        g.manual_seed(key >> 1)
        return g

    def step(key: int, consts: torch.Tensor, *, u=None, z=None, comp=None):
        if u is None:
            u = random_info_bits(gen(derive_key(key, 0)), batch, k)
        if z is None:
            z = draw_normal(gen(derive_key(key, 1)), (batch, n))
        if comp is None:
            g = gen(derive_key(key, 2))
            r = draw_uniform(g, (batch,))
            pick = torch.randint(0, M, (batch,), generator=g, device=dev)
            comp = torch.where(r < pi0, -1, pick)
        w_bits = encode(u).to(torch.float32)  # 0/1 [B, n]
        sym = 2.0 * w_bits - 1.0
        sigma = consts[i_std]
        # component selection: a zero row for the defensive draws
        sel = torch.nn.functional.one_hot(comp.clamp_min(0).to(torch.int64),
                                          M).to(torch.float32)
        sel = sel * (comp >= 0).to(torch.float32)[:, None]
        # the shift drags the SUPPORT bits toward the flipped symbol
        d_sel = -delta_amp * sym * (sel @ shifts_t)  # [B, n]
        noise = sigma * z + d_sel
        llr = consts[i_scale] * (sym + noise)
        # mixture weight: dot(n, D_j) for every component in one product;
        # D_j(frame) = -delta_amp * sym * mask_j, |D_j|^2 = delta_amp^2 |T_j|
        nd = torch.matmul(noise * (-delta_amp * sym), shifts_t.T)  # [B, M]
        expo = (nd - 0.5 * delta_amp ** 2 * sup_sizes[None, :]) / (sigma ** 2)
        # log-sum-exp: exponents reach +-50 at deep SNR
        m_max = expo.amax(dim=1, keepdim=True)
        lse = m_max[:, 0] + torch.log(torch.exp(expo - m_max).sum(dim=1))
        w = 1.0 / (pi0 + (1.0 - pi0) / M * torch.exp(lse))
        res = decode(llr.contiguous())
        stats = block_stats(u, res, info_t, exact=True)
        detected = ~res.ok
        wrong = detected | (stats.error_bits > 0)
        if return_resid:
            return w, detected, wrong, res.est ^ w_bits.to(res.est.dtype)
        return w, detected, wrong

    return step, route.kernel


def harvest_failures(code: LDPCCode, opts: SimOptions, shifts: np.ndarray,
                     snr_db: float, *, frames: int, pi0: float = 0.2,
                     shift: float = 0.5, max_support: int = 24,
                     min_count: int = 2, top: int | None = 64,
                     seed: int = 23, say=print, device=None) -> list[list[int]]:
    """Failure-residual supports harvested FROM the IS sampler itself.

    Each failing frame's residual support under the biased proposal is a
    candidate event; the filter is recurrence after QC-orbit
    canonicalization. Returns up to ``top`` supports (orbit
    representatives, ``0 < |support| <= max_support``) seen at least
    ``min_count`` times, most-recurrent first; drops are logged.
    """
    from ldpc_tpu_torch.models.qc import qc_orbit_canonical

    opts = opts.resolved()
    dev = resolve_device(device)
    Z = code.qc.Z if code.qc is not None else 1
    step, _ = make_is_step(code, opts, shifts, pi0=pi0, shift=shift,
                           return_resid=True, device=dev)
    consts = _consts(opts, snr_db, dev)
    batch = opts.batch
    n_batches = -(-frames // batch)
    key = derive_key(seed, int(snr_db * 1000))

    counts: dict[tuple[int, ...], int] = {}
    fails = oversize = empty = 0
    for b in range(n_batches):
        _, _, wrong, resid = step(derive_key(key, b), consts)
        wrong = wrong.cpu().numpy()
        if not wrong.any():
            continue
        fails += int(wrong.sum())
        for e in resid.cpu().numpy()[wrong]:
            sup = np.flatnonzero(e)
            if len(sup) == 0:
                empty += 1
                continue
            if len(sup) > max_support:
                oversize += 1
                continue
            c = qc_orbit_canonical(sup, Z)
            counts[c] = counts.get(c, 0) + 1
    ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    keep = [list(s) for s, n in ranked if n >= min_count]
    dropped_single = len(ranked) - len(keep)
    dropped_tail = 0
    if top is not None and len(keep) > top:
        dropped_tail = len(keep) - top
        keep = keep[:top]
    say(f"  harvested {len(keep)} recurrent orbit supports at {snr_db:g} dB "
        f"({fails} failures / {n_batches * batch} IS frames; "
        f"{len(ranked)} distinct orbits, {dropped_single} below "
        f"min_count={min_count}, {dropped_tail} beyond top={top}, "
        f"{oversize} residuals over max_support={max_support}, "
        f"{empty} empty)")
    return keep


def estimate_point(
    code: LDPCCode,
    opts: SimOptions,
    snr_db: float,
    shifts: np.ndarray,
    *,
    frames: int,
    pi0: float = 0.2,
    shift: float = 0.5,
    seed: int = 0,
    step=None,
    device=None,
) -> ISResult:
    """Importance-sampled FER/WER at one SNR point over ``frames`` draws.

    The sums accumulate on the device in float64 and the host reads them
    once, at the end."""
    opts = opts.resolved()
    dev = resolve_device(device)
    if step is None:
        step, _ = make_is_step(code, opts, shifts, pi0=pi0, shift=shift,
                               device=dev)
    consts = _consts(opts, snr_db, dev)
    batch = opts.batch
    n_batches = -(-frames // batch)
    key = derive_key(seed, int(snr_db * 1000))

    f64 = torch.float64
    tot = torch.zeros(3, dtype=f64, device=dev)  # w*det, w*wrong, w*undet
    tot_sq = torch.zeros(3, dtype=f64, device=dev)
    w_sum = torch.zeros((), dtype=f64, device=dev)
    w_max = torch.zeros((), dtype=f64, device=dev)
    fails = torch.zeros((), dtype=torch.int64, device=dev)
    for b in range(n_batches):
        w, det, wrong = step(derive_key(key, b), consts)
        w = w.to(f64)
        x = w[None, :] * torch.stack([det, wrong, wrong & ~det]).to(f64)
        tot += x.sum(dim=1)
        tot_sq += (x * x).sum(dim=1)
        w_sum += w.sum()
        w_max = torch.maximum(w_max, w.max())
        fails += wrong.sum()

    N = n_batches * batch
    tot, tot_sq = tot.cpu().numpy(), tot_sq.cpu().numpy()
    mean = tot / N
    # standard error of the mean of w*1{...}
    var = np.maximum(tot_sq / N - mean**2, 0.0)
    std = np.sqrt(var / N)
    return ISResult(
        snr_db=snr_db, frames=N,
        fer=float(mean[0]), fer_std=float(std[0]),
        wer=float(mean[1]), wer_std=float(std[1]),
        undetected=float(mean[2]), undetected_std=float(std[2]),
        mean_weight=float(w_sum) / N, max_weight=float(w_max),
        fail_frames=int(fails),
    )
