"""Check-node helpers, the flooding decoder on EdgeLayout and bit-flipping.

Counterpart of ``ldpc_tpu/ops/spa.py``: the clipping constants, the result,
the leave-one-out order :func:`exclusive_combine` (``:89-110``), the
min-sum update over the padded edge layout (``minsum_excl_update``,
``:127-155``), the flooding decoder ``make_decoder`` (``:158-350``) and the
Gallager-B bit-flipping decoder ``make_bitflip_decoder`` (``:353-433``).
The decode loop's plain version (ldpc_tpu_torch.ops.decode_loop) and the
CUDA kernel (csrc/decode_group.cuh) both evaluate the leave-one-out products
and minima in the order :func:`exclusive_combine` defines, the precondition
for min-sum results that are equal bit for bit.

The flooding decoder is plain PyTorch: the JAX package never wrote it as a
Pallas kernel. It is the decoder of every configuration the QC kernels do
not take: the ``std`` graph and the legacy check rule of ``--fidelity
reference`` (the CLI's default), non-QC codes and ``--kernel xla``.
Messages live check-major in ``M[B, m, dc]``; an iteration is gathers,
elementwise math and reductions, and codewords that pass their syndrome
check freeze while the others go on. Its float sums run in the order XLA
runs them on the CPU (:func:`posterior_sum`), so the min-sum family is equal
bit for bit to the JAX decoder on the same LLRs. A batch whose ``[B, m,
dc]`` messages would pass :data:`SLICE_ELEMS` elements is decoded in slices
of codewords: the codewords are independent, so the outputs are the same.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ldpc_tpu_torch.utils.device import resolve_device

# Reference clipping constants (spa_decoder.py:139-145,167). In float64 these
# are the exact values the reference uses; in float32 the tightest
# representable magnitude below 1 plays the same role.
TANH_IN_CLIP = 17.5
PROD_CLIP_F64 = 0.99999999999999878
PROD_CLIP_F32 = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
LLR_WINDOW = 7.0  # normalized-LLR confidence window (spa_decoder.py:218)


class DecodeResult(NamedTuple):
    ok: torch.Tensor  # bool [B]   syndrome satisfied
    est: torch.Tensor  # uint8 [B, n]  estimated codeword bits
    conv_iter: torch.Tensor  # int32 [B]  0-based converging iteration, -1 if failed
    norm_llr: torch.Tensor  # f32 [B]    normalized-LLR at the final iteration
    iters_run: torch.Tensor  # int32 []   iterations the batch actually executed


def exclusive_combine(values, op):
    """Exclusive prefix/suffix combine of a static list (leave-one-out).

    ``None`` marks the symbolic identity. ``prefix[i]`` folds values
    ``0..i-1`` left to right, ``suffix[i]`` folds ``d-1..i+1`` right to
    left, and the result is ``op(prefix[i], suffix[i])``.
    """

    def op2(a, b):
        if a is None:
            return b
        if b is None:
            return a
        return op(a, b)

    d = len(values)
    prefix = [None] * d
    suffix = [None] * d
    for i in range(1, d):
        prefix[i] = op2(prefix[i - 1], values[i - 1])
        suffix[d - 1 - i] = op2(suffix[d - i], values[d - i])
    return [op2(p, s) for p, s in zip(prefix, suffix)]


# the XLA CPU reduction of a gathered posterior sum adds the slots in
# sequential blocks of this many and then the block sums in order (for up
# to 32 slots, one sequential fold): the order that gives min-sum results
# equal bit for bit to the JAX decoder
SUM_BLOCK = 32
# messages per slice of the flooding decoder: 2^28 f32 elements (1 GiB) per
# [B, m, dc] tensor keeps the SPA update's few live tensors well inside the
# card's 80 GB at the std graph of WiMAX 1152 (dc 325)
SLICE_ELEMS = 1 << 28


def _prod_clip(dtype) -> float:
    """Largest value strictly below 1.0 in the message dtype.

    The clip must survive a round-trip through ``dtype``: the f32 constant
    rounds to exactly 1.0 in bfloat16, which sends the 2*atanh log form to
    +inf and collapses the whole decode to NaN (``spa.py:62-73``)."""
    if dtype == torch.float64:
        return PROD_CLIP_F64
    if dtype == torch.bfloat16:
        return 1.0 - 2.0**-8  # largest bf16 < 1
    return PROD_CLIP_F32


def _exclusive_prod(t: torch.Tensor) -> torch.Tensor:
    """Exact leave-one-out product along the last axis (prefix and suffix
    running products, ``spa.py:76-82``)."""
    ones = torch.ones_like(t[..., :1])
    prefix = torch.cat([ones, torch.cumprod(t[..., :-1], dim=-1)], dim=-1)
    rev = torch.cumprod(t.flip(-1), dim=-1).flip(-1)
    suffix = torch.cat([rev[..., 1:], ones], dim=-1)
    return prefix * suffix


def _signs(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x < 0, -1.0, 1.0).to(x.dtype)


def check_degree_classes(layout):
    """Distinct check degrees of a graph: ``(deg_idx [m], degrees)``.

    ``degrees`` lists the distinct row degrees ascending; ``deg_idx[i]`` is
    row i's index into it. The degree axis of a [T, D] alpha schedule
    follows this order (``spa.py:113-124``)."""
    deg = np.sum(np.asarray(layout.chk_var) < layout.n, axis=1)
    degrees = sorted(int(d) for d in set(deg.tolist()))
    lookup = {d: i for i, d in enumerate(degrees)}
    return np.asarray([lookup[int(d)] for d in deg], np.int32), degrees


def minsum_excl_update(M: torch.Tensor, slot_valid: torch.Tensor, dtype):
    """Leave-one-out min-sum check update over the padded edge layout.

    Returns ``(excl_sign, excl_min)`` per slot of ``M`` [..., m, dc]. The
    padding magnitude is a large finite value (inf would turn a degree-1
    check's extrinsic into inf and L - E into NaN); the total sign is a
    negative-count parity; a slot holding the unique minimum takes the
    second minimum, every other slot the minimum (a tied minimum leaves
    every slot the minimum), as ``spa.py:127-155`` builds it from masks."""
    pad_mag = torch.tensor(1e30, dtype=dtype, device=M.device)
    one = torch.ones((), dtype=dtype, device=M.device)
    sgn = torch.where(slot_valid, _signs(M), one)
    mag = torch.where(slot_valid, torch.abs(M), pad_mag)
    neg = (sgn < 0).sum(dim=-1, keepdim=True, dtype=torch.int32)
    total_sign = (1 - 2 * (neg % 2)).to(dtype)
    excl_sign = total_sign * sgn
    min1 = mag.amin(dim=-1, keepdim=True)
    is_min = mag == min1
    multi = is_min.sum(dim=-1, keepdim=True) > 1
    min2 = torch.where(is_min, pad_mag, mag).amin(dim=-1, keepdim=True)
    excl_min = torch.where(is_min & ~multi, min2, min1)
    return excl_sign, excl_min


def posterior_sum(E_pad: torch.Tensor, var_edge: torch.Tensor) -> torch.Tensor:
    """``sum(E_pad[:, var_edge], -1)`` [B, n] in XLA's order on the CPU:
    one slot gathered at a time, folded in sequential blocks of
    :data:`SUM_BLOCK` slots, the block sums folded in order."""
    dv = var_edge.shape[1]
    total = None
    for lo in range(0, dv, SUM_BLOCK):
        acc = E_pad.index_select(1, var_edge[:, lo])
        for j in range(lo + 1, min(dv, lo + SUM_BLOCK)):
            acc = acc + E_pad.index_select(1, var_edge[:, j])
        total = acc if total is None else total + acc
    return total


def _done0(skip, B: int, device) -> torch.Tensor:
    """Every codeword pre-marked done under ``skip`` (the loop exits before
    iteration 0; the outputs are placeholders the caller discards)."""
    if skip is None:
        return torch.zeros(B, dtype=torch.bool, device=device)
    return torch.full((B,), bool(skip), dtype=torch.bool, device=device)


def _as_long(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int64))


class FloodingDecoder(torch.nn.Module):
    """``decoder(llr: [B, n], skip=None) -> DecodeResult``: flooding
    decoding over an EdgeLayout (``spa.py:158-350``), built by
    :func:`make_decoder`.

    Input LLRs follow the channel's convention LLR > 0 <=> bit 1. ``rule``
    'exact' negates them into the log(p0/p1) domain, where the product rule
    is the true parity update, and decides bit = L < 0; 'legacy' keeps the
    reference's log(p1/p0) messages and its decision bit = L >= 0. ``alpha``
    is a scalar or a [T] / [T, D] schedule of normalized min-sum
    (``alpha[min(it, T-1)]``, per check-degree class for [T, D]).
    ``quantize_msgs`` is an elementwise function applied to the var->check
    messages at the start of every iteration (message-precision studies).
    ``early_exit=False`` runs every iteration."""

    def __init__(self, layout, info_pos, max_iterations: int,
                 variant: str = "spa", *, rule: str = "exact",
                 alpha=0.75, beta: float = 0.15, dtype=torch.float32,
                 early_exit: bool = True,
                 quantize_msgs: Callable | None = None):
        super().__init__()
        variant = variant.lower().replace("-", "_")
        if rule not in ("exact", "legacy"):
            raise ValueError(f"Unknown check-node rule: {rule}")
        if variant not in ("spa", "minsum", "normalized_minsum",
                           "offset_minsum"):
            raise ValueError(f"Unknown decoder variant: {variant}")
        self.variant, self.rule = variant, rule
        self.n, self.m, self.dc = layout.n, layout.m, layout.dc
        self.max_iterations = int(max_iterations)
        self.beta = float(beta)
        self.dtype = dtype
        self.early_exit = bool(early_exit)
        self.quantize_msgs = quantize_msgs
        self.prod_clip = _prod_clip(dtype)
        self.slice_rows = max(1, SLICE_ELEMS // max(self.m * self.dc, 1))
        # 'exact': the log(p0/p1) domain; 'legacy': the reference's
        self.conv_sign = -1.0 if rule == "exact" else 1.0
        self.register_buffer("chk_var", _as_long(layout.chk_var))
        self.register_buffer("var_edge", _as_long(layout.var_edge))
        self.register_buffer("slot_valid",
                             torch.as_tensor(np.asarray(layout.chk_var)
                                             < layout.n))
        info = np.asarray(info_pos, np.int64)
        self.k = int(info.shape[0])
        self.register_buffer("info_pos", torch.as_tensor(info))
        # the flip count over k as XLA computes it, a product with 1/k in
        # the message dtype; a tensor, so that the card and the CPU agree
        self.register_buffer("inv_k", torch.tensor(1.0 / max(self.k, 1),
                                                   dtype=torch.float64).to(dtype))
        self.alpha = None
        self.register_buffer("alpha_seq", None)
        self.register_buffer("deg_idx", None)
        if np.ndim(alpha) > 0:
            if variant != "normalized_minsum":
                raise ValueError(
                    "per-iteration alpha requires variant='normalized_minsum'")
            seq = torch.as_tensor(np.asarray(alpha, np.float64)).to(dtype)
            if seq.dim() == 2:
                idx, degrees = check_degree_classes(layout)
                if seq.shape[1] != len(degrees):
                    raise ValueError(
                        f"alpha has {seq.shape[1]} degree classes but the "
                        f"graph has {len(degrees)} distinct check degrees "
                        f"{degrees}")
                self.deg_idx = _as_long(idx)
            self.alpha_seq = seq
        else:
            self.alpha = float(alpha)

    def check_node_update(self, M: torch.Tensor, alpha_t=None) -> torch.Tensor:
        valid = self.slot_valid
        dtype = self.dtype
        if self.variant == "spa":
            pc = self.prod_clip
            t = torch.tanh(torch.clamp(M / 2.0, -TANH_IN_CLIP, TANH_IN_CLIP))
            t = torch.clamp(t, -pc, pc)
            t = torch.where(valid, t, torch.ones((), dtype=dtype,
                                                 device=M.device))
            prod = torch.clamp(_exclusive_prod(t), -pc, pc)
            # 2*atanh(p) in log form, as the JAX decoder writes it
            return torch.log((1.0 + prod) / (1.0 - prod))
        excl_sign, excl_min = minsum_excl_update(M, valid, dtype)
        if self.variant == "normalized_minsum":
            a = alpha_t if alpha_t is not None else torch.tensor(
                self.alpha, dtype=dtype, device=M.device)
            excl_min = a * excl_min
        elif self.variant == "offset_minsum":
            excl_min = torch.clamp_min(excl_min - self.beta, 0.0)
        return excl_sign * excl_min

    def forward(self, llr: torch.Tensor, skip=None) -> DecodeResult:
        if llr.device != self.chk_var.device:
            raise ValueError(f"llr is on {llr.device}, the decoder on "
                             f"{self.chk_var.device}")
        B = llr.shape[0]
        if B <= self.slice_rows:
            return self._decode(llr, skip)
        parts = [self._decode(llr[i:i + self.slice_rows], skip)
                 for i in range(0, B, self.slice_rows)]
        return DecodeResult(
            ok=torch.cat([p.ok for p in parts]),
            est=torch.cat([p.est for p in parts]),
            conv_iter=torch.cat([p.conv_iter for p in parts]),
            norm_llr=torch.cat([p.norm_llr for p in parts]),
            iters_run=torch.stack([p.iters_run for p in parts]).amax())

    def _decode(self, llr: torch.Tensor, skip) -> DecodeResult:
        dev, dtype = llr.device, self.dtype
        chk_var, valid = self.chk_var, self.slot_valid
        llr = self.conv_sign * llr.to(dtype)
        B, n = llr.shape
        m, dc = self.m, self.dc
        zero = torch.zeros((), dtype=dtype, device=dev)
        llr_pad = torch.nn.functional.pad(llr, (0, 1))  # sentinel var n -> 0
        M = llr_pad[:, chk_var]  # [B, m, dc]
        done = _done0(skip, B, dev)
        est = torch.zeros((B, n), dtype=torch.uint8, device=dev)
        conv = torch.full((B,), -1, dtype=torch.int32, device=dev)
        prior = llr  # prior posterior: the channel LLRs (spa_decoder.py:95)
        norm = torch.zeros(B, dtype=dtype, device=dev)
        it = 0
        while it < self.max_iterations and not (
                self.early_exit and bool(done.all())):
            active = ~done
            if self.quantize_msgs is not None:
                M = self.quantize_msgs(M)
            a_t = None
            if self.alpha_seq is not None:
                a_t = self.alpha_seq[min(it, self.alpha_seq.shape[0] - 1)]
                if self.deg_idx is not None:
                    # one weight per check row, over batch and slot axes
                    a_t = a_t[self.deg_idx][None, :, None]
            E = torch.where(valid, self.check_node_update(M, a_t), zero)

            # posterior: L = llr + the sum of incoming E per variable
            E_pad = torch.nn.functional.pad(E.reshape(B, m * dc), (0, 1))
            L = llr + posterior_sum(E_pad, self.var_edge)
            if self.rule == "exact":
                est_bit = (L < 0).to(torch.uint8)  # log(p0/p1) < 0 <=> bit 1
            else:
                est_bit = (L >= 0).to(torch.uint8)  # z ^ 1 (spa_decoder.py:188)

            # syndrome of est_bit over the decode graph
            est_pad = torch.nn.functional.pad(est_bit, (0, 1))
            par = est_pad[:, chk_var].sum(dim=-1, dtype=torch.int32) % 2
            ok_now = (par == 0).all(dim=-1)

            # normalized-LLR bookkeeping on the info bits
            L_info = L.index_select(1, self.info_pos)
            prior_info = prior.index_select(1, self.info_pos)
            flips = (L_info.abs() <= LLR_WINDOW) & (prior_info * L_info < 0)
            nl = flips.sum(dim=-1).to(dtype) * self.inv_k

            # freeze the outputs of codewords that were already done
            est = torch.where(active[:, None], est_bit, est)
            conv = torch.where(active & ok_now,
                               torch.full_like(conv, it), conv)
            norm = torch.where(active, nl, norm)
            done = done | ok_now

            # variable-node update for the next iteration
            L_pad = torch.nn.functional.pad(L, (0, 1))
            M = torch.where(active[:, None, None], L_pad[:, chk_var] - E, M)
            prior = torch.where(active[:, None], L, prior)
            it += 1
        return DecodeResult(ok=done, est=est, conv_iter=conv, norm_llr=norm,
                            iters_run=torch.tensor(it, dtype=torch.int32,
                                                   device=dev))


class BitflipDecoder(torch.nn.Module):
    """Gallager-B hard-decision bit-flipping (``spa.py:353-433``), built by
    :func:`make_bitflip_decoder`: each iteration flips every bit whose
    count of unsatisfied checks is the largest (and above 0), until the
    syndrome clears. The first estimate is ``llr >= 0`` with no sign flip;
    a syndrome check after the loop catches codewords that cleared on the
    last flip."""

    def __init__(self, layout, info_pos, max_iterations: int):
        super().__init__()
        n, m, dc = layout.n, layout.m, layout.dc
        self.n, self.m = n, m
        self.max_iterations = int(max_iterations)
        # check id per variable slot; padding slots point at sentinel m
        edge_chk = np.arange(m * dc, dtype=np.int64) // max(dc, 1)
        var_chk = np.full(np.shape(layout.var_edge), m, np.int64)
        valid = layout.var_edge < m * dc
        var_chk[valid] = edge_chk[layout.var_edge[valid]]
        self.register_buffer("chk_var", _as_long(layout.chk_var))
        self.register_buffer("var_chk", torch.as_tensor(var_chk))

    def _parity(self, est: torch.Tensor) -> torch.Tensor:
        est_pad = torch.nn.functional.pad(est, (0, 1))
        return est_pad[:, self.chk_var].sum(dim=-1, dtype=torch.int32) % 2

    def forward(self, llr: torch.Tensor, skip=None) -> DecodeResult:
        if llr.device != self.chk_var.device:
            raise ValueError(f"llr is on {llr.device}, the decoder on "
                             f"{self.chk_var.device}")
        dev = llr.device
        B = llr.shape[0]
        est = (llr >= 0).to(torch.uint8)
        done = _done0(skip, B, dev)
        conv = torch.full((B,), -1, dtype=torch.int32, device=dev)
        it = 0
        while it < self.max_iterations and not bool(done.all()):
            par = self._parity(est)  # [B, m]
            ok_now = (par == 0).all(dim=-1)
            conv = torch.where(~done & ok_now, torch.full_like(conv, it), conv)
            done_next = done | ok_now
            # unsatisfied-check count per variable; flip the argmax set
            par_pad = torch.nn.functional.pad(par, (0, 1))  # sentinel -> 0
            unsat = par_pad[:, self.var_chk].sum(dim=-1)  # [B, n]
            mu = unsat.amax(dim=-1, keepdim=True)
            flip = (unsat == mu) & (mu > 0)
            est_next = torch.where(flip, est ^ 1, est)
            est = torch.where(done_next[:, None], est, est_next)
            done = done_next
            it += 1
        # est has been through `it` flip rounds: a clear syndrome now
        # converged at round `it`
        ok_final = (self._parity(est) == 0).all(dim=-1)
        conv = torch.where(~done & ok_final, torch.full_like(conv, it), conv)
        done = done | ok_final
        return DecodeResult(
            ok=done, est=est, conv_iter=conv,
            norm_llr=torch.zeros(B, dtype=torch.float32, device=dev),
            iters_run=torch.tensor(it, dtype=torch.int32, device=dev))


def make_decoder(layout, info_pos, max_iterations: int, variant: str = "spa",
                 *, rule: str = "exact", alpha=0.75, beta: float = 0.15,
                 dtype=torch.float32, early_exit: bool = True,
                 quantize_msgs: Callable | None = None,
                 device: str | torch.device | None = None):
    """The flooding decoder over ``layout`` on ``device`` (``None``: the
    card), or the bit-flipping decoder for ``variant='bitflipping'``
    (``spa.py:158-200``). See :class:`FloodingDecoder`."""
    dev = resolve_device(device)
    v = variant.lower().replace("-", "_")
    if v in ("bitflipping", "bit_flipping"):
        return make_bitflip_decoder(layout, info_pos, max_iterations,
                                    device=dev)
    return FloodingDecoder(
        layout, info_pos, max_iterations, v, rule=rule, alpha=alpha,
        beta=beta, dtype=dtype, early_exit=early_exit,
        quantize_msgs=quantize_msgs).to(dev)


def make_bitflip_decoder(layout, info_pos, max_iterations: int, *,
                         device: str | torch.device | None = None):
    """The bit-flipping decoder on ``device`` (``None``: the card)."""
    return BitflipDecoder(layout, info_pos, max_iterations).to(
        resolve_device(device))
