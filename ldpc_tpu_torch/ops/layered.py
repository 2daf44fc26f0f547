"""Layered (serial-C, row-layered) QC-LDPC decoding in plain PyTorch.

Counterpart of ``ldpc_tpu/ops/layered.py`` (``make_qc_layered_decoder``,
``:89-242``), the decoder of ``--kernel xla --schedule layered``. The JAX
package never wrote it as a Pallas kernel; it is the executable
specification the QC kernels are held to.

Each base row is a layer, swept in ``layer_order`` (default 0..mb-1); the
paired schedule of the QC kernels is this sweep in its flattened group
order. Per layer ``bi`` and slot ``j`` (base column ``c``, shift ``s``)::

    m_j   = roll(L[c], s) - E[bi, j]          # extrinsic prior
    E'    = check_update(m_1..m_d)            # SPA or the min-sum family
    L[c] := roll_inv(m_j + E'_j);  E[bi, j] := E'_j

where ``roll(x, s)[r] = x[(r + s) % Z]`` is ``torch.roll(x, -s, -1)``. A
layer that touches one base column at two shifts (multi-diagonal, CCSDS)
adds both circulants' deltas, ``L[c] += roll_inv(E' - E)``, in slot order.
The leave-one-out products and minima fold in :func:`exclusive_combine`
order, so the min-sum family is equal bit for bit to the JAX decoder and to
the QC kernels' plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from ldpc_tpu_torch.models.qc import QCLayout
from ldpc_tpu_torch.ops.decode_loop import resolve_alpha_schedule
from ldpc_tpu_torch.ops.spa import (
    LLR_WINDOW,
    PROD_CLIP_F32,
    TANH_IN_CLIP,
    DecodeResult,
    _done0,
    _signs,
    exclusive_combine,
)
from ldpc_tpu_torch.utils.device import resolve_device


def _check_update_list(msgs, variant, alpha, beta):
    """Leave-one-out check update over a list of [B, Z] tensors
    (``layered.py:49-86``)."""
    if variant == "spa":
        ts = [torch.clamp(torch.tanh(torch.clamp(m * 0.5, -TANH_IN_CLIP,
                                                 TANH_IN_CLIP)),
                          -PROD_CLIP_F32, PROD_CLIP_F32) for m in msgs]
        out = []
        for j, prod in enumerate(exclusive_combine(ts, torch.mul)):
            if prod is None:
                prod = torch.ones_like(msgs[j])
            prod = torch.clamp(prod, -PROD_CLIP_F32, PROD_CLIP_F32)
            out.append(torch.log((1.0 + prod) / (1.0 - prod)))
        return out
    excl_sgn = exclusive_combine([_signs(m) for m in msgs], torch.mul)
    excl_mag = exclusive_combine([torch.abs(m) for m in msgs], torch.minimum)
    out = []
    for j, (sgn, mag) in enumerate(zip(excl_sgn, excl_mag)):
        if sgn is None:
            sgn, mag = torch.ones_like(msgs[j]), torch.full_like(msgs[j], 1e30)
        if variant == "normalized_minsum":
            mag = alpha * mag
        elif variant == "offset_minsum":
            mag = torch.clamp_min(mag - beta, 0.0)
        out.append(sgn * mag)
    return out


def _roll(x: torch.Tensor, s: int) -> torch.Tensor:
    """``y[r] = x[(r + s) % Z]`` along the last axis."""
    return torch.roll(x, -s, -1)


def _unroll(x: torch.Tensor, s: int) -> torch.Tensor:
    return torch.roll(x, s, -1)


class QCLayeredDecoder(torch.nn.Module):
    """``decoder(llr: f32 [B, n], skip=None) -> DecodeResult``, built by
    :func:`make_qc_layered_decoder`.

    Input LLR > 0 <=> bit 1; the exact parity rule; ``conv_iter`` is the
    0-based sweep whose post-sweep syndrome cleared; ``iters_run`` the
    sweeps the batch ran. ``alpha`` is a scalar or a [T] / [T, D] schedule
    of normalized min-sum (``ops.decode_loop.resolve_alpha_schedule``)."""

    def __init__(self, qc: QCLayout, info_pos, max_iterations: int,
                 variant: str = "spa", *, alpha=0.75, beta: float = 0.15,
                 layer_order=None):
        super().__init__()
        variant = variant.lower().replace("-", "_")
        if variant not in ("spa", "minsum", "normalized_minsum",
                           "offset_minsum"):
            raise ValueError(f"Unknown decoder variant: {variant}")
        mb = qc.mb
        order = list(range(mb)) if layer_order is None else list(layer_order)
        if sorted(order) != list(range(mb)):
            raise ValueError(
                f"layer_order must permute base rows 0..{mb - 1}: {order!r}")
        self.qc, self.order, self.variant = qc, order, variant
        self.max_iterations = int(max_iterations)
        self.beta = float(beta)
        self.row_slots = qc.row_slots()
        self.dcb = max((len(r) for r in self.row_slots), default=1)
        info = np.asarray(info_pos, np.int64)
        self.register_buffer("info_pos", torch.as_tensor(info))
        # the flip count over k as XLA computes it, a product with f32 1/k
        self.register_buffer("inv_k", torch.tensor(
            1.0 / max(int(info.shape[0]), 1), dtype=torch.float32))
        arr, self.alpha_class = resolve_alpha_schedule(
            alpha, variant, [len(r) for r in self.row_slots])
        self.alpha = None if arr is not None else float(alpha)
        self.register_buffer(
            "alpha_seq", None if arr is None
            else torch.as_tensor(arr).to(torch.float32))

    def _alpha_of(self, it: int):
        if self.alpha_seq is None:
            return lambda bi: self.alpha
        row = self.alpha_seq[min(it, self.alpha_seq.shape[0] - 1)]
        if self.alpha_seq.dim() == 1:
            return lambda bi: row
        return lambda bi: row[self.alpha_class[bi]]

    def forward(self, llr: torch.Tensor, skip=None) -> DecodeResult:
        if llr.device != self.info_pos.device:
            raise ValueError(f"llr is on {llr.device}, the decoder on "
                             f"{self.info_pos.device}")
        qc = self.qc
        n, Z, nb, mb = qc.n, qc.Z, qc.nb, qc.mb
        dev = llr.device
        llr = -llr.to(torch.float32)  # exact rule: log(p0/p1) domain
        B = llr.shape[0]
        L = llr.reshape(B, nb, Z).clone()
        E = torch.zeros((B, mb, self.dcb, Z), dtype=torch.float32, device=dev)
        done = _done0(skip, B, dev)
        est = torch.zeros((B, n), dtype=torch.uint8, device=dev)
        conv = torch.full((B,), -1, dtype=torch.int32, device=dev)
        prior = L.clone()
        norm = torch.zeros(B, dtype=torch.float32, device=dev)
        it = 0
        while it < self.max_iterations and not bool(done.all()):
            active = ~done
            act = active[:, None]
            a_of = self._alpha_of(it)
            for bi in self.order:
                slots = self.row_slots[bi]
                if not slots:
                    continue
                msgs = [_roll(L[:, bj], s) - E[:, bi, j]
                        for j, (bj, s) in enumerate(slots)]
                e_new = _check_update_list(msgs, self.variant, a_of(bi),
                                           self.beta)
                if len({bj for bj, _ in slots}) < len(slots):
                    # multi-diagonal layer: both circulants' extrinsic
                    # deltas accumulate per base column, in slot order
                    deltas: dict[int, torch.Tensor] = {}
                    for j, (bj, s) in enumerate(slots):
                        d = _unroll(e_new[j] - E[:, bi, j], s)
                        deltas[bj] = d if bj not in deltas else deltas[bj] + d
                    for bj, d in deltas.items():
                        L[:, bj] = torch.where(act, L[:, bj] + d, L[:, bj])
                else:
                    for j, (bj, s) in enumerate(slots):
                        L[:, bj] = torch.where(
                            act, _unroll(msgs[j] + e_new[j], s), L[:, bj])
                for j in range(len(slots)):
                    E[:, bi, j] = torch.where(act, e_new[j], E[:, bi, j])

            L_flat = L.reshape(B, n)
            est_bit = (L_flat < 0).to(torch.uint8)

            # syndrome over the QC graph
            ok_now = torch.ones(B, dtype=torch.bool, device=dev)
            est_blk = est_bit.reshape(B, nb, Z)
            for bi in range(mb):
                parity = None
                for bj, s in self.row_slots[bi]:
                    b = _roll(est_blk[:, bj], s).to(torch.int32)
                    parity = b if parity is None else parity ^ b
                if parity is not None:  # an empty base row is satisfied
                    ok_now = ok_now & (parity == 0).all(dim=-1)

            L_info = L_flat.index_select(1, self.info_pos)
            prior_info = prior.reshape(B, n).index_select(1, self.info_pos)
            flips = (L_info.abs() <= LLR_WINDOW) & (prior_info * L_info < 0)
            nl = flips.sum(dim=-1).to(torch.float32) * self.inv_k

            est = torch.where(act, est_bit, est)
            conv = torch.where(active & ok_now, torch.full_like(conv, it), conv)
            norm = torch.where(active, nl, norm)
            prior = torch.where(active[:, None, None], L, prior)
            done = done | ok_now
            it += 1
        return DecodeResult(ok=done, est=est, conv_iter=conv, norm_llr=norm,
                            iters_run=torch.tensor(it, dtype=torch.int32,
                                                   device=dev))


def make_qc_layered_decoder(qc: QCLayout, info_pos, max_iterations: int,
                            variant: str = "spa", *, alpha=0.75,
                            beta: float = 0.15, layer_order=None,
                            device: str | torch.device | None = None):
    """The layered decoder of ``qc`` on ``device`` (``None``: the card).
    ``layer_order`` permutes the sweep over base rows; the QC kernels'
    paired schedule is its flattened group order."""
    return QCLayeredDecoder(qc, info_pos, max_iterations, variant,
                            alpha=alpha, beta=beta,
                            layer_order=layer_order).to(resolve_device(device))
