"""The unfused path's Gray-QAM channel in one kernel (CUDA) and its plain
PyTorch version.

K6, ``qam_channel_kernel`` in ``csrc/qam_channel.cu``, replaces no Pallas
kernel: the JAX package leaves this chain to XLA. For a batch of codewords
it does in one pass per frame what the unfused path does in about 60
operators: the interleaver's gather (``ops.interleave``), the Gray mapping
(``ops.modem``), the noise variance and the noise of channel modes 1-3
(``ops.channel``), the max-log demap and the deinterleaver's scatter. What
bounds it on the card is bytes: the codeword, permutation and draws in and
the LLRs out, about 19 bytes a code bit for 16-QAM under mode 2 with a
permutation per frame; the operators wrote and read back every intermediate
through device memory. The source's note has the design.

:class:`QAMChannel` draws what the plain chain draws, with the same calls in
the same order and shapes, so the generators' streams do not move: the
random interleaver's uniforms and their argsort on the interleaver's
generator, then, on the channel's generator, the jam uniforms (mode 2), the
I normals and the Q normals, each [B, n/bps]. The kernel takes those draws;
a fixed permutation (``regular``, ``srandom``, ``file:``) goes in as one row
for every frame, ``none`` as the identity. The wrapper takes its plain
version (the chain itself) for a tensor on the CPU and launches the kernel
for a CUDA tensor, whose LLRs equal the plain version's there bit for bit;
it raises on what the kernel does not take, and there is no fallback.
``QAM_CHANNEL.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ldpc_tpu_torch.ops.build import Kernel, check_arg
from ldpc_tpu_torch.ops.channel import draw_normal, draw_uniform, make_channel_fn
from ldpc_tpu_torch.ops.interleave import (
    make_interleaver,
    random_permutation,
    static_permutation,
)
from ldpc_tpu_torch.ops.mc_kernels import _SMEM_LIMIT
from ldpc_tpu_torch.ops.modem import qam_spec

_P = ctypes.c_void_p
_I = ctypes.c_int

QAM_CHANNEL = Kernel(
    "qam_channel", "qam_channel_launch",
    [_P, _P, ctypes.c_longlong,  # w, pi, pi's row stride
     _P, _P, _P, _P, _P, _P,  # jam, z_i, z_q, consts, levels, out
     _I, _I, _I, _I, _I, _I,  # bps, mode, n, B, frames, threads
     _I, _P],  # device, stream
)

BLOCK_THREADS = 256  # a block's threads, at least: short frames share a block


class QAMChannel:
    """``channel(gen_il, gen_ch, w, consts) -> llr`` for one (mode, order,
    n, interleaver): code bits ``w`` f32 [B, n] in {0, 1} through the
    interleaver (drawing from ``gen_il``), Gray ``order``-QAM over channel
    ``mode`` at the f32 [8] ``consts`` (drawing from ``gen_ch``), the
    demap and the deinterleaver: f32 [B, n] LLRs, > 0 <=> bit 1.

    ``interleave`` / ``channel`` / ``deinterleave`` are the plain chain's
    pieces (``ops.interleave.make_interleaver``, ``ops.channel.
    make_channel_fn``)."""

    def __init__(self, mode: int, order: int, n: int, interleaver: str = "none",
                 *, s_param: int = 2, seed: int = 0,
                 device: str | torch.device = "cpu"):
        bps, levels, scale = qam_spec(order)
        if n % bps:
            raise ValueError(f"codeword length {n} not divisible by {bps} "
                             "bits/symbol")
        if mode not in (1, 2, 3):
            raise ValueError(f"Unknown channel mode: {mode}")
        self.mode, self.order, self.n, self.bps = mode, order, n, bps
        self.n_sym = n // bps
        self.random = interleaver.lower() == "random"
        pi_np = static_permutation(interleaver, n, s_param, seed)
        self.interleave, self.deinterleave = make_interleaver(
            interleaver, n, device=device, pi_np=pi_np)
        self.channel = make_channel_fn(mode, order, n=n)
        self._pi = None if pi_np is None else torch.as_tensor(
            pi_np.astype(np.int64), device=device)
        self._levels = torch.as_tensor((levels * scale).astype(np.float32),
                                       device=device)
        # the block: one frame, or as many as fill BLOCK_THREADS symbols
        self.frames = max(1, BLOCK_THREADS // self.n_sym)
        self.threads = min(1024, -(-self.frames * self.n_sym // 32) * 32)
        self.smem = 8 * self.frames * n  # codeword and LLR rows, f32

    def __call__(self, gen_il: torch.Generator, gen_ch: torch.Generator,
                 w: torch.Tensor, consts: torch.Tensor) -> torch.Tensor:
        check_arg(w, "w", torch.float32, ((_rows(w), self.n),), w.device)
        if w.device.type == "cpu":
            return self.plain(gen_il, gen_ch, w, consts)
        if w.device.type != "cuda":
            raise ValueError(f"no kernel for device {w.device}")
        return self.launch(w, *self.draws(gen_il, gen_ch, w.shape[0]), consts)

    def plain(self, gen_il, gen_ch, w, consts) -> torch.Tensor:
        """The chain in PyTorch, on any device: interleave, channel,
        deinterleave."""
        w_int, state = self.interleave(gen_il, w)
        return self.deinterleave(state, self.channel(gen_ch, w_int, consts))

    def draws(self, gen_il, gen_ch, B: int):
        """``(pi, jam, z_i, z_q)`` of a batch of ``B``, drawn as
        :meth:`plain` draws them: ``pi`` int64 [B, n] under the random
        interleaver, else the fixed [n] or None; ``jam`` (mode 2, else
        None), ``z_i`` and ``z_q`` f32 [B, n/bps]."""
        pi = random_permutation(gen_il, (B, self.n)) if self.random else self._pi
        shape = (B, self.n_sym)
        jam = draw_uniform(gen_ch, shape) if self.mode == 2 else None
        return pi, jam, draw_normal(gen_ch, shape), draw_normal(gen_ch, shape)

    def launch(self, w, pi, jam, z_i, z_q, consts) -> torch.Tensor:
        """K6 on the draws of :meth:`draws`: the LLRs f32 [B, n]. Raises on
        an argument the kernel would read out of bounds or misread: each
        must be contiguous, of its dtype and shape, on the device of
        ``w``."""
        if self.smem > _SMEM_LIMIT:
            raise ValueError(
                f"codeword n={self.n} does not fit one block of the QAM "
                f"channel kernel: {self.smem} bytes of shared memory (at most "
                f"{_SMEM_LIMIT})")
        dev, B = w.device, _rows(w)
        check_arg(w, "w", torch.float32, ((B, self.n),), dev)
        check_arg(pi, "pi", torch.int64, ((self.n,), (B, self.n)), dev,
               none_ok=True)
        if (jam is None) == (self.mode == 2):
            raise ValueError(f"jam is {'missing' if jam is None else 'given'}"
                             f" under channel mode {self.mode}: the jam "
                             "uniforms go with mode 2 alone")
        sym = ((B, self.n_sym),)
        check_arg(jam, "jam", torch.float32, sym, dev, none_ok=True)
        check_arg(z_i, "z_i", torch.float32, sym, dev)
        check_arg(z_q, "z_q", torch.float32, sym, dev)
        check_arg(consts, "consts", torch.float32, ((8,),), dev)
        if dev.type != "cuda":
            raise ValueError(f"no kernel for device {dev}")
        out = torch.empty_like(w)
        if B == 0:  # nothing to launch
            return out
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            QAM_CHANNEL(
                w.data_ptr(), None if pi is None else pi.data_ptr(),
                self.n if pi is not None and pi.dim() == 2 else 0,
                None if jam is None else jam.data_ptr(), z_i.data_ptr(),
                z_q.data_ptr(), consts.data_ptr(),
                self._levels.data_ptr(), out.data_ptr(), self.bps, self.mode,
                self.n, B, self.frames, self.threads, dev.index, stream,
            )
        return out


def _rows(w: torch.Tensor) -> int:
    """The batch of a [B, n] codeword tensor; -1 (matching no shape) for
    another rank."""
    return w.shape[0] if w.dim() == 2 else -1

