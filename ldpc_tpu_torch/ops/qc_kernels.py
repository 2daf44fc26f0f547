"""The standalone QC decoder (CUDA) and its plain PyTorch version.

Replaces the Pallas kernel ``ldpc_tpu/ops/spa_pallas.py:626``
``make_qc_decoder`` (kernel body ``:686-708``, ``pallas_call`` ``:710``), the
decoder of every run the fused Monte-Carlo kernels cannot take: interleavers,
Gray QAM, shorten/puncture, ``fused='off'``, the flooding schedule and the
normalized-LLR metric. :class:`QCDecoder` decodes given channel LLRs with the
layered (serial or paired groups, ``check_every``) or the flooding schedule,
a scalar or scheduled alpha and f32 or int8 extrinsics, and returns the hard
decisions, ok, the convergence iteration, the normalized-LLR flip metric and
the trip count.

The kernel (``qc_decoder_kernel`` in ``csrc/qc_decoder.cu``) runs the
``decode_group`` body of the fused kernels K1 / K2, with the flooding
schedule and the flip metric brought into it. What bounds it on the card: as
for them, a chain of dependent steps per codeword (a layer, or a flooding
sweep's check then posterior phase), each a gather along Z, a leave-one-out
combine and a scatter with a barrier between; its device-memory traffic is
the LLRs in and the decisions out. So it is bound by operations and by the
latency of those steps. Its design is theirs (the source's note has the
detail): a block is one barrier group (:func:`~mc_kernels.fused_plan`: one
codeword of 96 threads at WiMAX 1152 paired or flooding, 64 serial; the
codewords that share a warp at small Z) that leaves once its codewords pass
the syndrome check; no spills at row degree 8; the gather offsets staged in
shared memory; the block's codewords, adjacent rows of the [B, n] LLRs and
decisions, read and written as one contiguous range. A block's posteriors L
and extrinsics E stay in shared memory for the whole decode; the channel
LLRs that every flooding sweep restarts from are read from the input in
device memory, and the flip metric's previous posteriors are an internal
[B, n] buffer there. The flip metric is compiled in only where it is used.
A code whose block does not fit raises with its bytes; it never decodes
wrong.

The wrapper takes its plain version for a tensor on the CPU and launches the
kernel for a CUDA tensor (it raises on what the kernel does not take; there
is no fallback). ``QC_KERNEL.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from ldpc_tpu_torch.models.qc import QCLayout
from ldpc_tpu_torch.ops.build import Kernel
from ldpc_tpu_torch.ops.mc_kernels import K_QC, LOOP_ARGS, DecodeConfig
from ldpc_tpu_torch.ops.spa import DecodeResult

_P = ctypes.c_void_p
_I = ctypes.c_int

QC_KERNEL = Kernel(
    "qc_decoder", "qc_decoder_launch",
    [_P, _P,  # llr, prior
     _P, _P, _P, _P, _P]  # est ok conv norm iters
    + LOOP_ARGS
    + [_I,  # skip
       _I, _P],  # device stream
)


class QCDecoder(DecodeConfig):
    """``decode(llr, skip=None) -> DecodeResult`` for one QC code.

    ``llr`` f32 [B, n] follows the channel convention (LLR > 0 <=> bit 1)
    and is negated inside into log(p0/p1), as ``spa_pallas.py:718`` does;
    the parity rule is the exact one. ``skip`` nonzero pre-marks every lane
    done (the loop exits before iteration 0; outputs are placeholders).
    ``info_pos`` locates the info bits the normalized-LLR metric counts
    (``track_norm``). ``alpha`` is a scalar or a [T] / [T, D] schedule of
    normalized min-sum; ``msg_store='int8'`` (min-sum family) stores E as
    int8. ``plan`` is the kernel's block (:func:`~mc_kernels.fused_plan`);
    the plain version runs blocks of its ``lanes`` codewords, so even the
    per-codeword trip counts of :meth:`outputs` agree.
    """

    kind = K_QC

    def __init__(self, qc: QCLayout, info_pos, max_iterations: int,
                 variant: str = "spa", *, alpha=0.75,
                 beta: float = 0.15, schedule: str = "flooding",
                 track_norm: bool = True, msg_store: str = "f32",
                 layer_groups=None, check_every: int = 1):
        super().__init__(qc, info_pos, max_iterations, variant, alpha=alpha,
                         beta=beta, schedule=schedule,
                         layer_groups=layer_groups, check_every=check_every,
                         track_norm=track_norm, msg_store=msg_store)

    # ------------------------------------------------------------- calls --

    def __call__(self, llr: torch.Tensor, skip=None) -> DecodeResult:
        return self._result(*self.outputs(llr, skip))

    decode = __call__

    def outputs(self, llr: torch.Tensor, skip=None):
        """``(est, ok, conv, norm, iters)``: uint8 [B, n], bool, int32, f32
        and int32 [B] (``iters`` is the trip count of the codeword's block,
        its own at one codeword per block)."""
        if llr.device.type == "cpu":
            return self.plain_outputs(llr, skip)
        if llr.device.type != "cuda":
            raise ValueError(f"no kernel for device {llr.device}")
        return self._launch(llr, skip)

    def plain_outputs(self, llr: torch.Tensor, skip=None):
        """The kernel's arithmetic in PyTorch, on any device."""
        B = llr.shape[0]
        loop = self._dev(llr.device)[0]
        L = (-llr.to(torch.float32)).T.contiguous()
        done0 = torch.full((B,), bool(_skip(skip)), dtype=torch.bool,
                           device=llr.device)
        done, conv, iters, norm = loop.decode(L, done0)
        est = (L < 0).T.contiguous().to(torch.uint8)
        return est, done, conv, norm, iters

    @staticmethod
    def _result(est, ok, conv, norm, iters) -> DecodeResult:
        iters_run = (iters.max() if iters.numel()
                     else torch.zeros((), dtype=torch.int32, device=iters.device))
        return DecodeResult(ok=ok, est=est, conv_iter=conv, norm_llr=norm,
                            iters_run=iters_run)

    def _launch(self, llr: torch.Tensor, skip):
        dev = llr.device
        n = self.qc.n
        if llr.dtype != torch.float32:
            raise ValueError(f"llr has dtype {llr.dtype}, expected torch.float32")
        if llr.dim() != 2 or llr.shape[1] != n:
            raise ValueError(f"llr has shape {tuple(llr.shape)}, expected (B, {n})")
        if not llr.is_contiguous():
            raise ValueError("llr must be contiguous")
        B = llr.shape[0]
        est = torch.empty((B, n), dtype=torch.uint8, device=dev)
        ok = torch.empty(B, dtype=torch.bool, device=dev)
        conv = torch.empty(B, dtype=torch.int32, device=dev)
        norm = torch.empty(B, dtype=torch.float32, device=dev)
        iters = torch.empty(B, dtype=torch.int32, device=dev)
        if B == 0:  # nothing to launch
            return est, ok, conv, norm, iters
        args = self._loop_args(dev, B)
        # the flip metric's previous posteriors, codeword-major
        _, prior = self._buffers(B, dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            QC_KERNEL(
                llr.data_ptr(), None if prior is None else prior.data_ptr(),
                est.data_ptr(), ok.data_ptr(), conv.data_ptr(),
                norm.data_ptr(), iters.data_ptr(), *args,
                int(_skip(skip)), dev.index, stream,
            )
        return est, ok, conv, norm, iters


def _skip(skip) -> bool:
    """``skip`` as a host bool (a tensor is read back once)."""
    if skip is None:
        return False
    if isinstance(skip, torch.Tensor):
        return bool(skip.item())
    return bool(skip)
