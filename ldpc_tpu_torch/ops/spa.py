"""Check-node constants, the decoders' result and the leave-one-out order.

Counterpart of ``ldpc_tpu/ops/spa.py:48-60, 89-110``. The decode loop's
plain version (ldpc_tpu_torch.ops.decode_loop) and the CUDA kernel
(csrc/decode_group.cuh) both evaluate the leave-one-out products and minima in
the order :func:`exclusive_combine` defines, the precondition for min-sum
results that are equal bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Reference clipping constants (spa_decoder.py:139-145,167); in float32 the
# tightest representable magnitude below 1 plays the role of PROD_CLIP.
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
