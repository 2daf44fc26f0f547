"""Carry the JAX package's state into the port.

The simulator has no weights: its parameters are the parity-check matrix,
the encoder derived from it, and the per-SNR channel constants. These two
functions take them as plain numpy arrays (what the JAX package's
``LDPCCode.H.row_idx`` / ``H.col_idx`` and ``mc_pallas.consts_vector`` hold),
so a caller can show that both packages compute the same thing without the
port importing the other package.
"""

from __future__ import annotations

import numpy as np
import torch

from ldpc_tpu_torch.models.alist import AlistMatrix
from ldpc_tpu_torch.models.code import LDPCCode
from ldpc_tpu_torch.utils.device import resolve_device


def code_from_numpy(n: int, m: int, row_idx, col_idx,
                    name: str = "carried") -> LDPCCode:
    """Build the port's code from the (row, col) indices of H's ones."""
    rows = np.asarray(row_idx, dtype=np.int64)
    cols = np.asarray(col_idx, dtype=np.int64)
    if rows.shape != cols.shape or rows.ndim != 1:
        raise ValueError("row_idx and col_idx must be 1-D and equally long")
    if rows.size and (rows.min() < 0 or rows.max() >= m
                      or cols.min() < 0 or cols.max() >= n):
        raise ValueError(f"indices out of range for an {m} x {n} matrix")
    # the canonical form read_alist produces: row-major, no duplicates
    rows, cols = np.unique(np.stack([rows, cols]), axis=1)
    alist = AlistMatrix(n=int(n), m=int(m), row_idx=rows.astype(np.int32),
                        col_idx=cols.astype(np.int32))
    return LDPCCode(alist=alist, name=name)


def consts_from_numpy(vec8, device: str | torch.device | None = None) -> torch.Tensor:
    """The JAX package's f32 [8] channel-constant vector as the port's
    tensor (same order, ldpc_tpu_torch.ops.channel.CONSTS_ORDER)."""
    v = np.asarray(vec8, dtype=np.float32)
    if v.shape != (8,):
        raise ValueError(f"expected 8 channel constants, got shape {v.shape}")
    return torch.from_numpy(v.copy()).to(resolve_device(device))
