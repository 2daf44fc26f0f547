"""Batched interleavers as permutation gathers and scatters.

Counterpart of ``ldpc_tpu/ops/interleave.py`` (the numpy permutations are
copied, so the same ``seed`` gives the JAX package's permutation exactly).
Convention of the reference's random interleaver
(`python_ldpc_app/interleavers.py:29-53`):

  interleave (bits, before the channel):  out[i]     = bits[pi[i]]
  deinterleave (LLRs, after the channel): out[pi[i]] = llr[i]

Types: ``none``; ``regular`` (row/column block interleaver, rows the
largest divisor of n at most sqrt(n)); ``random`` (a fresh uniform
permutation per codeword: argsort of uniforms drawn from the batch's
generator); ``srandom`` (spread-S, cooldown construction, drawn once per run
from ``numpy.random.default_rng(seed)``); ``file:<perm.npy>`` (a static
permutation from a file, checked to be one).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def regular_dims(n: int) -> tuple[int, int]:
    """Largest rows <= sqrt(n) that divides n; cols = n // rows."""
    rows = int(math.sqrt(n))
    while rows > 0 and n % rows != 0:
        rows -= 1
    if rows <= 0:
        return 0, 0
    return rows, n // rows


def regular_permutation(n: int) -> np.ndarray:
    """pi such that out[i] = bits[pi[i]] reproduces the reference's regular
    interleaver output order (new[col*rows + row] = old[row*cols + col])."""
    rows, cols = regular_dims(n)
    if rows == 0 or cols == 0:
        return np.arange(n, dtype=np.int32)
    return np.arange(n, dtype=np.int32).reshape(rows, cols).T.ravel()


def srandom_permutation(n: int, s: int, seed: int = 0) -> np.ndarray:
    """Spread-S permutation: any two source positions selected within s
    consecutive output slots are at distance >= s (cooldown construction)."""
    rng = np.random.default_rng(seed)
    cooldown = np.zeros(n, dtype=np.int64)  # 0 = free, -1 = taken, >0 cooling
    pi = np.zeros(n, dtype=np.int32)
    filled = 0
    while filled < n:
        cooling = cooldown > 0
        cooldown[cooling] -= 1
        free = np.nonzero(cooldown == 0)[0]
        if free.size == 0:
            continue  # let counters cool one step (matches reference loop)
        z = int(free[rng.integers(0, free.size)])
        cooldown[z] = -1
        lo, hi = max(0, z - s + 1), min(n - 1, z + s - 1)
        window = cooldown[lo : hi + 1]
        window[window != -1] = s
        pi[filled] = z
        filled += 1
    return pi


def load_permutation(path: str, n: int) -> np.ndarray:
    """A static permutation of 0..n-1 from a ``.npy`` file."""
    pi = np.load(path).astype(np.int32)
    if sorted(pi.tolist()) != list(range(n)):
        raise ValueError(
            f"file:{path}: not a permutation of 0..{n - 1} (shape {pi.shape})"
        )
    return pi


def static_permutation(kind: str, n: int, s_param: int = 2,
                       seed: int = 0) -> np.ndarray | None:
    """The fixed permutation pi [n] of ``regular``, ``srandom`` and
    ``file:``; None for ``none`` and ``random``. Raises on an unknown
    kind."""
    kind_l = kind.lower()
    if kind_l in ("none", "random"):
        return None
    if kind_l == "regular":
        return regular_permutation(n)
    if kind_l == "srandom":
        return srandom_permutation(n, s_param, seed)
    if kind_l.startswith("file:"):
        return load_permutation(kind[5:], n)
    raise ValueError(f"Unknown interleaver type: {kind}")


def random_permutation(generator: torch.Generator, shape) -> torch.Tensor:
    """A uniform permutation per row, int64 ``shape``: the argsort of iid
    uniforms drawn from ``generator`` on its device."""
    u = torch.rand(tuple(shape), generator=generator, device=generator.device,
                   dtype=torch.float32)
    return torch.argsort(u, dim=-1)


def make_interleaver(kind: str, n: int, s_param: int = 2, seed: int = 0,
                     device: str | torch.device = "cpu",
                     pi_np: np.ndarray | None = None):
    """Build ``(interleave, deinterleave)`` for tensors [B, n].

    ``interleave(generator, bits) -> (bits_interleaved, state)`` and
    ``deinterleave(state, llr) -> llr_deinterleaved``; ``state`` is the
    per-codeword permutation (int64 [B, n]) for ``random``, else None. Only
    ``random`` draws from the generator. ``pi_np`` is the fixed permutation
    of ``regular`` / ``srandom`` / ``file:`` where the caller has already
    made it (:func:`static_permutation`).
    """
    if pi_np is None:
        pi_np = static_permutation(kind, n, s_param, seed)

    if kind.lower() == "random":
        def interleave(generator, bits):
            pi_b = random_permutation(generator, bits.shape)
            return torch.gather(bits, -1, pi_b), pi_b

        def deinterleave(pi_b, llr):
            return torch.empty_like(llr).scatter_(-1, pi_b, llr)

        return interleave, deinterleave

    if pi_np is None:  # none
        def interleave(generator, bits):
            return bits, None

        def deinterleave(state, llr):
            return llr

        return interleave, deinterleave

    pi = torch.as_tensor(pi_np.astype(np.int64), device=device)
    inv = torch.as_tensor(np.argsort(pi_np).astype(np.int64), device=device)

    def interleave(generator, bits):
        return bits.index_select(-1, pi), None

    def deinterleave(state, llr):
        # out[pi[i]] = llr[i]  <=>  out = llr[inv]
        return llr.index_select(-1, inv)

    return interleave, deinterleave
