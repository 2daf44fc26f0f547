"""Reference-compatible Park-Miller LCG + Box-Muller noise source.

The reference's channel modes 2/3 draw their Gaussians from a "minimal
standard" Park-Miller LCG (Schrage's factorization: a=16807, q=127773,
r=2836, m=2^31-1) fed through a Box-Muller transform that uses the cosine
branch for even bit indices and the sine branch for odd ones
(`python_ldpc_app/generator.py:15-32`), seeded with the fixed constants
IDUM1=83685 / IDUM2=11111 (`constants.py:2-3`).

A copy of ``ldpc_tpu/utils/legacy_rng.py`` (numpy only). The port's
channels draw from ``torch.Generator`` streams and in-kernel Philox (the
reference re-seeds this LCG identically per channel instance, so its
multiprocess path replays the same noise in every block). This module exists
for behavioral parity work: reproducing the reference's exact noise streams
on the host, e.g. to replicate single-thread runs sample for sample. Held
against the JAX package's copy in tests/test_torch_legacy_rng.py.
"""

from __future__ import annotations

import math

import numpy as np

# fixed seeds of the reference's two channel generators (constants.py:2-3)
IDUM1 = 83685
IDUM2 = 11111

_A = 16807
_Q = 127773
_R = 2836
_M = 2147483647  # 2^31 - 1


class ParkMillerGauss:
    """Stateful scalar generator with the reference's exact semantics."""

    def __init__(self, idum: int, sigma: float):
        self.idum = int(idum)
        self.sigma = float(sigma)

    def ran(self) -> float:
        """Uniform in (0, 1): one Park-Miller step via Schrage's method."""
        k = self.idum // _Q
        self.idum = _A * (self.idum - k * _Q) - _R * k
        if self.idum < 0:
            self.idum += _M
        # multiply-by-reciprocal, matching the reference's rounding
        # (generator.py:21: ans = (1.0 / 2147483647) * idum)
        return (1.0 / _M) * self.idum

    def gauss(self, bit_index: int) -> float:
        """Box-Muller sample; even bit indices take the cosine branch, odd
        the sine branch (generator.py:24-32)."""
        # the math module matches the reference's libm bit-for-bit; numpy's
        # vectorized transcendentals differ by 1 ulp on rare inputs
        magnitude = self.sigma * math.sqrt(-2.0 * math.log(self.ran()))
        angle = 2.0 * math.pi * self.ran()
        branch = math.cos(angle) if bit_index % 2 == 0 else math.sin(angle)
        return magnitude * branch

    def gauss_sequence(self, count: int, start_index: int = 0) -> np.ndarray:
        """The noise stream a reference channel would apply to ``count``
        consecutive bits starting at ``start_index``."""
        return np.array(
            [self.gauss(start_index + i) for i in range(count)], dtype=np.float64
        )


def lcg_stream(idum: int, count: int) -> np.ndarray:
    """Vectorized raw LCG stream (uniforms in (0,1)) for analysis/tests."""
    out = np.empty(count, dtype=np.float64)
    state = int(idum)
    for i in range(count):
        k = state // _Q
        state = _A * (state - k * _Q) - _R * k
        if state < 0:
            state += _M
        out[i] = (1.0 / _M) * state
    return out
