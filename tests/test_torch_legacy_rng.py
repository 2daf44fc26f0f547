"""The port's copy of the reference's Park-Miller LCG
(``ldpc_tpu_torch.utils.legacy_rng``) against the JAX package's.

Tolerance: none; the streams are equal element for element.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ldpc_tpu.utils import legacy_rng as jrng
from ldpc_tpu_torch.utils import legacy_rng as trng

torch.set_num_threads(1)


def test_seeds_are_the_reference_constants():
    assert (trng.IDUM1, trng.IDUM2) == (jrng.IDUM1, jrng.IDUM2)


@pytest.mark.parametrize("idum", [trng.IDUM1, trng.IDUM2, 1, 2147483646])
def test_lcg_stream_equal(idum):
    np.testing.assert_array_equal(trng.lcg_stream(idum, 2000),
                                  jrng.lcg_stream(idum, 2000))


@pytest.mark.parametrize("idum,sigma,start", [
    (trng.IDUM1, 0.7, 0), (trng.IDUM2, 1.3, 1), (12345, 2.0, 7)])
def test_gauss_sequence_equal(idum, sigma, start):
    t = trng.ParkMillerGauss(idum, sigma)
    j = jrng.ParkMillerGauss(idum, sigma)
    np.testing.assert_array_equal(t.gauss_sequence(512, start),
                                  j.gauss_sequence(512, start))
    # the generators' states advance alike
    assert t.idum == j.idum
    assert t.ran() == j.ran()
