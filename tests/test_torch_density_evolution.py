"""The port's density evolution (``ldpc_tpu_torch.analysis.
density_evolution``) on the CPU, against the JAX package's.

The erasure channel's DE is exact arithmetic in both: its fixed points and
thresholds must agree within 1e-9. The Gaussian DE is sampled: handed the
JAX function's own draws (its normals and resample indices, regenerated
from its key schedule), the port's (3,6) threshold by the same bisection is
within 0.05 dB of the JAX one. On its own generator the port's estimate is
another sample (it spreads by about 0.1 dB over seeds at these sizes), so it
is held only to values far from the threshold.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from ldpc_tpu.analysis import density_evolution as jde
from ldpc_tpu.models.qc import detect_qc as j_detect_qc
from ldpc_tpu.models.standards import wimax as j_wimax
from ldpc_tpu_torch.analysis import density_evolution as tde
from ldpc_tpu_torch.models.qc import detect_qc
from ldpc_tpu_torch.models.standards import wimax

torch.set_num_threads(1)


def _graphs():
    return [
        (tde.regular_protograph(3, 6), jde.regular_protograph(3, 6)),
        (tde.regular_protograph(4, 8), jde.regular_protograph(4, 8)),
        (detect_qc(wimax(576, "1/2")), j_detect_qc(j_wimax(576, "1/2"))),
    ]


@pytest.mark.parametrize("dv,dc", [(3, 6), (4, 8), (3, 4), (2, 7)])
def test_regular_protograph_equal(dv, dc):
    assert tde.regular_protograph(dv, dc) == jde.regular_protograph(dv, dc)


@pytest.mark.parametrize("g", range(3))
@pytest.mark.parametrize("eps", [0.2, 0.42, 0.43, 0.6])
def test_bec_fixed_point_equal(g, eps):
    t, j = _graphs()[g]
    assert abs(tde.bec_erasure_fixed_point(t, eps)
               - jde.bec_erasure_fixed_point(j, eps)) <= 1e-9


@pytest.mark.parametrize("g", range(3))
def test_bec_threshold_equal(g):
    t, j = _graphs()[g]
    got = tde.bec_threshold(t)
    assert abs(got - jde.bec_threshold(j)) <= 1e-9
    if g == 0:
        assert got == pytest.approx(0.4294, abs=1e-3)


class JaxDraws:
    """The draws of ``jde._de_run`` in its order: the normals from the
    first split of the seed's key, then per iteration a three-way split
    whose first two keys draw the two resamples' indices."""

    def __init__(self, seed, device):
        self.key = jax.random.key(seed)
        self.device = device
        self.pending = []

    def normal(self, shape):
        k0, self.key = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.normal(k0, shape)))

    def randint(self, high, shape):
        if not self.pending:
            k1, k2, self.key = jax.random.split(self.key, 3)
            self.pending = [k1, k2]
        k = self.pending.pop(0)
        return torch.from_numpy(np.array(jax.random.randint(k, shape, 0, high),
                                         np.int64))


def test_gaussian_threshold_3_6_within_0_05_db():
    kw = dict(rate=0.5, lo_db=0.5, hi_db=2.0, tol_db=0.06, iterations=100,
              n_samples=8000)
    j = jde.protograph_threshold(jde.regular_protograph(3, 6), **kw)
    t = tde.protograph_threshold(tde.regular_protograph(3, 6), device="cpu",
                                 draws=JaxDraws, **kw)
    assert abs(t - j) <= 0.05, (t, j)


def test_de_far_from_threshold_and_bracket_errors():
    proto = tde.regular_protograph(3, 6)
    kw = dict(iterations=60, n_samples=4000, device="cpu")
    assert tde.de_error_probability(proto, 3.0, 0.5, **kw) < 1e-4
    assert tde.de_error_probability(proto, -1.0, 0.5, **kw) > 0.01
    # a repeat with the same seed draws the same samples
    assert tde.de_error_probability(proto, 1.0, 0.5, **kw) == \
        tde.de_error_probability(proto, 1.0, 0.5, **kw)
    for lo, hi in ((-2.0, 0.0), (3.0, 5.0)):
        with pytest.raises(ValueError, match="BP threshold"):
            tde.protograph_threshold(proto, 0.5, lo_db=lo, hi_db=hi,
                                     iterations=60, n_samples=2000,
                                     device="cpu")
