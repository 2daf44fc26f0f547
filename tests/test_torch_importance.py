"""The port's importance sampler (``ldpc_tpu_torch.analysis.importance``)
on the CPU, against the JAX package's.

``orbit_supports`` and ``census_supports`` are held to the JAX functions
exactly. The IS step is fed the JAX step's own draws (its info bits, normals
and component choices, regenerated from the same key), and its weights must
equal the JAX weights within 1e-6 (absolute: the weights lie in (0, 1/pi0];
f32 arithmetic in another order, a matrix product and a log-sum-exp); with
min-sum on both sides the decoded outcome (detected / wrong) is equal. The estimator's weights are bounded by
1/pi0 with mean 1, and its refusals carry the JAX text.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.analysis import importance as jis
from ldpc_tpu.ops.channel import ChannelParams as JParams
from ldpc_tpu.ops.encode import random_info_bits as j_info_bits
from ldpc_tpu.sim.config import SimOptions as JOptions
from ldpc_tpu.sim.runner import load_code as jload
from ldpc_tpu_torch.analysis import importance as tis
from ldpc_tpu_torch.sim.config import SimOptions
from ldpc_tpu_torch.sim.runner import load_code

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CCSDS = "builtin:CCSDS_ldpc_n32_k16.alist.txt"


def _kw(batch, iterations=8, **kw):
    return {**dict(matrix=CCSDS, blocks=batch, iterations=iterations,
                   ber=True, fer=True, fidelity="exact", exact_ber=True,
                   batch=batch, seed=0, speed=0.5, quiet=True), **kw}


@pytest.fixture(scope="module")
def ccsds():
    return load_code(CCSDS)


@pytest.mark.parametrize("supports,Z,n,cap", [
    ([[0, 5], [1]], 4, 32, None),
    ([[0, 1, 2, 3]], 4, 8, None),
    ([[3, 17, 40], [2, 11], [9]], 8, 64, 10),
    ([[1, 100, 575], [5, 6, 7, 8]], 24, 576, None),
])
def test_orbit_supports_equal(supports, Z, n, cap):
    np.testing.assert_array_equal(
        tis.orbit_supports(supports, Z, n, cap),
        jis.orbit_supports(supports, Z, n, cap))


def test_orbit_supports_refuse_empty_input():
    for mod in (tis, jis):
        with pytest.raises(ValueError, match="no non-empty supports"):
            mod.orbit_supports([[]], 4, 32)


@pytest.mark.parametrize("min_count,max_size", [(2, 16), (1, 24), (1, 2)])
def test_census_supports_equal(tmp_path, min_count, max_size):
    census = {"recurring_supports": [{"support": [3, 17, 40], "count": 4},
                                     [5, 9], {"support": list(range(20)),
                                              "count": 2}],
              "patterns": [{"support": [1, 2]}, [7], {"support": []},
                           list(range(30))]}
    paths = [str(tmp_path / "census.json"),
             os.path.join(REPO, "examples", "error_floor",
                          "undetected_codewords.json")]
    with open(paths[0], "w", encoding="utf-8") as f:
        json.dump(census, f)
    for path in paths:
        got = tis.census_supports(path, min_count, max_size)
        assert got == jis.census_supports(path, min_count, max_size)


@pytest.mark.parametrize("decoder,pi0", [("minsum", 0.2),
                                         ("normalized-minsum", 0.5)])
def test_is_step_weights_equal_the_jax_weights(ccsds, decoder, pi0):
    batch, snr = 256, 3.0
    kw = _kw(batch, decoder=decoder, kernel="xla")
    shifts = tis.orbit_supports([[0, 7, 19], [2, 11]], ccsds.qc.Z, ccsds.n)
    jstep, _ = jis.make_is_step(jload(CCSDS), JOptions(**kw), shifts, pi0=pi0)
    tstep, _ = tis.make_is_step(ccsds, SimOptions(**kw), shifts, pi0=pi0,
                                device="cpu")
    o = JOptions(**kw).resolved()
    jconsts = JParams(mode=1, modulation=1, speed=o.speed, snr_db=snr,
                      noise_model="exact").consts()
    tconsts = tis._consts(SimOptions(**kw).resolved(), snr, "cpu")
    key = jax.random.fold_in(jax.random.key(9), 4)
    jw, jdet, jwrong = (np.asarray(x) for x in jstep(key, jconsts))
    # the JAX step's own draws, as it makes them
    k_u, k_z, k_m = jax.random.split(key, 3)
    u = np.array(j_info_bits(k_u, batch, ccsds.k))
    z = np.array(jax.random.normal(k_z, (batch, ccsds.n), jnp.float32))
    r = jax.random.uniform(k_m, (batch,))
    comp = np.array(jnp.where(r < pi0, -1, jax.random.randint(
        jax.random.fold_in(k_m, 1), (batch,), 0, shifts.shape[0])))
    tw, tdet, twrong = (x.numpy() for x in tstep(
        0, tconsts, u=torch.from_numpy(u), z=torch.from_numpy(z),
        comp=torch.from_numpy(comp)))
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-6)
    assert tw.max() <= 1.0 / pi0 + 1e-6
    np.testing.assert_array_equal(tdet, jdet)
    np.testing.assert_array_equal(twrong, jwrong)
    assert (comp < 0).any() and (comp >= 0).any()


def test_weights_bounded_and_mean_one(ccsds):
    """Defensive mixture: w <= 1/pi0 always; E_q[w] ~ 1 (consistency)."""
    batch = 2048
    sups = tis.orbit_supports([[0, 3, 17]], ccsds.qc.Z, ccsds.n)
    res = tis.estimate_point(ccsds, SimOptions(**_kw(batch)), 3.0, sups,
                             frames=4 * batch, pi0=0.25, seed=1, device="cpu")
    assert res.frames == 4 * batch
    assert res.max_weight <= 1.0 / 0.25 + 1e-6
    assert abs(res.mean_weight - 1.0) < 0.05
    assert res.wer >= res.fer - 1e-12


def test_is_matches_plain_mc(ccsds):
    """Unbiasedness: IS (arbitrary shift targets) equals the port's plain
    MC within combined 4 sigma where MC resolves the FER."""
    from ldpc_tpu_torch.sim.runner import PointExecutor

    batch, snr = 2048, 2.0
    opts = SimOptions(**_kw(batch))
    st = PointExecutor(ccsds, opts, device="cpu").run_point(snr, 16 * batch,
                                                            123, 0)
    mc = st.fer_frames / st.blocks
    mc_std = np.sqrt(mc * (1 - mc) / st.blocks)
    assert st.fer_frames >= 50
    sups = tis.orbit_supports([[0, 7, 19], [2, 11]], ccsds.qc.Z, ccsds.n)
    res = tis.estimate_point(ccsds, opts, snr, sups, frames=16 * batch,
                             pi0=0.3, seed=5, device="cpu")
    assert abs(res.fer - mc) < 4.0 * np.hypot(mc_std, res.fer_std)


def test_is_step_refusals_carry_the_jax_text(ccsds):
    sups = tis.orbit_supports([[0]], ccsds.qc.Z, ccsds.n)
    jcode = jload(CCSDS)
    for bad in (dict(mode=2), dict(fidelity="reference")):
        kw = _kw(64, **bad)
        with pytest.raises(ValueError) as j:
            jis.make_is_step(jcode, JOptions(**kw), sups)
        with pytest.raises(ValueError) as t:
            tis.make_is_step(ccsds, SimOptions(**kw), sups, device="cpu")
        assert str(t.value) == str(j.value)
    with pytest.raises(ValueError, match="pi0"):
        tis.make_is_step(ccsds, SimOptions(**_kw(64)), sups, pi0=1.0,
                         device="cpu")


def test_isresult_roundtrip():
    r = tis.ISResult(5.0, 1000, 1e-9, 1e-10, 2e-9, 1e-10, 1e-9, 5e-11,
                     1.0, 3.2, 17)
    assert r.to_dict() == jis.ISResult(*r.to_dict().values()).to_dict()


def test_harvest_failures_returns_supports(ccsds):
    shifts = tis.orbit_supports([[0, 5, 9]], ccsds.qc.Z, ccsds.n)
    sups = tis.harvest_failures(ccsds, SimOptions(**_kw(256, iterations=4)),
                                shifts, 2.0, frames=512, max_support=12,
                                min_count=1, say=lambda *a, **k: None,
                                device="cpu")
    assert sups and len({tuple(s) for s in sups}) == len(sups)
    assert all(0 < len(s) <= 12 for s in sups)
