"""The port's adaptive mode (``ldpc_tpu_torch.sim.adaptive``) against the
JAX package's on the same point results: the same actions, the same state
after each action, the same adaptation log.

Tolerance: none. The controller is control flow over the point results and
the catalog, so its decisions and log are equal.
"""

from __future__ import annotations

import json
from dataclasses import replace

import pytest
import torch

from ldpc_tpu.models.catalog import MatrixCatalog as JCatalog
from ldpc_tpu.sim import adaptive as jad
from ldpc_tpu.sim.results import SNRPointResult as JPoint
from ldpc_tpu_torch.models.catalog import MatrixCatalog as TCatalog
from ldpc_tpu_torch.sim import adaptive as tad
from ldpc_tpu_torch.sim.config import SimOptions
from ldpc_tpu_torch.sim.results import SNRPointResult as TPoint

torch.set_num_threads(1)

W576 = "builtin:wimax_576_0.5.alist.txt"

# (ber, fer, avg convergence iterations) of a run of points that hits every
# rule: a lower rate, the interleaver, more iterations, a higher rate (twice,
# then at the top of the family), the dead zone, a zero BER
POINTS = [(2e-2, 1.0, 0.0), (5e-3, 0.9, 4.5), (1e-3, 0.1, 1.0),
          (5e-6, 0.001, 1.0), (3e-6, 0.0005, 9.0), (2e-6, 0.0002, 1.0),
          (4e-6, 0.0001, 1.0), (0.0, 0.0, 1.0), (2e-2, 0.7, 18.0),
          (3e-2, 0.8, 1.0)]


def _state(mod, path):
    return mod.AdaptiveState(
        current_matrix_path=path, current_rate=0.5, current_modulation=1,
        current_max_iterations=5, current_interleaver="none",
        current_encoding_method="standard")


def _point(cls, snr, ber, fer, conv):
    return cls(snr_db=snr, ber=ber, fer=fer, avg_normalized_llr=0.0,
               total_blocks=100, successful_blocks=50, failed_blocks=50,
               avg_convergence_iterations=conv)


@pytest.mark.parametrize("start", [W576, "builtin:wimax_2304_0.83.alist.txt",
                                   "builtin:CCSDS_ldpc_n128_k64.alist.txt"])
@pytest.mark.parametrize("thresholds", [(1e-2, 1e-5), (1e-3, 1e-6)])
def test_controller_decisions_match_jax(start, thresholds):
    js = jad.ThresholdStrategy(*thresholds)
    ts = tad.ThresholdStrategy(*thresholds)
    jc = jad.AdaptiveController(js, JCatalog())
    tc = tad.AdaptiveController(ts, TCatalog(), device="cpu")
    jstate, tstate = _state(jad, start), _state(tad, start)
    changes = 0
    for i, (ber, fer, conv) in enumerate(POINTS):
        ja = js.evaluate(jstate, _point(JPoint, float(i), ber, fer, conv))
        ta = ts.evaluate(tstate, _point(TPoint, float(i), ber, fer, conv))
        assert (ja is None) == (ta is None)
        if ja is None:
            continue
        assert ta.__dict__ == ja.__dict__
        jc._apply_action(ja, jstate, lambda *a, **k: None)
        tc._apply_action(ta, tstate, lambda *a, **k: None)
        assert tstate.__dict__ == jstate.__dict__
        changes += 1
    assert changes >= 4


def test_adaptive_sweep_log_and_resume(tmp_path):
    """A sweep on the CPU: the interleaver turns on after the 0 dB point
    (examples/wimax576_adaptive's log), and a sweep resumed from its
    checkpoint equals the one that ran through."""
    opts = SimOptions(matrix=W576, adaptive=True, blocks=64, batch=64,
                      iterations=5, ber=True, fer=True, initial_snr=0.0,
                      end_snr=2.0, step_snr=1.0, quiet=True,
                      checkpoint=str(tmp_path / "ck.json"))

    def controller():
        return tad.AdaptiveController(tad.ThresholdStrategy(), TCatalog(),
                                      device="cpu")

    full = controller().run_adaptive_sweep(opts)
    assert [e["interleaver"] for e in full.adaptation_log] == \
        ["none", "random", "random"]
    assert [e["snr_db"] for e in full.adaptation_log] == [0.0, 1.0, 2.0]
    assert full.snr_points[0].fer == 1.0
    # cut the checkpoint back to its first two points, then resume
    ck = json.loads((tmp_path / "ck.json").read_text())
    assert len(ck["snr_points"]) == 3
    ck["snr_points"] = ck["snr_points"][:2]
    ck["adaptation_log"] = ck["adaptation_log"][:2]
    (tmp_path / "ck.json").write_text(json.dumps(ck))
    resumed = controller().run_adaptive_sweep(replace(opts, resume=True))
    assert resumed.adaptation_log == full.adaptation_log
    assert resumed.snr_points == full.snr_points
