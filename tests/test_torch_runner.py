"""The port's point executor on the CPU, at the main path's code (WiMAX
1152) with a small batch: dispatch modes, chunking and seeds change no
counter, and the FER is sane on both sides of the waterfall."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ldpc_tpu_torch.sim.config import SimOptions
from ldpc_tpu_torch.sim.runner import (
    PointExecutor,
    derive_key,
    load_code,
    resolve_two_phase,
    two_phase_trip_model,
)

torch.set_num_threads(1)

B = 256
NAME = "builtin:wimax_1152_0.5.alist.txt"


def _executor(**kw):
    code = load_code(NAME)
    opts = dict(matrix=code.name, iterations=12, fidelity="exact", batch=B,
                seed=3, speed=0.5, schedule="layered", layer_order="paired",
                check_every=2)
    opts.update(kw)
    return PointExecutor(code, SimOptions(**opts), device="cpu")


@pytest.fixture(scope="module")
def single():
    ex = _executor(two_phase="off")
    return ex, ex.run_point(2.0, 3 * B)


@pytest.mark.parametrize("two_phase", ["6", "auto"])
def test_dispatch_modes_give_equal_counters(single, two_phase):
    ex = _executor(two_phase=two_phase)
    st = ex.run_point(2.0, 3 * B)
    assert st == single[1]
    assert "+2phase(6)" in ex.kernel_used or "+2phase(auto:" in ex.kernel_used
    assert single[0].kernel_used == "cpu+fused+layered+paired+ce2"


def test_auto_rule_on_the_cpu(single):
    """Without a card nothing is timed: the split is taken exactly when the
    trip model predicts fewer mean block trips."""
    ex = _executor(two_phase="auto")
    ex.run_point(2.0, B)
    m = ex.last_probe
    assert m["overhead_trips"] == 0.0 and m["trip_us"] is None
    split = m["phase1_mean"] + m["phase2_per_tile"] < m["single"]
    assert ex._two_phase_choice[2.0] == split
    assert ex.kernel_used.endswith(f"+2phase(auto:{6 if split else 'off'})")


def test_chunked_run_equals_one_run(single):
    ex = _executor(two_phase="off")
    a = ex.run_point(2.0, B)
    b = ex.run_point(2.0, 2 * B, start_batch=1)
    whole = single[1]
    for f in ("blocks", "ok_blocks", "error_bits", "fer_frames",
              "conv_iters_sum", "conv_count"):
        assert getattr(a, f) + getattr(b, f) == getattr(whole, f), f


def test_same_seed_same_result_other_seed_differs(single):
    assert _executor(two_phase="off").run_point(2.0, 3 * B) == single[1]
    other = _executor(two_phase="off", seed=4).run_point(2.0, 3 * B)
    assert other.conv_iters_sum != single[1].conv_iters_sum


def test_fer_is_sane_across_the_waterfall(single):
    st = single[1]
    assert st.blocks == 3 * B and st.fer_frames / st.blocks < 0.05
    low = _executor(two_phase="off").run_point(0.0, B)
    assert low.fer_frames / low.blocks > 0.5
    assert low.error_bits > 0 and low.conv_count == low.ok_blocks


def test_partial_last_batch_counts_only_what_was_asked():
    ex = _executor(two_phase="off", iterations=4, check_every=1,
                   layer_order="serial")
    st = ex.run_point(2.0, B + 10)
    assert st.blocks == B + 10


def test_two_phase_settings_and_trip_model():
    assert resolve_two_phase("auto", 12, 2) == 6
    assert resolve_two_phase("off", 12, 2) == 0
    assert resolve_two_phase("auto", 6, 2) == 0
    with pytest.raises(ValueError, match="multiple"):
        resolve_two_phase("5", 12, 2)
    conv = np.array([1, 3, 9, -1, 0, 1, 11, 2])
    ok = conv >= 0
    m = two_phase_trip_model(conv, ok, 6, 12, lanes=4)
    assert m["single"] == (12 + 12) / 2
    assert m["phase1_mean"] == 6.0
    assert m["refeed_frac"] == 3 / 8  # trips 10, 12 and 12 exceed phase 1
    assert derive_key(1, 2) == derive_key(1, 2) != derive_key(1, 3)


def test_unported_options_are_refused():
    """Layered --fidelity reference and --kernel xla raised until the plain
    decoders were ported: now the first gets the JAX runner's ValueError
    (layers need the QC graph and the exact rule) and the second runs the
    layered plain decoder. Flooding and int8 extrinsics run the fused
    kernels."""
    code = load_code(NAME)
    opts = dict(matrix=code.name, iterations=12, fidelity="exact", batch=B,
                schedule="layered")
    with pytest.raises(ValueError, match="schedule='layered' requires"):
        PointExecutor(code, SimOptions(**dict(opts, fidelity="reference")),
                      device="cpu")
    ex = PointExecutor(code, SimOptions(**dict(opts, kernel="xla")),
                       device="cpu")
    assert not ex.fused and ex.kernel_used == "torch+layered"
    ex = PointExecutor(code, SimOptions(matrix=code.name, iterations=12,
                                        fidelity="exact", batch=B,
                                        schedule="flooding"), device="cpu")
    assert ex.fused and ex.kernel_used == "cpu+fused+2phase(auto)"
    ex = PointExecutor(code, SimOptions(matrix=code.name, iterations=12,
                                        fidelity="exact", batch=B,
                                        schedule="layered", decoder="minsum",
                                        msg_store="int8", two_phase="off"),
                       device="cpu")
    assert ex.fused and ex.kernel_used == "cpu+fused+layered"
    assert ex._mc_full.plan.int8
