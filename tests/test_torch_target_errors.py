"""The ``--target-errors`` early stop of the port's ``run_simulation``
against the JAX package's, on the CPU.

At -15 dB every frame of CCSDS n32 fails, so the error counts do not depend
on the random streams and the point's ``total_blocks`` shows the stop
schedule alone: the JAX runner checks the quota after groups of up to 8
batches (a power of two) while two batches remain where its fused path runs,
and after every batch elsewhere (``ldpc_tpu/sim/runner.py:1047-1091``). On
the CPU the JAX fused path runs only under ``fused='on'`` (the Pallas kernel
in interpret mode); ``auto`` and ``off`` take its unfused path.

Tolerance: none, ``total_blocks`` is equal case by case.
"""

from __future__ import annotations

import pytest
import torch

from ldpc_tpu.sim.config import SimOptions as JOptions
from ldpc_tpu.sim.runner import run_simulation as jax_run
from ldpc_tpu_torch.sim.config import SimOptions as TOptions
from ldpc_tpu_torch.sim.runner import run_simulation as torch_run

torch.set_num_threads(1)

CCSDS = "builtin:CCSDS_ldpc_n32_k16.alist.txt"
# (blocks, target errors): the grid where the port once stopped late, and
# a quota met exactly at the edge of the first group (8 batches of 32)
GRID = [(160, 1), (320, 1), (96, 1), (640, 100), (640, 256)]


def _kw(blocks, target, fused, iterations=3):
    return dict(matrix=CCSDS, blocks=blocks, iterations=iterations, ber=True,
                fer=True, fidelity="exact", batch=32, seed=7,
                initial_snr=-15.0, end_snr=-15.0, quiet=True,
                target_errors=target, fused=fused)


def _blocks(run, opts_cls, **kw):
    kw_run = {"device": "cpu"} if run is torch_run else {}
    return run(opts_cls(**kw), **kw_run).snr_points[0].total_blocks


@pytest.mark.parametrize("fused", ["auto", "off", "on"])
@pytest.mark.parametrize("blocks,target", GRID)
def test_total_blocks_equal_the_jax_runner(blocks, target, fused):
    kw = _kw(blocks, target, fused)
    t = _blocks(torch_run, TOptions, **kw)
    if fused != "on":
        # the unfused schedule, from its definition: one check per batch
        assert t == min(blocks, -(-target // 32) * 32)
    assert t == _blocks(jax_run, JOptions, **kw)


def test_grouped_stop_ends_at_a_group_edge():
    """Under the grouped schedule a quota met inside a group stops at the
    group's end, and one met exactly at its edge stops there too."""
    t = {target: _blocks(torch_run, TOptions, **_kw(640, target, "on"))
         for target in (100, 256)}
    assert t == {100: 256, 256: 256}


@pytest.mark.parametrize("blocks,target,expected", [(640, 100, 288),
                                                    (160, 1, 32)])
def test_auto_probe_batch_is_flushed_alone(blocks, target, expected):
    """At 12 iterations ``auto`` probes its first batch and checks the
    quota after it alone, before the grouped schedule starts: 640 frames
    at a target of 100 stop at 32 + 256 frames, not at 256."""
    kw = _kw(blocks, target, "on", iterations=12)
    assert _blocks(torch_run, TOptions, **kw) == expected
    assert _blocks(jax_run, JOptions, **kw) == expected
