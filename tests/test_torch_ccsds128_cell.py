"""The benchmark cell ``ccsds128-bpsk-3db`` on the CPU: its files, its code
(the CCSDS TC (128, 64) code, whose rows each meet one base column twice),
the block plan it runs (two codewords a warp), the port held counter for
counter against the benchmark's plain reference with and without the
split, the spans and counters a block of two codewords adds, none of them
at the 802.16e code's one codeword a block, and the ``lane_idle_pct``
reader."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import cells, census, check, harness, trace
from benchmark.harness import unit_key
from benchmark.program import Program
from benchmark.reference import codes
from benchmark.reference.sim import Reference
from ldpc_tpu_torch.sim.config import SimOptions
from ldpc_tpu_torch.sim.runner import (
    PointExecutor,
    load_code,
    resolve_layer_groups,
)
from ldpc_tpu_torch.utils import timing

torch.set_num_threads(min(2, torch.get_num_threads()))

CELL = "ccsds128-bpsk-3db"
B = 64
WIMAX = "builtin:wimax_1152_0.5.alist.txt"
SPLIT = ("batch.phase1", "batch.compact", "batch.phase2", "batch.merge")


@pytest.fixture
def rec(monkeypatch):
    """A fresh recorder in the program's place."""
    r = timing.Recorder()
    monkeypatch.setattr(timing, "RECORDER", r)
    return r


def small(snr_db: float = 3.0, two_phase="auto") -> cells.Cell:
    """The cell at a batch of 64, 256 frames a call."""
    c = cells.load(CELL)
    c.config["options"].update(batch=B, two_phase=two_phase)
    c.traffic.update(frames_per_call=4 * B, snr_db=snr_db)
    return c


def _executor(two_phase="auto", matrix=None):
    o = dict(cells.load(CELL).config["options"], batch=B, seed=7,
             two_phase=two_phase, quiet=True)
    if matrix is not None:
        o["matrix"] = matrix
    return PointExecutor(load_code(o["matrix"]), SimOptions(**o),
                         device="cpu")


def test_the_cell_finds_its_files():
    c = cells.load(CELL)
    assert c.chips == 1
    assert c.config["name"] == "ccsds128-bpsk-layered12"
    assert c.config["reduced"] == [] and c.config["batch"] == 131072
    assert set(c.config["assumed"]) == {"batch", "snr_db"}
    w1152 = cells.load("w1152-bpsk-2db").config["options"]
    assert {k for k, v in c.config["options"].items()
            if w1152.get(k) != v} == {"matrix", "batch"}
    assert c.traffic == {"kind": "stream", "snr_db": 3.0,
                         "frames_per_call": 1048576, "traced_units": 2}
    assert c.check["units"] == 2 and c.check["limits"]["frames_gap"] == 0
    assert [m["name"] for m in c.end_to_end] == [
        "info_bits_per_s.device_bound", "setup_s"]
    assert [m["name"] for m in c.per_layer] == [
        "kernels_per_batch.device_bound",
        "pipeline_ms_per_batch.device_bound",
        "decode_roofline.device_bound", "device_idle_pct.device_bound",
        "setup_program_s", "lane_idle_pct"]
    for m in c.per_layer:
        assert callable(cells.reader(m["name"]))


def test_the_builtin_is_the_configured_code():
    c = cells.load(CELL)
    ours = codes.build(c.config["code"])
    port = load_code(c.config["options"]["matrix"])
    assert (ours.n, ours.k, ours.Z) == (port.n, port.k, port.qc.Z) \
        == (128, 64, 16)
    assert np.array_equal(ours.dense(), port.H.to_dense())
    # every block row meets one base column twice (I + Φ^k)
    assert all(len(r) == 8 for r in port.qc.row_slots())


def test_the_plan_shares_a_warp_between_two_codewords():
    ex = _executor()
    plan = ex._mc_full.plan
    assert (ex.lanes, plan.threads, plan.row_threads) == (2, 32, 16)
    assert plan.l_stride == 144 and ex._mc_full.tables.has_dup
    assert resolve_layer_groups(ex.code.qc, ex.opts, "layered") is None
    assert "+paired" not in ex.kernel_used
    assert ex.kernel_used.startswith("cpu+fused+layered+ce2")


@pytest.mark.parametrize("two_phase", ["auto", 6])
@pytest.mark.parametrize("snr_db", [3.0, 1.5])
def test_the_port_equals_the_reference(snr_db, two_phase):
    c = small(snr_db, two_phase)
    program = Program(c.config, c.traffic, "cpu")
    program.start()
    keys = [unit_key(20260000017, i) for i in range(2)]
    outs = [[program.call(k)] for k in keys]
    refs = check.reference_units(Reference(c.config, "cpu"), c.traffic, keys)
    assert outs == refs
    assert {k: v[0] for k, v in check.gaps(outs, refs).items()} == {
        "frames_gap": 0, "counter_gap": 0.0}
    assert sum(u[0]["frame_errors"] for u in outs) > 0
    if two_phase == 6:
        assert program.executor.kernel_used.endswith("+2phase(6)")


def test_lane_trips_and_the_split_spans(rec):
    ex = _executor(two_phase=6)
    summed = []
    step = ex.step

    def recorded(*args, **kw):
        stats, iters = step(*args, **kw)
        summed.append(int(iters.sum()))
        return stats, iters

    ex.step = recorded
    with timing.batch_spans():
        st = ex.run_point(1.5, 3 * B)
    root, unit = timing.units(rec.spans, "run_point")[-1]
    assert root.attrs["lane_trips"] == sum(summed) > 0
    assert root.attrs["split_batches"] == root.attrs["batches"] == 3
    decodes = {s.id for s in unit if s.name == "batch.decode"}
    assert len(decodes) == 3
    for name in SPLIT:
        parts = [s for s in unit if s.name == name]
        assert len(parts) == 3 and {s.parent for s in parts} == decodes
    # a lane runs at least the sweeps its own codeword needs
    own = census.total_sweeps(st.blocks, st.conv_count, st.conv_iters_sum,
                              ex.max_iterations)
    assert sum(summed) > own


def test_the_probe_carries_its_choice(rec):
    ex = _executor()
    ex.run_point(1.5, 3 * B)
    root, unit = timing.units(rec.spans, "run_point")[-1]
    probe, = [s for s in unit if s.name == "auto.probe"]
    p = ex.last_probe
    assert probe.attrs == {"lanes": 2, "split": int(ex._two_phase_choice[1.5]),
                           "single": p["single"],
                           "phase1_mean": p["phase1_mean"],
                           "phase2_per_tile": p["phase2_per_tile"],
                           "overhead_trips": 0.0}
    assert root.attrs["split_batches"] == 2 * probe.attrs["split"]
    assert root.attrs["lane_trips"] > 0 and root.attrs["probes"] == 1


def _ops_outside_decode(ex) -> int:
    """Top-level host operators of a 4-batch call outside its decodes."""
    ex.run_point(2.0, B)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ex.run_point(2.0, 4 * B)
    n = 0
    for e in prof.events():
        p = e.cpu_parent
        if not e.name.startswith("aten::") or (
                p is not None and p.name.startswith("aten::")):
            continue
        while p is not None and p.name != "batch.decode":
            p = p.cpu_parent
        n += p is None
    return n


@pytest.mark.parametrize("two_phase", ["off", "auto", 6])
def test_one_codeword_a_block_adds_nothing(rec, two_phase):
    ex = _executor(two_phase, matrix=WIMAX)
    assert ex.lanes == 1
    # draw, encode and counters of 4 batches, the flush and the call's own
    # operators: a block of one codeword counts no lane trips
    assert _ops_outside_decode(ex) == 264
    root, _ = timing.units(rec.spans, "run_point")[-1]
    assert "lane_trips" not in root.attrs
    assert ("split_batches" in root.attrs) == (two_phase != "off")


def _stretch(lane_trips):
    """Two traced calls of 100 frames each (90 converged at conv 3) and the
    recorder's spans of a warm-up call and of those calls."""
    st = trace.Stretch(1.0, 0.9, [], {}, [], units=[[{
        "frames": 100, "frame_errors": 10, "bit_errors": 40,
        "converged": 90, "conv_sum": 270}]] * 2)
    r = timing.Recorder()
    ids = iter(range(1, 100))

    def add(name, t0, parent=None, **attrs):
        s = timing.Span(r, name, attrs)
        s.id, s.t0, s.t1 = next(ids), t0, t0 + 1
        s.parent = None if parent is None else parent.id
        s.unit = s.id if parent is None else parent.unit
        r.spans.append(s)
        return s

    add("run_point", 0, frames=100, **({"lane_trips": 1} if lane_trips
                                        else {}))
    for t in (10, 20, 30, 40):  # two calls alone, then two with the host
        root = add("run_point", t, frames=100,
                   **({"lane_trips": lane_trips} if lane_trips else {}))
        add("batch.decode", t, root)
    return st, r


@pytest.mark.parametrize("lane_trips, expected", [(600, 20.0), (None, None)])
def test_lane_idle_pct_reads_the_counter(monkeypatch, lane_trips, expected):
    st, r = _stretch(lane_trips)
    monkeypatch.setattr(timing, "RECORDER", r)
    notes = []
    ctx = harness.Context(cells.load(CELL), st, None, "cpu", True, notes)
    # own sweeps a call: 270 + 90 converged + 10 x 12 = 480 of 600 trips
    assert cells.reader("lane_idle_pct")(ctx) == expected
    assert bool(notes) == (expected is not None)
