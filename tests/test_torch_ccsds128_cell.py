"""The benchmark cell ``ccsds128-bpsk-3db`` on the CPU: its files, its code
(the CCSDS TC (128, 64) code, whose rows each meet one base column twice),
the block plan it runs (two codewords a warp), the port held counter for
counter against the benchmark's plain reference with and without the
split, the spans and counters a block of two codewords adds, none of them
at the 802.16e code's one codeword a block, the ``lane_idle_pct`` reader,
and K1's refill: where it engages, its grid, its idle model, its outputs
against the block per group, and the ``refills`` and ``lane_trips``
counters it feeds."""

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
from ldpc_tpu_torch.ops import mc_kernels as mk
from ldpc_tpu_torch.ops.channel import ChannelParams
from ldpc_tpu_torch.ops.decode_loop import block_max_trips
from ldpc_tpu_torch.ops.encode import make_encoder_T
from ldpc_tpu_torch.sim.config import SimOptions
from ldpc_tpu_torch.sim.runner import (
    PointExecutor,
    derive_key,
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
    assert _ops_outside_decode(ex) == 260
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


# ------------------------------------------------------------ K1's refill ----

N128 = "builtin:CCSDS_ldpc_n128_k64.alist.txt"
N32 = "builtin:CCSDS_ldpc_n32_k16.alist.txt"


def _mc(matrix=N128, variant="spa", schedule="layered", **kw):
    code = load_code(matrix)
    info = code.standard_encode_spec.info_pos("orig")
    return code, mk.MCDecoder(code.qc, info, 12, variant, schedule=schedule,
                              check_every=2, **kw)


def _grid(monkeypatch, dec, blocks: int):
    """``dec``'s refill launch on ``blocks`` blocks, as on a card with that
    many resident (the CPU has none, so it never refills of its own)."""
    monkeypatch.setattr(dec, "grid", lambda B, device: min(
        blocks, -(-B // dec.lanes)))


def _inputs(code, B: int, snr_db: float = 2.0):
    u = torch.randint(0, 2, (B, code.k), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(5))
    wT = make_encoder_T(code.standard_encode_spec, "orig", "cpu")(u)
    consts = ChannelParams(mode=1, modulation=1, speed=code.rate,
                           snr_db=snr_db, noise_model="exact").consts("cpu")
    return wT, consts


def _tail(own: torch.Tensor, lanes: int) -> int:
    """Sweeps the lane groups of blocks of ``lanes`` consecutive codewords
    that took ``own`` trips spend past their own: each block's largest
    over all its lane groups, those with no codeword too."""
    t = own.to(torch.int64)
    t = torch.cat([t, t.new_zeros(-len(t) % lanes)]).view(-1, lanes)
    return int((t.amax(dim=1, keepdim=True) - t).sum())


@pytest.mark.parametrize("matrix, schedule, options, lanes, refill", [
    (N128, "layered", {}, 2, True),
    (N32, "layered", {}, 8, True),
    (N128, "layered", dict(msg_store="int8", variant="minsum"), 2, True),
    (WIMAX, "layered", {}, 1, False),
    (N32, "flooding", {}, 4, False),
    (N128, "layered", dict(emit_llr=True), 2, False),
    (N128, "layered", dict(track_norm=True, check_every=1), 2, False),
])
def test_the_refill_reads_the_plans_shape(monkeypatch, matrix, schedule,
                                          options, lanes, refill):
    """K1 can refill where codewords share a warp, under the layered
    schedule, in one pass (no LLRs emitted, no flip metric); a split's
    phase 1, the flip metric, flooding and one codeword a block keep the
    block per group. It refills only a batch over one wave of blocks."""
    code = load_code(matrix)
    info = code.standard_encode_spec.info_pos("orig")
    kw = dict(dict(variant="spa", check_every=2), **options)
    dec = mk.MCDecoder(code.qc, info, 12, kw.pop("variant"),
                       schedule=schedule, **kw)
    assert (dec.lanes, dec.refill) == (lanes, refill)
    assert dec.refills(64, "cpu") == 0
    _grid(monkeypatch, dec, 3)
    assert dec.refills(64, "cpu") == (64 - 3 * lanes if refill else 0)
    assert dec.refills(3 * lanes, "cpu") == 0


def test_the_executor_refills_its_single_pass_only():
    ex = _executor(two_phase=6)
    assert ex._mc_full.refill and not ex._mc1.refill
    assert not _executor(matrix=WIMAX)._mc_full.refill


@pytest.mark.parametrize("B, lanes, resident, grid", [
    (131072, 2, 3300, 3300), (6600, 2, 3300, 3300), (6599, 2, 3300, 3300),
    (6601, 2, 3300, 3300), (1001, 2, 3300, 501), (64, 8, 5, 5),
    (7, 8, 5, 1), (1, 2, 3300, 1),
])
def test_the_refill_grid(B, lanes, resident, grid):
    """At most the card's resident blocks, and never more blocks than the
    batch fills; off the card, one codeword a lane group, so no refills."""
    assert mk.refill_grid(B, lanes, resident) == grid
    _, dec = _mc()
    dec.lanes = lanes
    assert dec.grid(B, "cpu") == -(-B // lanes)
    assert dec.refills(B, "cpu") == 0


@pytest.mark.parametrize("matrix", [N128, N32])
@pytest.mark.parametrize("variant", ["spa", "normalized_minsum"])
def test_one_wave_is_the_block_per_group(matrix, variant):
    """A batch that one wave of blocks holds is decoded block per group,
    iters as the block's trips, and adds no idle."""
    code, dec = _mc(matrix, variant)
    wT, consts = _inputs(code, 96)
    idle = torch.zeros(1, dtype=torch.float64)
    got = dec(wT, consts, seeds=(3, 4), idle=idle)
    dec.refill = False
    want = dec(wT, consts, seeds=(3, 4))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got[4].to(torch.int64),
                       block_max_trips(got[1], got[2], dec.lanes, 12))
    assert float(idle) == 0


@pytest.mark.parametrize("matrix", [N128, N32])
@pytest.mark.parametrize("variant", ["spa", "normalized_minsum"])
def test_the_refill_keeps_every_output_but_iters(monkeypatch, matrix,
                                                 variant):
    """The plain version of the refill against the block per group on the
    same inputs: err, ok, conv and norm equal; iters each codeword's own
    trips, whose largest over a block are the block's; the tail of one
    codeword a lane group, so the lane trips are the block per group's; a
    call with ``skip`` adds no idle."""
    code, dec = _mc(matrix, variant)
    B = 96
    wT, consts = _inputs(code, B)
    _grid(monkeypatch, dec, 2)
    assert dec.refills(B, "cpu") > 0
    idle = torch.zeros(1, dtype=torch.float64)
    got = dec(wT, consts, seeds=(3, 4), idle=idle)
    dec.refill = False
    want = dec(wT, consts, seeds=(3, 4))
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)
    own = torch.where(got[1], got[2] + 1, 12).to(torch.int32)
    assert torch.equal(got[4], own) and not torch.equal(got[4], want[4])
    assert torch.equal(want[4].to(torch.int64),
                       block_max_trips(got[1], got[2], dec.lanes, 12))
    assert float(idle) == float(want[4].sum() - own.sum()) > 0
    # a call with skip pre-marks every codeword done and refills nothing
    dec.refill = True
    skipped = dec(wT, consts, seeds=(3, 4), skip=1, idle=idle)
    assert not skipped[4].any()
    assert float(idle) == float(want[4].sum() - own.sum())


@pytest.mark.parametrize("matrix", [N128, N32])
@pytest.mark.parametrize("B", [1, 7, 95, 96])
def test_the_plain_refill_tail(monkeypatch, matrix, B):
    """The plain version's idle: each block's largest trips over all its
    lane groups, a group with no codeword (a batch no multiple of the
    lanes) too, less the codewords' own."""
    code, dec = _mc(matrix)
    wT, consts = _inputs(code, B, 1.5)
    _grid(monkeypatch, dec, 0)  # no blocks: the plain refill at any batch
    idle = torch.zeros(1, dtype=torch.float64)
    own = dec(wT, consts, seeds=(5, 6), idle=idle)[4]
    assert float(idle) == _tail(own, dec.lanes)


def _refill_executor(monkeypatch, grid: int, two_phase="off"):
    ex = _executor(two_phase=two_phase)
    _grid(monkeypatch, ex._mc_full, grid)
    return ex


@pytest.mark.parametrize("two_phase", ["off", "auto"])
def test_lane_trips_take_the_idle_word_and_refills_count(monkeypatch, rec,
                                                         two_phase):
    """A lane group's sweeps: its codewords' own trips plus each single
    pass's tail (the probe's too), and a split batch's block trips;
    ``refills`` counts the codewords loaded after a group's first, from
    each single pass's grid."""
    ex = _refill_executor(monkeypatch, 4, two_phase)
    trips, single = [], []
    step = ex.step

    def recorded(key, consts, p1=0, **kw):
        stats, iters = step(key, consts, p1, **kw)
        trips.append(int(iters.sum()) + (0 if p1 else _tail(iters, ex.lanes)))
        single.append(not p1)
        return stats, iters

    ex.step = recorded
    st = ex.run_point(1.5, 3 * B)
    root, _ = timing.units(rec.spans, "run_point")[-1]
    assert len(trips) == 3
    assert root.attrs["refills"] == sum(single) * (B - ex.lanes * 4)
    assert root.attrs["lane_trips"] == sum(trips)
    if all(single):
        # a codeword's lanes run its own sweeps alone, past the tail
        own = census.total_sweeps(st.blocks, st.conv_count,
                                  st.conv_iters_sum, ex.max_iterations)
        assert own < sum(trips)


def test_a_step_outside_run_point_counts_nothing(monkeypatch, rec):
    """A batch outside ``run_point`` (a discarded warm-up, a test's step)
    opens no counter and adds its tail nowhere."""
    ex = _refill_executor(monkeypatch, 4)
    with timing.span("outside"):
        _, iters = ex.step(derive_key(5, 0), ex.consts(1.5))
    assert ex._mc_full.refills(B, "cpu") > 0 and iters.max() > 0
    assert [s.attrs for s in rec.spans if s.name == "outside"] == [{}]
    assert not any({"refills", "lane_trips"} & set(s.attrs)
                   for s in rec.spans)


def test_lane_idle_pct_reads_the_refill(monkeypatch):
    """The reader, unchanged, takes the idle word as the lane trips beyond
    the own sweeps: 100 x idle / (own + idle) over the traced calls."""
    r = timing.Recorder()
    monkeypatch.setattr(timing, "RECORDER", r)
    ex = _refill_executor(monkeypatch, 4)
    ex.run_point(1.5, B)  # the warm-up call, left out
    units = []
    with timing.batch_spans():
        for _ in range(2):
            st = ex.run_point(1.5, 2 * B)
            units.append([{"frames": st.blocks,
                           "frame_errors": st.fer_frames,
                           "bit_errors": st.error_bits,
                           "converged": st.conv_count,
                           "conv_sum": st.conv_iters_sum}])
    stretch = trace.Stretch(1.0, 0.9, [], {}, [], units=units)
    ctx = harness.Context(cells.load(CELL), stretch, None, "cpu", True, [])
    trips = sum(u.attrs["lane_trips"]
                for u, _ in timing.units(r.spans, "run_point")[1:])
    own = sum(census.total_sweeps(u[0]["frames"], u[0]["converged"],
                                  u[0]["conv_sum"], 12) for u in units)
    assert trips > own
    assert cells.reader("lane_idle_pct")(ctx) == 100.0 * (trips - own) / trips
