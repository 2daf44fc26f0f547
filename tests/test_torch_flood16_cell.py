"""The benchmark cell ``w1152-bpsk-flood16-2db`` on the CPU: its files (the
802.16e (1152, 576) code decoded by flooding SPA-16 with a check after
every sweep, the simulator's default schedule), the route it takes (the
fused path, K1's flooding template, no refill), the port held counter for
counter against the benchmark's plain flooding reference with and without
the split, the ``schedule`` attribute of ``executor.build`` and
``run_point``, the ``x_row_bytes`` counter of the flooding X row, and the
``decode_roofline`` reader pricing the cell's calls with the flooding
census."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import cells, census, check, harness, trace
from benchmark.harness import unit_key
from benchmark.program import Program
from benchmark.reference import codes
from benchmark.reference.sim import Reference
from ldpc_tpu_torch.sim.config import SimOptions
from ldpc_tpu_torch.sim.runner import (
    PointExecutor,
    choose_route,
    load_code,
    resolve_two_phase,
    run_simulation,
)
from ldpc_tpu_torch.utils import timing

torch.set_num_threads(min(2, torch.get_num_threads()))

CELL = "w1152-bpsk-flood16-2db"
LAYERED = "w1152-bpsk-2db"
B = 64
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def rec(monkeypatch):
    """A fresh recorder in the program's place."""
    r = timing.Recorder()
    monkeypatch.setattr(timing, "RECORDER", r)
    return r


def small(two_phase="auto") -> cells.Cell:
    """The cell at a batch of 64, 256 frames a call."""
    c = cells.load(CELL)
    c.config["options"].update(batch=B, two_phase=two_phase)
    c.traffic.update(frames_per_call=4 * B)
    return c


def _options(cell: str = CELL, **kw) -> SimOptions:
    o = dict(cells.load(cell).config["options"], batch=B, seed=7, quiet=True)
    o.update(kw)
    return SimOptions(**o)


def _executor(cell: str = CELL, **kw) -> PointExecutor:
    opts = _options(cell, **kw)
    return PointExecutor(load_code(opts.matrix), opts, device="cpu")


def test_the_cell_finds_its_files():
    c = cells.load(CELL)
    assert c.chips == 1
    assert c.config["name"] == "w1152-bpsk-flood16"
    assert c.config["reduced"] == [] and c.config["batch"] == 4096
    assert set(c.config["assumed"]) == {"iterations"}
    o, d = c.config["options"], c.config["decoder"]
    assert cells.schedule(c.config) == "flooding"
    assert "layer_order" not in o and "layer_order" not in d
    assert (o["iterations"], o["check_every"], o["two_phase"]) == (16, 1,
                                                                   "auto")
    assert (d["iterations"], d["syndrome_check_every"], d["two_phase"],
            d["precision"]) == (16, 1, "auto", "float32")
    # the layered cell's configuration but for the decoder's schedule
    layered = cells.load(LAYERED)
    lo = layered.config["options"]
    assert {k for k in set(o) | set(lo) if o.get(k) != lo.get(k)} == {
        "iterations", "schedule", "check_every", "layer_order"}
    assert c.config["code"] == layered.config["code"]
    assert c.traffic == layered.traffic
    assert c.check == {"units": 2,
                       "limits": {"frames_gap": 0, "counter_gap": 0.24}}
    assert [m["name"] for m in c.end_to_end] == [
        "info_bits_per_s.device_bound", "setup_s"]
    assert [m["name"] for m in c.per_layer] == [
        "kernels_per_batch.device_bound",
        "pipeline_ms_per_batch.device_bound",
        "decode_roofline.device_bound", "device_idle_pct.device_bound",
        "setup_program_s"]
    for m in c.per_layer:
        assert callable(cells.reader(m["name"]))


def test_the_builtin_is_the_configured_code():
    c = cells.load(CELL)
    ours = codes.build(c.config["code"])
    port = load_code(c.config["options"]["matrix"])
    assert (ours.n, ours.k, ours.Z) == (port.n, port.k, port.qc.Z) \
        == (1152, 576, 48)
    assert np.array_equal(ours.dense(), port.H.to_dense())


def test_the_route_is_k1_flooding_without_refill():
    opts = _options().resolved()
    code = load_code(opts.matrix)
    route = choose_route(code, opts, torch.device("cpu"), opts.iterations,
                         opts.modulation, opts.interleaver)
    assert route.fused and route.layer_groups is None
    assert route.kernel == "cpu+fused"  # no +layered, +paired or +ce
    assert route.loop_kw["schedule"] == "flooding"
    assert route.phase1 == resolve_two_phase("auto", 16, 1) == 8
    ex = _executor()
    assert ex.fused and ex._auto and ex.schedule == "flooding"
    assert ex.kernel_used == "cpu+fused+2phase(auto)"
    for dec in (ex._mc_full, ex._mc1, ex._llr_dec):
        assert dec.flood and dec.check_every == 1
    assert ex.lanes == 1 and not ex._mc_full.refill
    assert ex._mc_full.refills(4096, "cpu") == 0


@pytest.mark.parametrize("two_phase", ["auto", 8])
def test_the_port_equals_the_reference(two_phase):
    c = small(two_phase)
    program = Program(c.config, c.traffic, "cpu")
    program.start()
    keys = [unit_key(20260000024, i) for i in range(2)]
    outs = [[program.call(k)] for k in keys]
    refs = check.reference_units(Reference(c.config, "cpu"), c.traffic, keys)
    assert outs == refs
    assert {k: v[0] for k, v in check.gaps(outs, refs).items()} == {
        "frames_gap": 0, "counter_gap": 0.0}
    assert sum(u[0]["frame_errors"] for u in outs) > 0
    suffix = "+2phase(8)" if two_phase == 8 else "+2phase(auto:"
    assert suffix in program.executor.kernel_used


@pytest.mark.parametrize("cell, schedule", [(CELL, "flooding"),
                                            (LAYERED, "layered")])
def test_the_schedule_is_on_the_build_and_each_call(rec, cell, schedule):
    ex = _executor(cell, two_phase="off")
    ex.run_point(2.0, B)
    ex.run_point(2.0, 2 * B)
    build, = [s for s, _ in timing.units(rec.spans, "executor.build")]
    assert build.attrs == {"schedule": schedule}
    roots = [r for r, _ in timing.units(rec.spans, "run_point")]
    assert len(roots) == 2
    assert all(r.attrs["schedule"] == schedule for r in roots)


class _Rows:
    """A decoder that logs, for each launch, the bytes of the X row its
    kernel would hold (``_buffers`` at the launch's rows)."""

    def __init__(self, dec, log: list):
        self._dec, self._log = dec, log

    def __call__(self, x, *args, **kw):
        xbuf, _ = self._dec._buffers(x.shape[1], x.device)
        self._log.append(0 if xbuf is None else xbuf.numel() * 4)
        return self._dec(x, *args, **kw)

    def __getattr__(self, name):
        return getattr(self._dec, name)


@pytest.mark.parametrize("cell, two_phase, launches", [
    (CELL, "off", 3), (CELL, "auto", None), (CELL, 8, 6),
    (LAYERED, "auto", 3)])
def test_x_row_bytes_counts_the_flooding_launches(rec, cell, two_phase,
                                                  launches):
    """4 n bytes a row of every flooding K1 and K2 launch of the call, the
    probe's batch included: a single pass launches K1 a batch, a split K1
    and K2; a layered call holds no X row and counts none."""
    ex = _executor(cell, two_phase=two_phase)
    log = []
    for name in ("_mc_full", "_mc1", "_llr_dec"):
        if hasattr(ex, name):
            setattr(ex, name, _Rows(getattr(ex, name), log))
    ex.run_point(1.5, 3 * B - 5)  # a partial last batch launches all rows
    root, _ = timing.units(rec.spans, "run_point")[-1]
    assert root.attrs["batches"] == 3
    split = root.attrs.get("split_batches", 0)
    assert len(log) == (3 + split if launches is None else launches)
    if cell == LAYERED:
        assert "x_row_bytes" not in root.attrs and not any(log)
        return
    assert all(b == 4 * 1152 * B for b in log)
    assert root.attrs["x_row_bytes"] == sum(log) \
        == 4 * 1152 * B * (3 + split)


def test_the_profiled_sweep_writes_the_schedule_and_x_rows(rec, tmp_path):
    """``--profile``: ``spans.json`` holds the build's and each point's
    call's ``schedule``, and the sweep root's ``x_row_bytes``."""
    out = tmp_path / "trace"
    opts = _options(blocks=2 * B, two_phase="off", initial_snr=1.0,
                    end_snr=2.0, step_snr=1.0, profile=str(out))
    run_simulation(opts, device="cpu")
    d = json.loads((out / "spans.json").read_text())
    root, = [s for s in d["spans"] if s["name"] == "run_simulation"]
    unit = [s for s in d["spans"] if s["unit"] == root["id"]]
    calls = [s for s in unit if s["name"] == "run_point"]
    build, = [s for s in unit if s["name"] == "executor.build"]
    assert len(calls) == 2 and build["attrs"]["schedule"] == "flooding"
    assert all(s["attrs"]["schedule"] == "flooding" for s in calls)
    assert root["attrs"]["x_row_bytes"] == 4 * 1152 * B * 2 * 2


def test_decode_roofline_prices_the_cells_calls_as_flooding():
    """The reader takes the flooding census of the cell's schedule, and its
    bound is by operations: one flooding sweep of a codeword (77,582 census
    operations) outlasts a read of its X row (4 n bytes) at the peaks."""
    c = small()
    program = Program(c.config, c.traffic, "cpu")
    program.start()
    units = [[program.call(unit_key(24, i))] for i in range(2)]
    t_dec = 2.5e-3
    stretch = trace.Stretch(1.0, 0.9, [
        ("void mc_decoder_kernel<8, true, false, false>", t_dec),
        ("gemm", 1.0)], {}, [], units=units)
    notes = []
    ctx = harness.Context(c, stretch, program.code.qc, H100, True, notes)
    got = cells.reader("decode_roofline.device_bound")(ctx)
    tot = ctx.totals()
    qc = program.code.qc
    sweeps = census.total_sweeps(tot["frames"], tot["converged"],
                                 tot["conv_sum"], 16)
    per_sweep = census.decode_census(qc, "spa", "flooding").total()
    assert per_sweep == 77582
    assert per_sweep != census.decode_census(qc, "spa", "layered").total()
    ops = per_sweep * sweeps + census.channel_census(qc).total() * tot[
        "frames"]
    bound, by = census.least_time(ops, tot["frames"] * (4 * 1152 + 17), H100)
    assert by == "operations" and got == pytest.approx(100 * bound / t_dec)
    assert len(notes) == 1 and "by operations" in notes[0]
    peak = census.peaks(H100)
    assert per_sweep / peak["ops_per_s"] > 4 * 1152 / peak["bytes_per_s"]
