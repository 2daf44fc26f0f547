"""The port's spans and counters (``ldpc_tpu_torch/utils/timing.py``) on the
CPU: nesting, units and self time, the ring's bound, the per-batch tier's
gate, the spans as host events of a ``torch.profiler`` trace, counters that
change no output, and ``spans.json`` under ``--profile``."""

from __future__ import annotations

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ldpc_tpu_torch.sim.config import SimOptions
from ldpc_tpu_torch.sim.runner import (
    PointExecutor,
    derive_key,
    load_code,
    run_simulation,
)
from ldpc_tpu_torch.utils import timing

torch.set_num_threads(1)

CCSDS = "builtin:CCSDS_ldpc_n32_k16.alist.txt"
B = 32


@pytest.fixture
def rec(monkeypatch):
    """A fresh recorder in the program's place."""
    r = timing.Recorder()
    monkeypatch.setattr(timing, "RECORDER", r)
    return r


def _executor(**kw):
    opts = dict(matrix=CCSDS, iterations=6, fidelity="exact", batch=B, seed=5,
                schedule="layered", two_phase="off")
    opts.update(kw)
    return PointExecutor(load_code(CCSDS), SimOptions(**opts), device="cpu")


def _unit(rec, root):
    """The spans of the last unit whose root is named ``root``."""
    return timing.units(rec.spans, root)[-1]


def test_nesting_units_and_counters(rec):
    with timing.span("a", x=1) as a:
        with timing.span("b") as b:
            with timing.span("c") as c:
                timing.count("fetches")
            timing.count("fetches", 2)
        with timing.span("d") as d:
            pass
    with timing.span("e") as e:
        timing.count("batches")
    assert [s.name for s in rec.spans] == ["c", "b", "d", "a", "e"]
    assert a.parent is None and a.unit == a.id
    assert (b.parent, c.parent, d.parent) == (a.id, b.id, a.id)
    assert {s.unit for s in (a, b, c, d)} == {a.id} and e.unit == e.id != a.id
    assert a.attrs == {"x": 1, "fetches": 3} and e.attrs == {"batches": 1}
    assert b.t0 <= c.t0 <= c.t1 <= b.t1 <= d.t0 <= d.t1 <= a.t1
    assert [r.name for r, _ in timing.units(rec.spans, "a")] == ["a"]
    assert len(timing.units(rec.spans, "a")[0][1]) == 4
    timing.count("dropped")  # no span open: counted nowhere
    assert "dropped" not in a.attrs and "dropped" not in e.attrs


def test_self_time_subtracts_the_union_of_children():
    r = timing.Recorder()

    def made(name, i, parent, t0, t1):
        s = timing.Span(r, name, {})
        s.id, s.parent, s.unit, s.t0, s.t1 = i, parent, 1, t0, t1
        return s

    root = made("executor.build", 1, None, 0, 100)
    spans = [root, made("auto.measure", 2, 1, 10, 40),
             made("library.load", 3, 1, 30, 50),  # overlaps the first
             made("inner", 4, 2, 15, 20),  # a grandchild: not subtracted
             made("other", 5, None, 60, 90)]  # not a child
    assert timing.self_ns(root, spans) == 100 - 40
    assert timing.self_ns(spans[1], spans) == 30 - 5
    assert timing.self_ns(spans[4], spans) == 30


def test_the_ring_keeps_the_newest_spans():
    r = timing.Recorder(capacity=4)
    for i in range(10):
        with r.span(f"s{i}"):
            pass
    assert [s.name for s in r.spans] == ["s6", "s7", "s8", "s9"]
    assert r.full() and not timing.Recorder().full()
    assert timing.RING == 1 << 17 and timing.Recorder().spans.maxlen == 1 << 17


def test_per_batch_tier_is_off_without_a_profiler(rec):
    assert timing.batch_span("batch.draw") is timing._NULL
    ex = _executor()
    ex.run_point(3.0, 2 * B)
    root, unit = _unit(rec, "run_point")
    assert not any(timing.is_batch(s) for s in rec.spans)
    assert sorted(s.name for s in unit) == ["flush", "run_point"]
    # n=32 decodes 8 codewords a block: the call counts their block trips,
    # and the refills of K1, which refills no batch of one wave
    key = derive_key(5, 0)
    trips = sum(int(ex.step(derive_key(key, i), ex.consts(3.0))[1].sum())
                for i in range(2))
    assert ex.lanes == 8 and ex._mc_full.refill
    assert root.attrs == {"snr": 3.0, "schedule": "layered", "fetches": 1,
                          "batches": 2,
                          "frames": 2 * B, "lane_trips": trips,
                          "refills": 0}
    with timing.batch_spans():
        assert timing.batch_span("batch.draw") is not timing._NULL
        ex.run_point(3.0, 2 * B)
    _, unit = _unit(rec, "run_point")
    names = [s.name for s in unit if timing.is_batch(s)]
    assert sorted(names) == sorted(["batch.draw", "batch.encode",
                                    "batch.decode", "batch.counters"] * 2)
    assert not rec.batch_tier


def test_spans_are_host_events_of_the_profiler_trace(rec):
    ex = _executor(interleaver="random")
    ex.run_point(3.0, B)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ex.run_point(3.0, 2 * B)
    kineto = prof.profiler.kineto_results.events()
    events = [(e.name(), e.start_ns(), e.end_ns()) for e in kineto]
    names = [n for n, _, _ in events]
    # host operators, not user annotations: the profiler would give those a
    # range on the card over the kernels launched inside them
    spans = [e for e in kineto if e.name() in ("run_point", "batch.decode")]
    assert spans and not any(e.is_user_annotation() for e in spans)
    for name in ("batch.draw", "batch.encode", "batch.channel",
                 "batch.decode"):
        assert names.count(name) == 2, name
    # the unfused batch has a counters span in its step and one around the
    # packed counters
    assert names.count("batch.counters") == 4
    assert names.count("run_point") == 1 and names.count("flush") == 1
    (p0, p1), = [(t0, t1) for n, t0, t1 in events if n == "run_point"]
    aten = [(n, t0, t1) for n, t0, t1 in events if n.startswith("aten::")]
    for name in ("batch.encode", "batch.channel", "batch.decode"):
        for s0, s1 in [(t0, t1) for n, t0, t1 in events if n == name]:
            assert p0 <= s0 <= s1 <= p1
            assert any(s0 <= t0 and t1 <= s1 for _, t0, t1 in aten), name
    # the ring has the same spans, in a unit the readers count as traced
    _, unit = _unit(rec, "run_point")
    assert sum(timing.is_batch(s) for s in unit) == 12


def _stats(ex, snr, blocks):
    s = ex.run_point(snr, blocks)
    return (s.blocks, s.ok_blocks, s.error_bits, s.fer_frames,
            s.norm_llr_sum, s.conv_iters_sum, s.conv_count)


@pytest.mark.parametrize("kw,snr,blocks", [
    (dict(), 3.0, 3 * B),  # fused, one pass
    (dict(two_phase="2"), 3.0, 3 * B),  # fused, a forced split
    (dict(interleaver="random", modulation=16), 6.0, 3 * B),  # unfused
    (dict(target_errors=5, fused="on"), -2.0, 20 * B),  # grouped stop
    (dict(target_errors=5, interleaver="random"), -2.0, 20 * B),
])
def test_spans_change_no_counter(rec, kw, snr, blocks):
    off = _stats(_executor(**kw), snr, blocks)
    with timing.batch_spans():
        on = _stats(_executor(**kw), snr, blocks)
    assert on == off
    root, unit = _unit(rec, "run_point")
    assert root.attrs["frames"] == on[0]
    assert root.attrs["batches"] == -(-on[0] // B)
    assert sum(s.name == "batch.decode" for s in unit) == \
        root.attrs["batches"]
    assert root.attrs["fetches"] == sum(s.name == "flush" for s in unit)
    if "target_errors" in kw:
        assert on[0] < blocks  # the quota stopped the point


def test_auto_probe_and_code_load_spans(rec):
    ex = _executor(two_phase="auto", iterations=8)
    ex.run_point(3.0, 2 * B)
    root, unit = _unit(rec, "run_point")
    probe, = [s for s in unit if s.name == "auto.probe"]
    assert probe.parent == root.id
    assert root.attrs["probes"] == 1 and root.attrs["batches"] == 2
    assert root.attrs["fetches"] == 2 + 1  # the probe's two, one flush
    build, = [s for s, _ in timing.units(rec.spans, "executor.build")]
    assert build.t1 <= root.t0
    load_code.__wrapped__(CCSDS)  # the body the cache runs on a miss
    assert rec.spans[-1].name == "code.load" and rec.spans[-1].parent is None


def test_profiled_sweep_writes_spans(rec, tmp_path):
    out = tmp_path / "trace"
    opts = SimOptions(matrix=CCSDS, blocks=2 * B, batch=B, iterations=6,
                      fidelity="exact", two_phase="off", initial_snr=0.0,
                      end_snr=2.0, step_snr=1.0, quiet=True, profile=str(out))
    res = run_simulation(opts, device="cpu")
    d = json.loads((out / "spans.json").read_text())
    assert d["ring"] == timing.RING and "mc_decoder_launch" in d["launches"]
    assert "qam_channel_launch" in d["launches"]
    assert {"batch_counters_launch", "add_counters_launch"} <= set(d["launches"])
    root, = [s for s in d["spans"] if s["name"] == "run_simulation"]
    unit = [s for s in d["spans"] if s["unit"] == root["id"]]
    points = [s for s in unit if s["name"] == "point"]
    assert [p["attrs"]["snr"] for p in points] == [0.0, 1.0, 2.0]
    assert len(res.snr_points) == 3
    flushes = sum(s["name"] == "flush" for s in unit)
    assert flushes == root["attrs"]["fetches"] == 3
    assert root["attrs"]["frames"] == 3 * 2 * B
    # the profiler was on: every batch's spans are there
    assert sum(s["name"] == "batch.decode" for s in unit) == 6
    assert sum(s["name"] == "executor.build" for s in unit) == 1
    assert all(s["start_ns"] <= s["end_ns"] for s in d["spans"])
