"""The readers of the program's spans (``host_ms_per_batch``,
``executor_ms_per_sweep``, ``auto_ms_per_sweep``, ``setup_program_s``) on
synthetic recorder buffers: the warm-up unit and the traced units (those
with per-batch spans) are left out, ``auto_ms_per_sweep`` reads 0.0 or None
where it should, set-up counts each outermost span once, and a program
without the recorder gives no number."""

import pytest

from benchmark import cells
from ldpc_tpu_torch.utils import timing

MS = 1_000_000  # ns


class Ctx:
    def __init__(self):
        self.notes = []

    def note(self, text):
        self.notes.append(text)


class Buffer:
    """Spans made by hand, times in ms, into a fresh recorder."""

    def __init__(self, capacity=timing.RING):
        self.rec = timing.Recorder(capacity)
        self.ids = 0

    def add(self, name, t0, t1, parent=None, **attrs):
        self.ids += 1
        s = timing.Span(self.rec, name, attrs)
        s.id, s.t0, s.t1 = self.ids, int(t0 * MS), int(t1 * MS)
        s.parent = None if parent is None else parent.id
        s.unit = s.id if parent is None else parent.unit
        self.rec.spans.append(s)
        return s


@pytest.fixture
def buf(monkeypatch):
    b = Buffer()
    monkeypatch.setattr(timing, "RECORDER", b.rec)
    return b


def _read(name):
    ctx = Ctx()
    return cells.reader(name)(ctx), ctx.notes


def _call(b, t0, batches, flush_ms, traced=False, probe_ms=0.0):
    """A ``run_point`` root of 10 ms a batch of host time, then its flush."""
    host = 10.0 * batches
    r = b.add("run_point", t0, t0 + host + probe_ms + flush_ms,
              batches=batches, frames=batches * 4096)
    if probe_ms:
        b.add("auto.probe", t0, t0 + probe_ms, r)
    if traced:
        b.add("batch.decode", t0 + probe_ms, t0 + probe_ms + 5, r)
    b.add("flush", t0 + probe_ms + host, t0 + probe_ms + host + flush_ms, r)
    return r


def test_host_ms_per_batch_skips_warm_up_and_traced_calls(buf):
    _call(buf, 0, 3, 50.0, probe_ms=7.0)  # the warm-up: 3 batches
    _call(buf, 100, 64, 20.0)
    _call(buf, 1000, 64, 30.0, traced=True)
    _call(buf, 2000, 32, 5.0, probe_ms=2.0)
    v, notes = _read("host_ms_per_batch")
    assert v == pytest.approx(10.0)
    assert "2 untraced calls, 96 batches" in notes[0]


def _sweep(b, t0, traced=False, measure=True, probes=2, build_ms=30.0):
    """A ``run_simulation`` root: an executor build (with ``auto.measure``
    and, on the first, a library load) and one point a probe."""
    r = b.add("run_simulation", t0, t0 + 200, fetches=3 + 2 * probes)
    e = b.add("executor.build", t0 + 1, t0 + 1 + build_ms, r)
    if measure:
        b.add("auto.measure", t0 + 5, t0 + 9, e)
    for i in range(probes):
        p = b.add("point", t0 + 40 + 50 * i, t0 + 80 + 50 * i, r, snr=1.0)
        rp = b.add("run_point", t0 + 41 + 50 * i, t0 + 79 + 50 * i, p)
        b.add("auto.probe", t0 + 42 + 50 * i, t0 + 45 + 50 * i, rp)
        if traced:
            b.add("batch.draw", t0 + 46 + 50 * i, t0 + 47 + 50 * i, rp)
    return r


def test_executor_and_auto_per_sweep(buf):
    _sweep(buf, 0, build_ms=500.0, probes=5)  # the warm-up
    _sweep(buf, 1000)
    _sweep(buf, 2000, traced=True, build_ms=90.0)
    _sweep(buf, 3000, build_ms=20.0, probes=1)
    v, notes = _read("executor_ms_per_sweep")
    # self time: (30 - 4) and (20 - 4) ms
    assert v == pytest.approx((26.0 + 16.0) / 2)
    assert "host fetches a sweep 6 " in notes[0]
    v, notes = _read("auto_ms_per_sweep")
    assert v == pytest.approx((4 + 2 * 3 + 4 + 3) / 2)
    assert "2 auto.measure spans, 8 ms, 3 auto.probe spans, 9 ms" in notes[0]


def test_auto_reads_zero_without_auto_spans_and_none_without_sweeps(buf):
    _sweep(buf, 0)
    assert _read("auto_ms_per_sweep")[0] is None
    assert _read("executor_ms_per_sweep")[0] is None
    _sweep(buf, 1000, measure=False, probes=0)
    assert _read("auto_ms_per_sweep")[0] == 0.0


def test_setup_counts_each_outermost_span_before_the_window(buf):
    buf.add("library.load", 0, 3000, built=True)  # outside any span
    buf.add("code.load", 3000, 3100)
    e = buf.add("executor.build", 3200, 3400)
    m = buf.add("auto.measure", 3210, 3390, e)
    buf.add("library.load", 3220, 3380, m, built=False)  # inside the build
    r = buf.add("run_point", 3500, 4000)  # the warm-up call
    buf.add("library.load", 3600, 3700, r, built=False)  # its first launch
    buf.add("executor.build", 4100, 4150)  # after the window started
    buf.add("run_point", 4050, 4200)
    v, notes = _read("setup_program_s")
    assert v == pytest.approx(3.0 + 0.1 + 0.2 + 0.1)
    assert [n.split(": ")[1].split(" ")[0] for n in notes] == [
        "library.load", "code.load", "executor.build", "library.load"]
    assert "built=True" in notes[0]


def test_setup_needs_a_window_and_the_whole_ring(monkeypatch):
    b = Buffer(capacity=3)
    monkeypatch.setattr(timing, "RECORDER", b.rec)
    b.add("code.load", 0, 10)
    b.add("run_point", 20, 30)
    assert _read("setup_program_s")[0] is None  # only the warm-up
    b.add("run_point", 40, 50)
    assert b.rec.full() and _read("setup_program_s")[0] is None


@pytest.mark.parametrize("name", ["host_ms_per_batch", "executor_ms_per_sweep",
                                  "auto_ms_per_sweep", "setup_program_s"])
def test_a_program_without_spans_gives_no_number(monkeypatch, name):
    monkeypatch.delattr(timing, "RECORDER")
    assert _read(name) == (None, [])
