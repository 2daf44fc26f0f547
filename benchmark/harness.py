"""One run of one cell: set-up, the measured window, the traced stretch, the
check against the reference, and the result.

The traffic generator: a ``stream`` mix is back-to-back calls of
``frames_per_call`` frames at one Eb/N0 point (one client, closed loop); a
``sweep`` mix is back-to-back sweeps over an Eb/N0 grid under an error
target. Unit ``i`` of a run (a call or a sweep) draws everything from
``unit_key(seed, i)``; the warm-up unit has an index the window never uses.
Every seed gives the same sizes, points and stopping rule; only the random
bits and noise differ.
"""

from __future__ import annotations

import gc
import statistics
import sys
import time
import traceback
from dataclasses import dataclass, field

from benchmark import cells, check
from benchmark.reference.rng import M64, mix

WARM_INDEX = 1 << 40


def unit_key(seed: int, index: int) -> int:
    return mix(mix(int(seed) & M64) ^ index) >> 1


@dataclass
class Window:
    t0: float
    t1: float = 0.0
    keys: list = field(default_factory=list)
    outputs: list = field(default_factory=list)  # per unit, None if it raised
    seconds: list = field(default_factory=list)
    failed: int = 0
    stretch: object = None


class Context:
    """What a per-layer reader is given."""

    def __init__(self, cell, stretch, code, device_name, fused, notes):
        self.cell, self.stretch, self.code = cell, stretch, code
        self.config = cell.config
        self.device_name, self.fused, self._notes = device_name, fused, notes

    def totals(self) -> dict:
        pts = [p for u in self.stretch.units for p in u]
        return {c: sum(p[c] for p in pts) for c in check.COUNTERS}

    def batches(self) -> int:
        return -(-self.totals()["frames"] // self.config["options"]["batch"])

    def note(self, text: str) -> None:
        self._notes.append(text)


def _now() -> float:
    return time.perf_counter()


def run_window(program, traffic: dict, seed: int, seconds: float,
               trace: bool) -> Window:
    """Units back to back until ``seconds`` have passed. With ``trace``, the
    units after a third of the window are traced: ``traced_units`` with the
    card's activity alone, then as many with the host's operations too; the
    traces are read after the window."""
    from benchmark import trace as tr

    unit = program.call if traffic["kind"] == "stream" else program.sweep
    n = traffic.get("traced_units", 2) if trace else 0
    plan = []  # (first unit index, tracer)
    w = Window(t0=_now())
    i = 0
    while _now() - w.t0 < seconds or (plan and plan[-1][1] is not None):
        if n and not plan and _now() - w.t0 >= seconds / 3:
            plan.append((i, tr.Tracer(host=False)))
            plan[-1][1].start()
        key = unit_key(seed, i)
        t = _now()
        try:
            out = unit(key)
            out = [out] if isinstance(out, dict) else out
        except Exception:  # a failed unit counts against the run
            if not w.failed:
                traceback.print_exc()
            w.failed += 1
            out = None
        w.keys.append(key)
        w.outputs.append(out)
        w.seconds.append(_now() - t)
        i += 1
        if plan and plan[-1][1] is not None and i - plan[-1][0] == n:
            plan[-1][1].stop()
            if len(plan) == 1:
                plan.append((i, tr.Tracer(host=True)))
                plan[-1][1].start()
            else:
                plan.append((i, None))
    w.t1 = _now()
    if plan:
        (a, dev), (_, host) = plan[0], plan[1]
        w.stretch = tr.device_stretch(dev.events(), dev.window_s)
        w.stretch.units = [o for o in w.outputs[a:a + n] if o]
        w.stretch.idle_gaps = tr.idle_gaps(host.events())
    return w


def end_to_end(traffic: dict, w: Window, k: int) -> dict:
    done = [o for o in w.outputs if o is not None]
    span = w.t1 - w.t0
    if traffic["kind"] == "stream":
        bits = sum(o[0]["frames"] for o in done) * k
        return {"info_bits_per_s": bits / span}
    times = [s for s, o in zip(w.seconds, w.outputs) if o is not None]
    return {"sweep_s": span / max(len(done), 1),
            "sweep_p95_s": statistics.quantiles(times, n=20)[18]
            if len(times) > 1 else (times[0] if times else 0.0)}


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool,
             device=None, t_start: float | None = None) -> dict:
    """Runs the cell once and returns the result object (without the
    import guard, which the caller applies). ``device=None`` is the card."""
    import torch

    from benchmark.program import Program, use_build_dir
    from benchmark.reference.sim import Reference

    t_start = _now() if t_start is None else t_start
    card = device is None
    if card:
        use_build_dir()
        torch.cuda.reset_peak_memory_stats()
    traffic = cell.traffic
    program = Program(cell.config, traffic, device)
    program.start()
    warm = (program.call if traffic["kind"] == "stream" else program.sweep)
    warm(unit_key(seed, WARM_INDEX))
    if card:
        torch.cuda.synchronize()
    setup_s = _now() - t_start
    # what set-up left behind is never collected again: a sweep cell's
    # window builds 200 executors, and a full collection that walks every
    # module the process imported would land in a random sweep
    gc.collect()
    gc.freeze()
    w = run_window(program, traffic, seed, seconds, trace)
    k = program.code.k
    peak = torch.cuda.max_memory_allocated() if card else 0
    program.close()
    del program
    gc.collect()
    if card:
        torch.cuda.empty_cache()

    # the check: a sample of the window's units, worked out again
    t_ref = _now()
    ref = Reference(cell.config, "cuda" if card else device)
    ok_units = [i for i, o in enumerate(w.outputs) if o is not None]
    picked = [ok_units[j] for j in check.sample(len(ok_units),
                                                cell.check["units"], seed)]
    refs = check.reference_units(ref, traffic, [w.keys[i] for i in picked])
    found = check.gaps([w.outputs[i] for i in picked], refs)
    limits = cell.check["limits"]
    ref_s = _now() - t_ref
    correct = bool(picked) and w.failed == 0 and all(
        found[name][0] <= limit for name, limit in limits.items())

    metrics, notes = {}, []
    if not trace:
        values = end_to_end(traffic, w, k)
        values["setup_s"] = setup_s
        for m in cell.end_to_end:  # a split <base>.<cells> reads <base>
            base = m["name"].split(".", 1)[0]
            if base in values:
                metrics[m["name"]] = {"value": values[base],
                                      "unit": m["unit"]}
    dev_name = torch.cuda.get_device_name(0) if card else str(device)
    result = {"correct": correct, "attempted": len(w.outputs),
              "failed": w.failed, "metrics": metrics,
              "device": {"platform": "gpu" if card else "cpu",
                         "kind": dev_name, "count": cell.chips if card else 0,
                         "memory_peak_bytes": int(peak)}}
    if trace and w.stretch is not None:
        st = w.stretch
        ctx = Context(cell, st, ref.code, dev_name, ref.fused, notes)
        for m in cell.per_layer:
            v = cells.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["device"].update(busy_s=st.busy_s, window_s=st.window_s)
        result["breakdown"] = {"device_ops": st.device_ops,
                               "idle_gaps": st.idle_gaps}
    for line in notes:
        print(f"# {line}", file=sys.stderr)
    t = sorted(w.seconds) or [0.0]
    print(f"# window {w.t1 - w.t0:.3f} s, {len(w.outputs)} units, "
          f"{w.failed} failed; unit s min {t[0]:.4f} median "
          f"{statistics.median(t):.4f} p95 {t[int(0.95 * (len(t) - 1))]:.4f} "
          f"max {t[-1]:.4f}; "
          f"set-up {setup_s:.3f} s; reference {ref_s:.3f} s over units "
          f"{picked} (worst: {', '.join(v[1] for v in found.values())})",
          file=sys.stderr)
    result["compared"] = {name: {"value": found[name][0], "limit": limit}
                          for name, limit in limits.items()}
    return result
