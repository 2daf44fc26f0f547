"""Milliseconds of an executor build a sweep (sweep), from the program's
spans: the self time of each window sweep's ``executor.build`` span, so
without ``auto.measure``. The warm-up sweep and the sweeps a profiler traced
(those with per-batch spans) are left out. It notes the median sweep and
the program's host fetches a sweep, beside ``dtoh_copies_per_sweep``. None
for a program without spans."""

import statistics


def read(ctx):
    try:
        from ldpc_tpu_torch.utils import timing
        rec = timing.RECORDER
    except (ImportError, AttributeError):
        return None
    sweeps = [(r, m) for r, m in timing.units(rec.spans, "run_simulation")[1:]
              if not any(timing.is_batch(s) for s in m)]
    if not sweeps:
        return None
    own = sum(timing.self_ns(s, m) for _, m in sweeps for s in m
              if s.name == "executor.build")
    fetches = sum(r.attrs.get("fetches", 0) for r, _ in sweeps)
    ctx.note(f"executor_ms_per_sweep: {len(sweeps)} untraced sweeps; "
             f"run_simulation median "
             f"{statistics.median(r.seconds for r, _ in sweeps):.4f} s; "
             f"host fetches a sweep {fetches / len(sweeps):.4g} (flushes "
             f"and probes' reads)")
    return own * 1e-6 / len(sweeps)
