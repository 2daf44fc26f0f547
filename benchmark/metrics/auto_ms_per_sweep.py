"""Milliseconds of ``auto``'s measure and probes a sweep (sweep), from the
program's spans: each window sweep's ``auto.measure`` and ``auto.probe``
spans. The warm-up sweep and the sweeps a profiler traced (those with
per-batch spans) are left out. 0.0 where the sweeps ran no such span, None
where no sweep was recorded (or the program has no spans)."""


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
    ms = {name: [(s.t1 - s.t0) * 1e-6 for _, m in sweeps for s in m
                 if s.name == name]
          for name in ("auto.measure", "auto.probe")}
    ctx.note(f"auto_ms_per_sweep: {len(sweeps)} untraced sweeps; "
             + ", ".join(f"{len(v)} {name} spans, {sum(v):.6g} ms"
                         for name, v in ms.items()))
    return sum(map(sum, ms.values())) / len(sweeps)
