"""Host milliseconds a batch of the streaming calls (run loop), from the
program's spans: each window call's ``run_point`` span less its ``flush``
and ``auto.probe`` spans, over the batches it ran. That is the time the host
takes to enqueue a batch. The warm-up call and the calls a profiler traced
(those with per-batch spans) are left out, so the host reads as the untraced
runs have it. None for a program without spans."""

import statistics


def read(ctx):
    try:
        from ldpc_tpu_torch.utils import timing
        rec = timing.RECORDER
    except (ImportError, AttributeError):
        return None
    calls = [(r, m) for r, m in timing.units(rec.spans, "run_point")[1:]
             if not any(timing.is_batch(s) for s in m)]
    batches = sum(r.attrs.get("batches", 0) for r, _ in calls)
    if not batches:
        return None
    waits = sum(s.t1 - s.t0 for r, m in calls for s in m
                if s.parent == r.id and s.name in ("flush", "auto.probe"))
    host_ns = sum(r.t1 - r.t0 for r, _ in calls) - waits
    ctx.note(f"host_ms_per_batch: {len(calls)} untraced calls, {batches} "
             f"batches; run_point median "
             f"{statistics.median(r.seconds for r, _ in calls):.4f} s, "
             f"flush and probe {waits * 1e-9:.4f} s in all")
    return host_ns * 1e-6 / batches
