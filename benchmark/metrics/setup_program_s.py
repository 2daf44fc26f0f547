"""Seconds of set-up in the program's own work (set-up), from its spans:
the ``code.load``, ``executor.build`` and ``library.load`` spans that end
before the window's first unit (the second ``run_point`` or
``run_simulation`` root; the first is the warm-up) starts, each counted once
at its outermost. The rest of ``setup_s`` is the interpreter, the torch
import, the CUDA context and the harness. None for a program without spans,
or where the ring has dropped its oldest spans."""

SETUP = ("code.load", "executor.build", "library.load")


def read(ctx):
    try:
        from ldpc_tpu_torch.utils import timing
        rec = timing.RECORDER
    except (ImportError, AttributeError):
        return None
    spans = list(rec.spans)
    roots = sorted(s.t0 for s in spans if s.parent is None
                   and s.name in ("run_point", "run_simulation"))
    if len(roots) < 2 or rec.full():
        return None
    by_id = {s.id: s for s in spans}

    def outermost(s):
        p = by_id.get(s.parent)
        while p is not None:
            if p.name in SETUP:
                return False
            p = by_id.get(p.parent)
        return True

    picked = [s for s in spans
              if s.name in SETUP and s.t1 <= roots[1] and outermost(s)]
    for s in sorted(picked, key=lambda s: s.t0):
        extra = "".join(f" {k}={v}" for k, v in s.attrs.items())
        ctx.note(f"setup_program_s: {s.name}{extra} {s.seconds:.4f} s")
    return sum(s.seconds for s in picked)
