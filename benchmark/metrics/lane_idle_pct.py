"""Share of the decode kernels' lane trips spent on a codeword that has
already stopped (kernels), in percent: 100 x (lane trips - own sweeps) /
lane trips over the traced streaming calls.

A lane trip is one sweep of one codeword's lane in its block: where a block
holds several codewords (two a warp at the CCSDS (128, 64) code), every lane
runs until the last of them stops, and the program sums each codeword's
block trips into the ``lane_trips`` counter of its ``run_point`` root. Under
the split a codeword that phase 1 left unconverged also counts phase 1's
trips, which phase 2 runs again from its channel LLRs. Own sweeps are what
the codeword's data needs, ``census.total_sweeps`` of the same calls'
counters: its converging check window (conv + 1), or the whole budget. The
unit of both is the sweep: the kernels count a block's trips in sweeps,
check_every at a time, and ``conv`` is the sweep that ends the converging
check window.

The traced calls are the first ``run_point`` units with per-batch spans,
as many as the stretch's units. It notes the ``auto.probe`` span's choice
and trip model. None where the program has no spans or the calls carry no
``lane_trips`` counter (one codeword a block, or a program without it)."""

from benchmark import census


def read(ctx):
    try:
        from ldpc_tpu_torch.utils import timing
        rec = timing.RECORDER
    except (ImportError, AttributeError):
        return None
    units = len(ctx.stretch.units)
    traced = [r for r, m in timing.units(rec.spans, "run_point")
              if any(timing.is_batch(s) for s in m)][:units]
    if not units or len(traced) < units \
            or any("lane_trips" not in r.attrs for r in traced):
        return None
    tot = ctx.totals()
    if sum(r.attrs.get("frames", 0) for r in traced) != tot["frames"]:
        return None
    trips = sum(r.attrs["lane_trips"] for r in traced)
    own = census.total_sweeps(tot["frames"], tot["converged"],
                              tot["conv_sum"],
                              ctx.config["options"]["iterations"])
    probes = [s for s in rec.spans if s.name == "auto.probe"]
    if probes:
        ctx.note("lane_idle_pct: auto.probe " + " ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in probes[-1].attrs.items()))
    split = sum(r.attrs.get("split_batches", 0) for r in traced)
    ctx.note(f"lane_idle_pct: {units} traced calls, {tot['frames']} frames, "
             f"{split} split batches; lane trips {trips}, own sweeps {own}")
    if trips <= 0:
        return None
    return 100.0 * (trips - own) / trips
